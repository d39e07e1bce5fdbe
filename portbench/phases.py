"""The program's phase file (``ANDIX_PROF_FILE``), read for the metrics.

The program appends one line a phase, ``[<device>] <label>: <seconds>s``,
each timed to a synchronize.  A matrix run with the file set gives its
phases; the run record keeps them with that matrix's wall.
"""

from __future__ import annotations

import re

_LINE = re.compile(r"^\[(?P<dev>[^\]]+)\] (?P<label>.*): (?P<s>[0-9.]+)s$")


def parse(text: str) -> list[tuple[str, float]]:
    out = []
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if m:
            out.append((m["label"], float(m["s"])))
    return out


def mean_seconds(record: dict, match) -> float | None:
    """The mean over the phase-file matrices of the seconds of the phases
    whose label ``match`` accepts; None when no matrix has one."""
    mats = record.get("phase_matrices") or []
    if not any(match(label) for m in mats for label, _ in m["phases"]):
        return None
    return sum(s for m in mats for label, s in m["phases"]
               if match(label)) / len(mats)


def first_number(record: dict, prefix: str) -> int | None:
    """The integer that follows ``prefix`` in the first phase label that
    holds it (e.g. ``"H2D text ("`` gives the padded symbols)."""
    for m in record.get("phase_matrices") or []:
        for label, _ in m["phases"]:
            if prefix in label:
                digits = re.match(r"\d+", label.split(prefix, 1)[1])
                if digits:
                    return int(digits.group())
    return None


def kernel_seconds(record: dict, match) -> tuple[float, int]:
    """Device seconds and launches, per profiled matrix, of the kernels
    whose name ``match`` accepts."""
    prof = record.get("profile")
    if not prof or not prof["matrices"]:
        return 0.0, 0
    sec, count = 0.0, 0
    for name, (s, c) in prof["kernels"].items():
        if match(name):
            sec += s
            count += c
    return sec / prof["matrices"], count // prof["matrices"]
