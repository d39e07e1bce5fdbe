"""The program's spans (``andix_torch.spans``), read for the per-layer
metrics of the phase-file matrices.

The traced run's second half calls the CLI with ``ANDIX_PROF_FILE`` set,
and the program keeps each such call's spans, one request a call, in
``andix_torch.spans.REQUESTS``; the window's phase-file matrices are the
last calls the run makes.  The module is looked up when a metric is read,
never imported: a program without spans gives nothing to read.  Each
request is a dict with ``spans`` (each a dict with ``id``, ``name``,
``parent``, host ``t0`` and ``t1`` in nanoseconds and ``counts``) and the
``counts`` made outside every span.
"""

from __future__ import annotations

import sys


def requests(record: dict) -> list[dict] | None:
    """The requests of the run's phase-file matrices, one a matrix; None
    where there are none or the program kept fewer."""
    n = len(record.get("phase_matrices") or [])
    mod = sys.modules.get("andix_torch.spans")
    kept = list(getattr(mod, "REQUESTS", None) or [])
    if not n or len(kept) < n:
        return None
    return kept[-n:]


def host_seconds(request: dict, names) -> float:
    """Host seconds of the request's spans named in ``names``."""
    return sum(s["t1"] - s["t0"] for s in request["spans"]
               if s["name"] in names) / 1e9


def counted(request: dict, name: str) -> int:
    """Counter ``name`` over the whole request."""
    return (sum(s["counts"].get(name, 0) for s in request["spans"])
            + request["counts"].get(name, 0))


def subtree(request: dict, root: dict) -> list[dict]:
    """``root`` and every span under it."""
    kids: dict = {}
    for s in request["spans"]:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(kids.get(s["id"], []))
    return out


def mean(reqs: list[dict] | None, per_request) -> float | None:
    """``per_request`` averaged over the requests (None without any)."""
    if not reqs:
        return None
    return sum(per_request(r) for r in reqs) / len(reqs)
