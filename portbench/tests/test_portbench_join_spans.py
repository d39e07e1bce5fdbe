"""The readers of the join path's spans (``join.read_s``,
``subjects.host_s``) on canned requests, with the values worked out by
hand and None where the span never opens; and a whole traced run of the
draft cell on the CPU, at test size, that reads both and is correct."""

import collections
import sys
import types

import pytest

from portbench_tiny import run_cell, tiny_root  # noqa: F401
from portbench.run import ROOT, load_metric

MS = 1_000_000  # nanoseconds
NAMES = ("join.read_s", "subjects.host_s")


def sp(sid, name, t0, t1, parent=None):
    return {"id": sid, "name": name, "parent": parent, "t0": t0 * MS,
            "t1": t1 * MS, "counts": {}}


def joined():
    """Two requests under ``-j``.  The first: a FASTA read of 900 ms
    holding two joined files of 300 and 400 ms, subjects of 500 ms holding
    two host subjects of 200 and 150 ms.  The second: a read holding one
    file of 600 ms, two host subjects of 100 ms each."""
    first = {"id": 1, "counts": {}, "spans": [
        sp(1, "fasta.read", 0, 900),
        sp(2, "ingest.join", 10, 310, parent=1),
        sp(3, "ingest.join", 320, 720, parent=1),
        sp(4, "subjects", 900, 1400),
        sp(5, "subjects.host", 900, 1100, parent=4),
        sp(6, "subjects.host", 1100, 1250, parent=4),
    ]}
    second = {"id": 2, "counts": {}, "spans": [
        sp(11, "fasta.read", 0, 700),
        sp(12, "ingest.join", 50, 650, parent=11),
        sp(13, "subjects", 700, 1000),
        sp(14, "subjects.host", 700, 800, parent=13),
        sp(15, "subjects.host", 800, 900, parent=13),
    ]}
    return [first, second]


def one_record():
    """A request of files read on the card: neither span opens."""
    return {"id": 3, "counts": {}, "spans": [
        sp(21, "fasta.read", 0, 20), sp(22, "subjects", 20, 21)]}


WANT = {"join.read_s": ((0.3 + 0.4) + 0.6) / 2,
        "subjects.host_s": ((0.2 + 0.15) + (0.1 + 0.1)) / 2}


def program(monkeypatch, requests):
    monkeypatch.setitem(sys.modules, "andix_torch.spans",
                        types.SimpleNamespace(
                            REQUESTS=collections.deque(requests, maxlen=64)))


def record(n):
    return {"phase_matrices": [{"wall_s": 2.0, "phases": []}] * n}


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_canned_requests(name, monkeypatch):
    read = load_metric(ROOT, name)
    program(monkeypatch, joined())
    assert read(record(2)) == pytest.approx(WANT[name], rel=1e-12)
    # only the last requests are the phase-file matrices'
    program(monkeypatch, [one_record()] * 3 + joined()[1:])
    assert read(record(1)) == pytest.approx(
        {"join.read_s": 0.6, "subjects.host_s": 0.2}[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kept, matrices", [
    (None, 2),  # a program without spans
    ("one_record", 2),  # the span never opens
    (0, 2),
    (1, 2),  # fewer requests kept than phase-file matrices
    (2, 0),  # no phase-file matrices
])
def test_reader_reads_nothing(name, kept, matrices, monkeypatch):
    read = load_metric(ROOT, name)
    if kept is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    elif kept == "one_record":
        program(monkeypatch, [one_record()] * 2)
    else:
        program(monkeypatch, joined()[:kept])
    assert read(record(matrices)) is None


def test_a_traced_draft_run_reads_the_join_spans(tiny_root):  # noqa: F811
    """``draft8x5m.divergent`` at test size, traced, on the CPU: correct,
    every check 0, and both readers read a time; the one-record cell does
    not report them."""
    result, _ = run_cell(tiny_root, "draft8x5m.divergent", trace_on=True)
    assert result["correct"] is True and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    got = result["metrics"]
    for name in NAMES:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "s"
    result, _ = run_cell(tiny_root, "bact8x5m.divergent", trace_on=True)
    assert result["correct"] is True
    assert not set(NAMES) & set(result["metrics"])
