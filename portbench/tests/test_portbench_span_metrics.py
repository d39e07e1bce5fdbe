"""The readers of the program's spans (``portbench/span_requests.py`` and
the six metrics on it) on canned requests, with the values worked out by
hand; and a whole traced run on the CPU that reads them."""

import collections
import sys
import types

import pytest

from portbench_tiny import tiny_root  # noqa: F401  (and the root on the path)
from portbench.run import load_metric, ROOT
from test_portbench_harness import run_cell

MS = 1_000_000  # nanoseconds


def sp(sid, name, t0, t1, parent=None, **counts):
    return {"id": sid, "name": name, "parent": parent, "t0": t0 * MS,
            "t1": t1 * MS, "counts": counts}


def canned():
    """Two requests.  The first: a FASTA read of 300 ms, the subjects'
    set-up 100 ms, the joint text 40 ms inside the upload phase, a joint
    walk of 500 ms whose two dispatches waited 20 ms and uploaded 1000 B in
    5 ms each and which itself waited 10 ms, a readback of 1 ms outside
    every span.  The second: a read of 500 ms, subjects 200 ms, two subject
    texts of 30 ms, a subject walk of 800 ms with one dispatch (40 ms
    waited, 3000 B uploaded in 10 ms) and an upload of 2000 B in 5 ms in
    the index phase."""
    first = {"id": 1, "counts": {"wait_ns": 1 * MS}, "spans": [
        sp(1, "fasta.read", 0, 300),
        sp(2, "subjects", 300, 400),
        sp(3, "joint.upload", 400, 600),
        sp(4, "joint.text", 410, 450, parent=3),
        sp(5, "joint.walk", 1000, 1500, wait_ns=10 * MS),
        sp(6, "walk.dispatch", 1010, 1100, parent=5, wait_ns=20 * MS,
           upload_ns=5 * MS, h2d_bytes=1000),
        sp(7, "walk.dispatch", 1100, 1200, parent=5, wait_ns=20 * MS,
           upload_ns=5 * MS, h2d_bytes=1000),
        sp(8, "count", 1500, 1600),
    ]}
    second = {"id": 2, "counts": {}, "spans": [
        sp(11, "fasta.read", 0, 500),
        sp(12, "subjects", 500, 700),
        sp(13, "worker", 700, 2000),
        sp(14, "sx.index", 700, 1000, parent=13, upload_ns=5 * MS,
           h2d_bytes=2000),
        sp(15, "sx.text", 710, 740, parent=14),
        sp(16, "sx.text", 750, 780, parent=14),
        sp(17, "sx.walk", 1000, 1800, parent=13),
        sp(18, "walk.dispatch", 1000, 1700, parent=17, wait_ns=40 * MS,
           upload_ns=10 * MS, h2d_bytes=3000),
    ]}
    return [first, second]


def program(monkeypatch, requests):
    """The program's spans module as the readers find it."""
    monkeypatch.setitem(sys.modules, "andix_torch.spans",
                        types.SimpleNamespace(
                            REQUESTS=collections.deque(requests, maxlen=64)))


def record(n):
    return {"phase_matrices": [{"wall_s": 2.0, "phases": []}] * n}


WANT = {
    "shell.read_s": (0.3 + 0.5) / 2,
    "shell.prep_s": ((0.1 + 0.04) + (0.2 + 0.03 + 0.03)) / 2,
    # 0.5 s less 10 + 2 x 25 ms; 0.8 s less 50 ms
    "walk.driver_s": ((0.5 - 0.06) + (0.8 - 0.05)) / 2,
    "walk.dispatches": (2 + 1) / 2,
    "readback_wait_s": ((0.001 + 0.01 + 0.04) + 0.04) / 2,
    # 7000 B in 25 ms
    "upload_GBps": 7000 / (25 * MS),
}


@pytest.mark.parametrize("name", list(WANT))
def test_reader_on_canned_requests(name, monkeypatch):
    read = load_metric(ROOT, name)
    program(monkeypatch, canned())
    assert read(record(2)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", list(WANT))
def test_reader_takes_the_last_requests(name, monkeypatch):
    """Requests kept before the phase-file matrices are not theirs."""
    read = load_metric(ROOT, name)
    first, second = canned()
    program(monkeypatch, [second, first, second])
    one = read(record(1))
    program(monkeypatch, [second])
    assert one == read(record(1))


@pytest.mark.parametrize("name", list(WANT))
@pytest.mark.parametrize("kept, matrices", [
    (None, 2),  # a program without spans (the parent of the change)
    (0, 2),
    (1, 2),  # fewer requests kept than phase-file matrices
    (2, 0),  # no phase-file matrices
])
def test_reader_reads_nothing(name, kept, matrices, monkeypatch):
    read = load_metric(ROOT, name)
    if kept is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, canned()[:kept])
    assert read(record(matrices)) is None


def test_no_bytes_no_rate(monkeypatch):
    """The CPU backend copies nothing to a card: no rate."""
    read = load_metric(ROOT, "upload_GBps")
    first, second = canned()
    for req in (first, second):
        for s in req["spans"]:
            s["counts"].pop("h2d_bytes", None)
            s["counts"].pop("upload_ns", None)
    program(monkeypatch, [first, second])
    assert read(record(2)) is None


def test_a_traced_run_reads_the_spans(tiny_root):  # noqa: F811
    """A whole traced run of each cell on the CPU: the five time and count
    readers read; the rate has no bytes to read there."""
    for cell in ("bact8x5m.divergent", "bact10x5m.divergent"):
        result, _ = run_cell(tiny_root, cell, trace_on=True)
        assert result["correct"] is True
        got = result["metrics"]
        for name in ("shell.read_s", "shell.prep_s", "walk.driver_s",
                     "walk.dispatches", "readback_wait_s"):
            assert got[name]["value"] >= 0, name
        assert got["shell.read_s"]["value"] > 0
        assert got["walk.driver_s"]["value"] > 0
        assert "upload_GBps" not in got
