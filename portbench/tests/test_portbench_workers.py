"""The readers of the worker pool and the cards' balance
(``workers.occupancy``, ``workers.cpu_share``, ``cards.busy_balance``) on
canned requests and profiles, the parent's shapes among them (two of four
cards idle, no ``cpu_ns``, no profile); and the eco29 cell at test size
on four CPU workers through the harness."""

import collections
import sys
import types

import pytest
import torch

from portbench_tiny import make_tiny_root  # (the root on the path)
from portbench.run import ROOT, load_metric
from test_portbench_harness import run_cell

MS = 1_000_000  # nanoseconds
CELL = "eco29.divergent"


def worker(sid, t0, t1, cpu=None):
    counts = {} if cpu is None else {"cpu_ns": cpu * MS}
    return {"id": sid, "name": "worker", "parent": None, "t0": t0 * MS,
            "t1": t1 * MS, "counts": counts}


def other(sid, t0, t1):
    return {"id": sid, "name": "sx.walk", "parent": None, "t0": t0 * MS,
            "t1": t1 * MS, "counts": {"cpu_ns": 5 * MS}}


def four_workers(cpu=True):
    """Two requests of four workers each: walls 1000, 900, 800, 700 ms
    and 500 ms each; CPU 400, 300, 200, 100 ms and 250 ms each."""
    c = (lambda ms: ms) if cpu else (lambda ms: None)
    return [
        {"id": 1, "counts": {}, "spans": [
            worker(1, 0, 1000, c(400)), worker(2, 0, 900, c(300)),
            worker(3, 100, 900, c(200)), worker(4, 0, 700, c(100)),
            other(5, 0, 100)]},
        {"id": 2, "counts": {}, "spans": [
            worker(11, 0, 500, c(250)), worker(12, 0, 500, c(250)),
            worker(13, 0, 500, c(250)), worker(14, 0, 500, c(250))]},
    ]


def two_of_four():
    """The parent at eco29: two workers (9793 and 8991 ms) on four
    visible cards, no ``cpu_ns``."""
    return [{"id": 1, "counts": {}, "spans": [
        worker(1, 0, 9793), worker(2, 0, 8991)]}]


def program(monkeypatch, requests):
    monkeypatch.setitem(sys.modules, "andix_torch.spans",
                        types.SimpleNamespace(
                            REQUESTS=collections.deque(requests, maxlen=64)))


def record(n, cards=4, busy=None):
    rec = {"phase_matrices": [{"wall_s": 2.0, "phases": []}] * n,
           "peak_bytes_by_card": [2**30] * cards}
    if busy is not None:
        rec["profile"] = {"busy_s_by_card": busy}
    return rec


def test_occupancy_on_canned_requests(monkeypatch):
    read = load_metric(ROOT, "workers.occupancy")
    program(monkeypatch, four_workers())
    # (1000 + 900 + 800 + 700 + 4 x 500) / (4 x 1000 + 4 x 500)
    assert read(record(2)) == pytest.approx(5400 / 6000, rel=1e-12)
    program(monkeypatch, four_workers()[1:])
    assert read(record(1)) == 1.0


def test_occupancy_of_the_parents_two_workers(monkeypatch):
    """Two workers on four cards read about 0.48, as PERF.md reckoned
    from the parent's walls; on two cards the same walls read 0.96."""
    read = load_metric(ROOT, "workers.occupancy")
    program(monkeypatch, two_of_four())
    assert read(record(1)) == pytest.approx((9793 + 8991) / (4 * 9793))
    assert 0.47 < read(record(1)) < 0.49
    assert read(record(1, cards=2)) == pytest.approx(
        (9793 + 8991) / (2 * 9793))


def test_cpu_share_on_canned_requests(monkeypatch):
    read = load_metric(ROOT, "workers.cpu_share")
    program(monkeypatch, four_workers())
    # (1000 + 4 x 250) / (3400 + 2000); the walk span's cpu_ns is not a
    # worker's
    assert read(record(2)) == pytest.approx(2000 / 5400, rel=1e-12)


@pytest.mark.parametrize("name", ["workers.occupancy", "workers.cpu_share"])
@pytest.mark.parametrize("kept, matrices", [
    (None, 2),  # a program without spans
    (0, 2),
    (1, 2),  # fewer requests kept than phase-file matrices
    (2, 0),  # no phase-file matrices
])
def test_span_readers_read_nothing(name, kept, matrices, monkeypatch):
    read = load_metric(ROOT, name)
    if kept is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, four_workers()[:kept])
    assert read(record(matrices)) is None


def test_no_cpu_ns_no_share_and_no_worker_no_occupancy(monkeypatch):
    """The parent counts no ``cpu_ns``; a request without a worker span
    (the joint schedule on one card) has no walls; the CPU has no
    visible card."""
    share = load_metric(ROOT, "workers.cpu_share")
    occupancy = load_metric(ROOT, "workers.occupancy")
    program(monkeypatch, four_workers(cpu=False))
    assert share(record(2)) is None
    assert occupancy(record(2)) is not None
    program(monkeypatch, two_of_four())
    assert share(record(1)) is None
    program(monkeypatch, [{"id": 1, "counts": {}, "spans": [
        other(1, 0, 100)]}])
    assert occupancy(record(1)) is None and share(record(1)) is None
    program(monkeypatch, four_workers())
    assert occupancy(record(2, cards=0)) is None


@pytest.mark.parametrize("busy, want", [
    ({0: 2.0, 1: 1.5, 2: 1.0, 3: 0.5}, 0.25),
    ({0: 0.618, 1: 0.492, 2: 0.0, 3: 0.0}, 0.0),  # the parent: two idle
    ({0: 1.25, 1: 1.25, 2: 1.25, 3: 1.25}, 1.0),
    ({0: 0.8}, 1.0),
])
def test_busy_balance_on_canned_profiles(busy, want):
    read = load_metric(ROOT, "cards.busy_balance")
    assert read(record(1, busy=busy)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("busy", [None, {}, {0: 0.0, 1: 0.0}])
def test_busy_balance_reads_nothing(busy):
    """No profile (an untraced run), no card in it, no device work."""
    read = load_metric(ROOT, "cards.busy_balance")
    assert read(record(1, busy=busy)) is None


def test_eco29_at_test_size_on_four_workers(tmp_path, monkeypatch):
    """The eco29 cell, cut to 9 x 3 kbp, traced through the harness on the
    CPU with four workers and a joint block small enough that ``auto``
    takes the subject index: correct, one group a worker, and the CPU
    share read from the workers' spans (no card: no occupancy, no
    balance)."""
    from andix_torch import cli, pipeline, subject_pipeline

    root = make_tiny_root(str(tmp_path), {"genomes": 9, "length": 3000})
    plan = pipeline.device_plan
    monkeypatch.setattr(cli, "resolve_devices",
                        lambda backend: [torch.device("cpu")] * 4)
    monkeypatch.setattr(pipeline, "device_plan", lambda block, s, budget: (
        (8000,) + tuple(plan(block, s, budget)[1:])))
    result, _ = run_cell(root, CELL, trace_on=True)
    assert result["correct"] is True and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    groups = [ln for ln in subject_pipeline.LAST_BALANCE if " group[" in ln]
    assert sorted(ln.split(" group")[0] for ln in groups) == [
        f"worker {w} on cpu" for w in range(4)]
    got = result["metrics"]
    assert 0 < got["workers.cpu_share"]["value"] <= 1
    assert "workers.occupancy" not in got
    assert "cards.busy_balance" not in got
