"""The reader of ``ingest.device_share`` (the files the CLI read on the
card over all files it read) on canned requests, with the value worked out
by hand; and a whole traced run on the CPU, which reads every file on the
host."""

import sys

import pytest

from portbench_tiny import tiny_root  # noqa: F401  (and the root on the path)
from portbench.run import load_metric, ROOT
from test_portbench_harness import run_cell
from test_portbench_span_metrics import canned, program, record

NAME = "ingest.device_share"


def counted(requests, *files):
    """The canned requests with each request's ``fasta.read`` span given
    (device files, host files), None leaving a counter out."""
    for req, (device, host) in zip(requests, files):
        read = next(s for s in req["spans"] if s["name"] == "fasta.read")
        if device is not None:
            read["counts"]["ingest.device_files"] = device
        if host is not None:
            read["counts"]["ingest.host_files"] = host
    return requests


@pytest.mark.parametrize("files, want", [
    (((3, 1), (4, None)), 7 / 8),  # 3 on the card, 1 on the host; 4
    (((3, None), (4, None)), 1.0),
    (((None, 2), (0, 3)), 0.0),
])
def test_share_on_canned_requests(files, want, monkeypatch):
    read = load_metric(ROOT, NAME)
    program(monkeypatch, counted(canned(), *files))
    assert read(record(2)) == pytest.approx(want, rel=1e-12)


def test_share_takes_the_last_requests(monkeypatch):
    """Requests kept before the phase-file matrices are not theirs."""
    read = load_metric(ROOT, NAME)
    older, newer = counted(canned(), (0, 5), (2, None))
    program(monkeypatch, [older, newer])
    assert read(record(1)) == 1.0


def counted_both():
    return counted(canned(), (3, 1), (4, 0))


@pytest.mark.parametrize("requests, matrices", [
    (None, 2),  # a program without spans
    (lambda: [], 2),
    (canned, 2),  # no file counted (the parent of the card's read path)
    (lambda: counted_both()[:1], 2),  # fewer requests than matrices
    (counted_both, 0),  # no phase-file matrices
])
def test_share_reads_nothing(requests, matrices, monkeypatch):
    read = load_metric(ROOT, NAME)
    if requests is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, requests())
    assert read(record(matrices)) is None


def test_a_traced_run_reads_the_share(tiny_root):  # noqa: F811
    """A whole traced run of each cell on the CPU backend: every file is
    read on the host."""
    for cell in ("bact8x5m.divergent", "bact10x5m.divergent"):
        result, _ = run_cell(tiny_root, cell, trace_on=True)
        assert result["correct"] is True
        assert result["metrics"][NAME]["value"] == 0
