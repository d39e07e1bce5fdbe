"""The reader of ``join.device_share`` (the files joined on the card over
all files joined in join mode) on canned requests, with the values worked
out by hand and None where no file is joined; and a whole traced run of
the draft cell on the CPU, which joins every file on the host."""

import pytest

from portbench_tiny import run_cell, tiny_root  # noqa: F401
from portbench.run import ROOT, load_metric
from test_portbench_join_spans import joined, one_record, program, record

NAME = "join.device_share"


def on_the_card(req, files):
    """``req`` with its ``fasta.read`` span counting ``files`` files joined
    on the card."""
    read = next(s for s in req["spans"] if s["name"] == "fasta.read")
    read["counts"]["join.device_files"] = files
    return req


@pytest.mark.parametrize("card_files, want", [
    ((0, 0), 0.0),  # three files joined on the host, none on the card
    ((2, 0), 2 / 5),
    ((6, 1), 7 / 10),
])
def test_share_on_canned_requests(card_files, want, monkeypatch):
    read = load_metric(ROOT, NAME)
    reqs = [on_the_card(r, n) for r, n in zip(joined(), card_files)]
    program(monkeypatch, reqs)
    assert read(record(2)) == pytest.approx(want, rel=1e-12)


def test_every_file_on_the_card_reads_one(monkeypatch):
    """Requests that join every file on the card: no ``ingest.join``
    span opens; requests kept before the phase-file matrices are not
    theirs."""
    read = load_metric(ROOT, NAME)
    program(monkeypatch, joined()[:1] + [on_the_card(one_record(), 8)] * 2)
    assert read(record(2)) == 1.0


@pytest.mark.parametrize("card_files, want", [
    (8, 8 / 9),
    (0, 0.0),  # the card took none of the files it read
])
def test_the_card_read_span_is_not_a_host_file(card_files, want,
                                               monkeypatch):
    """The card's read of its files is one ``ingest.join`` span that
    counts them in ``join.device_files``; it is no file joined on the
    host, while a span without the counter is one."""
    read = load_metric(ROOT, NAME)
    req = one_record()
    req["spans"] += [
        {"id": 31, "name": "ingest.join", "parent": 21, "t0": 0, "t1": 5,
         "counts": {"join.device_files": card_files}},
        {"id": 32, "name": "ingest.join", "parent": 21, "t0": 5, "t1": 9,
         "counts": {}}]
    program(monkeypatch, [req])
    assert read(record(1)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("requests, matrices", [
    (None, 2),  # a program without spans
    (lambda: [one_record()] * 2, 2),  # no file joined anywhere
    (lambda: joined()[:1], 2),  # fewer requests than matrices
    (joined, 0),  # no phase-file matrices
])
def test_share_reads_nothing(requests, matrices, monkeypatch):
    import sys

    read = load_metric(ROOT, NAME)
    if requests is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, requests())
    assert read(record(matrices)) is None


def test_a_traced_draft_run_reads_the_share(tiny_root):  # noqa: F811
    """``draft8x5m.divergent`` at test size, traced, on the CPU backend:
    correct, every file joined on the host; the one-record cell does not
    report the share."""
    result, _ = run_cell(tiny_root, "draft8x5m.divergent", trace_on=True)
    assert result["correct"] is True
    assert result["metrics"][NAME]["value"] == 0
    result, _ = run_cell(tiny_root, "bact8x5m.divergent", trace_on=True)
    assert result["correct"] is True
    assert NAME not in result["metrics"]
