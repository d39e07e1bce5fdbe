"""The reader of ``sx.text.device_share`` (the subject indexes' texts
made on the device over all their texts) on canned requests, with the
value worked out by hand."""

import sys

import pytest

import portbench_tiny  # noqa: F401  (puts the root on the path)
from portbench.run import load_metric, ROOT
from test_portbench_span_metrics import canned, program, record

NAME = "sx.text.device_share"


def counted(requests, *texts):
    """The canned requests with the second request's ``sx.index`` span
    given (device texts, host texts) for each of ``texts``' entries after
    the first, which goes to the first request's outermost counts, None
    leaving a counter out."""
    index = next(s for s in requests[1]["spans"] if s["name"] == "sx.index")
    for counts, (device, host) in zip((requests[0]["counts"],
                                       index["counts"]), texts):
        if device is not None:
            counts["sx.text_device"] = device
        if host is not None:
            counts["sx.text_host"] = host
    return requests


@pytest.mark.parametrize("texts, want", [
    (((None, None), (10, None)), 1.0),  # every text on the device
    (((None, None), (10, 0)), 1.0),
    (((0, 2), (None, 2)), 0.0),  # every text on the host
    (((3, None), (8, 1)), 11 / 12),  # an overflowed subject's host LCP
])
def test_share_on_canned_requests(texts, want, monkeypatch):
    read = load_metric(ROOT, NAME)
    program(monkeypatch, counted(canned(), *texts))
    assert read(record(2)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("requests, matrices", [
    (None, 2),  # a program without spans
    (lambda: [], 2),
    (canned, 2),  # no text counted (the parent of the counters)
    (lambda: counted(canned(), (None, None), (10, 0))[:1], 2),  # too few
    (lambda: counted(canned(), (None, None), (10, 0)), 0),  # no matrices
])
def test_share_reads_nothing(requests, matrices, monkeypatch):
    read = load_metric(ROOT, NAME)
    if requests is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, requests())
    assert read(record(matrices)) is None
