"""The reader of ``walk.native_share`` (the segmented walks the compiled
driver ran over all segmented walks) on canned requests, with the value
worked out by hand."""

import sys

import pytest

import portbench_tiny  # noqa: F401  (puts the root on the path)
from portbench.run import load_metric, ROOT
from test_portbench_span_metrics import canned, program, record

NAME = "walk.native_share"


def counted(requests, *drivers):
    """The canned requests with each request's walk span given (compiled
    walks, Python walks), None leaving a counter out."""
    for req, (native, python) in zip(requests, drivers):
        walk = next(s for s in req["spans"]
                    if s["name"] in ("joint.walk", "sx.walk"))
        if native is not None:
            walk["counts"]["walk.driver_native"] = native
        if python is not None:
            walk["counts"]["walk.driver_python"] = python
    return requests


@pytest.mark.parametrize("drivers, want", [
    (((1, None), (1, None)), 1.0),  # every walk compiled
    (((None, 1), (0, 2)), 0.0),  # the library did not build
    (((3, 1), (None, None)), 3 / 4),
])
def test_share_on_canned_requests(drivers, want, monkeypatch):
    read = load_metric(ROOT, NAME)
    program(monkeypatch, counted(canned(), *drivers))
    assert read(record(2)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("requests, matrices", [
    (None, 2),  # a program without spans
    (lambda: [], 2),
    (canned, 2),  # no walk counted (the parent of the compiled driver)
    (lambda: counted(canned(), (1, 0), (1, 0))[:1], 2),  # too few requests
    (lambda: counted(canned(), (1, 0), (1, 0)), 0),  # no phase matrices
])
def test_share_reads_nothing(requests, matrices, monkeypatch):
    read = load_metric(ROOT, NAME)
    if requests is None:
        monkeypatch.delitem(sys.modules, "andix_torch.spans", raising=False)
    else:
        program(monkeypatch, requests())
    assert read(record(matrices)) is None
