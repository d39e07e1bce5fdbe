"""The segmented walk driver's dispatches a matrix (``walk.dispatch``
spans, one a call of the walk), over the phase-file matrices."""

from portbench import span_requests


def read(record):
    return span_requests.mean(
        span_requests.requests(record),
        lambda r: sum(s["name"] == "walk.dispatch" for s in r["spans"]))
