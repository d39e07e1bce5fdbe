"""The subjects whose reverse strand and G+C count the host makes, host
seconds a matrix: the program's ``subjects.host`` spans, one a subject,
over the phase-file matrices.  None where no such span opens (every
subject made from the card's read, or a program without the span)."""

from portbench import span_requests

SPANS = {"subjects.host"}


def read(record):
    reqs = span_requests.requests(record)
    if not any(s["name"] in SPANS for r in reqs or [] for s in r["spans"]):
        return None
    return span_requests.mean(
        reqs, lambda r: span_requests.host_seconds(r, SPANS))
