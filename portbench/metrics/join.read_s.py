"""The host read of the files joined in join mode (``-j``), host seconds a
matrix: each file's parse, normalize and join (the program's
``ingest.join`` spans, one a file), over the phase-file matrices.  None
where no such span opens (a run without ``-j``, or a program without the
span)."""

from portbench import span_requests

SPANS = {"ingest.join"}


def read(record):
    reqs = span_requests.requests(record)
    if not any(s["name"] in SPANS for r in reqs or [] for s in r["spans"]):
        return None
    return span_requests.mean(
        reqs, lambda r: span_requests.host_seconds(r, SPANS))
