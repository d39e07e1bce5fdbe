"""Host seconds a matrix blocked in reads of device tensors (the
program's ``wait_ns`` counter, summed over each request), over the
phase-file matrices."""

from portbench import span_requests


def read(record):
    return span_requests.mean(
        span_requests.requests(record),
        lambda r: span_requests.counted(r, "wait_ns") / 1e9)
