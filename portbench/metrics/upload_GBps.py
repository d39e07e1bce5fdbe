"""The host-to-device copies' rate, GB/s: the bytes uploaded to a card
(``h2d_bytes``) over the host nanoseconds of those copies (``upload_ns``),
over all the phase-file matrices together.  None where nothing crossed
(the CPU backend)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    nbytes = sum(span_requests.counted(r, "h2d_bytes") for r in reqs)
    ns = sum(span_requests.counted(r, "upload_ns") for r in reqs)
    return nbytes / ns if nbytes and ns else None
