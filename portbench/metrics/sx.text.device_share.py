"""The share of the subject indexes' texts made on the device: the texts
counted in ``sx.text_device`` (widened from the RS bytes by
``block_text``) over those and ``sx.text_host`` (padded int32 texts made
on the host, for an overflowed subject's host LCP), over all the
phase-file matrices together.  None where neither is counted (a program
without the counters, or one whose matrices build no subject index)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    device = sum(span_requests.counted(r, "sx.text_device") for r in reqs)
    host = sum(span_requests.counted(r, "sx.text_host") for r in reqs)
    return device / (device + host) if device + host else None
