"""The share of the segmented walks that the compiled driver ran: the
groups counted in ``walk.driver_native`` over those and
``walk.driver_python`` (the verbatim Python driver, taken where the
driver's library cannot be built), over all the phase-file matrices
together.  None where neither is counted (a program without the counters,
or one whose matrices walk no group segmented)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    native = sum(span_requests.counted(r, "walk.driver_native")
                 for r in reqs)
    python = sum(span_requests.counted(r, "walk.driver_python")
                 for r in reqs)
    return native / (native + python) if native + python else None
