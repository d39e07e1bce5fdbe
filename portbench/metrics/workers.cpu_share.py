"""The share of the worker threads' walls they spent on a core: their
``cpu_ns`` (the thread's CPU time over its job) over the ``worker`` spans'
walls, summed over the phase-file matrices.  The rest they waited, on the
interpreter's lock, a readback or the card.  None where no worker counts
``cpu_ns`` (a program without the counter)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    cpu = wall = 0
    counted = False
    for r in reqs:
        for s in r["spans"]:
            if s["name"] == "worker":
                wall += s["t1"] - s["t0"]
                if "cpu_ns" in s["counts"]:
                    cpu += s["counts"]["cpu_ns"]
                    counted = True
    return cpu / wall if counted and wall else None
