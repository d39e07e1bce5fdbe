"""The walk driver's own host seconds a matrix: the host seconds of the
walk phases (``joint.walk``, ``sx.walk`` spans) less the host nanoseconds
that the spans under them spent blocked in readbacks (``wait_ns``) and in
uploads (``upload_ns``), over the phase-file matrices."""

from portbench import span_requests

WALKS = {"joint.walk", "sx.walk"}


def driver_seconds(request):
    total = 0
    for walk in request["spans"]:
        if walk["name"] in WALKS:
            below = span_requests.subtree(request, walk)
            total += walk["t1"] - walk["t0"] - sum(
                s["counts"].get("wait_ns", 0) + s["counts"].get("upload_ns", 0)
                for s in below)
    return total / 1e9


def read(record):
    return span_requests.mean(span_requests.requests(record),
                              driver_seconds)
