"""The host's text preparation, host seconds a matrix: the subjects'
set-up (reverse complement, threshold: the ``subjects`` span) and the
padded texts of the joint block and of each subject index (``joint.text``,
``sx.text``), over the phase-file matrices."""

from portbench import span_requests

NAMES = {"subjects", "joint.text", "sx.text"}


def read(record):
    return span_requests.mean(
        span_requests.requests(record),
        lambda r: span_requests.host_seconds(r, NAMES))
