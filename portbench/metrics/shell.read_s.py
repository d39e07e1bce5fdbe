"""The CLI's FASTA read, host seconds a matrix: every file's parse and
normalize (the program's ``fasta.read`` span), over the phase-file
matrices."""

from portbench import span_requests


def read(record):
    return span_requests.mean(
        span_requests.requests(record),
        lambda r: span_requests.host_seconds(r, {"fasta.read"}))
