"""The share of the FASTA files the CLI read on the card: the files
counted in ``ingest.device_files`` over those and ``ingest.host_files``,
over all the phase-file matrices together.  None where the program counts
no file (a program without the card's read path)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    device = sum(span_requests.counted(r, "ingest.device_files")
                 for r in reqs)
    host = sum(span_requests.counted(r, "ingest.host_files") for r in reqs)
    return device / (device + host) if device + host else None
