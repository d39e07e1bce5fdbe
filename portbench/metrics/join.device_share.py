"""The share of the files joined in join mode (``-j``) that the CLI joined
on the card: the files counted in ``join.device_files`` over those and the
files joined on the host (each one ``ingest.join`` span without a
``join.device_files`` counter; the card's read of its files is one span
with it), over all the phase-file matrices together.  None where neither
appears (a run without ``-j``)."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    if not reqs:
        return None
    device = sum(span_requests.counted(r, "join.device_files")
                 for r in reqs)
    host = sum(s["name"] == "ingest.join"
               and "join.device_files" not in s["counts"]
               for r in reqs for s in r["spans"])
    return device / (device + host) if device + host else None
