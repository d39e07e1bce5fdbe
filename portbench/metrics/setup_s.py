"""Process start to window start: imports, the family and its FASTA, the
kernel build or load, the cold matrix."""


def read(record):
    return record.get("setup_s")
