"""torch.cuda.max_memory_allocated() over the window, reset at its start,
in GiB."""


def read(record):
    peak = record.get("peak_bytes")
    return peak / 2**30 if peak else None
