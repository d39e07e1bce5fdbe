"""How fully the worker threads held the visible cards: the ``worker``
spans' walls over (visible cards x the longest worker's wall), summed over
the phase-file matrices.  A card with no worker, or a worker that ends
early, lowers it.  The visible cards are ``peak_bytes_by_card``'s; None
without a card or a ``worker`` span."""

from portbench import span_requests


def read(record):
    reqs = span_requests.requests(record)
    cards = len(record.get("peak_bytes_by_card") or [])
    if not reqs or not cards:
        return None
    busy = held = 0
    for r in reqs:
        walls = [s["t1"] - s["t0"] for s in r["spans"]
                 if s["name"] == "worker"]
        if walls:
            busy += sum(walls)
            held += cards * max(walls)
    return busy / held if held else None
