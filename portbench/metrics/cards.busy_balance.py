"""How evenly the cards worked in the profiled matrices: the least busy
card's ``busy_s_by_card`` over the busiest card's (0 where a visible card
ran nothing).  None without a profile or with no device work."""


def read(record):
    prof = record.get("profile")
    busy = list(((prof or {}).get("busy_s_by_card") or {}).values())
    if not busy or max(busy) <= 0:
        return None
    return min(busy) / max(busy)
