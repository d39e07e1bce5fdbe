"""The share of the profiled matrices' wall in which no kernel, copy or
fill ran on the card, in percent."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["wall_s"] or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
