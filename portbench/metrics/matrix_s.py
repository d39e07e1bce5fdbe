"""Seconds a matrix, over the window: its length over the matrices it
completed (host clock, each matrix ending in a synchronize)."""


def read(record):
    w = record.get("window")
    if not w or not w["completed"]:
        return None
    return w["seconds"] / w["completed"]
