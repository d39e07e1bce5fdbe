"""The host count from the walks' anchors, seconds a matrix."""

from portbench import phases

PREFIXES = ("host count from", "sx: host count from")


def read(record):
    return phases.mean_seconds(record,
                               lambda label: label.startswith(PREFIXES))
