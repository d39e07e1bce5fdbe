"""The subject indexes, seconds a matrix: their build and the query
words' upload."""

from portbench import phases

PREFIXES = ("sx: index build", "sx: query words H2D")


def read(record):
    return phases.mean_seconds(record,
                               lambda label: label.startswith(PREFIXES))
