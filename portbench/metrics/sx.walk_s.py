"""The subject schedule's search walk and event fetch, seconds a matrix:
every ``sx: `` phase but the index, the query words and the count."""

from portbench import phases

OTHERS = ("sx: index build", "sx: query words H2D", "sx: host count from")


def read(record):
    return phases.mean_seconds(
        record, lambda label: label.startswith("sx: ")
        and not label.startswith(OTHERS))
