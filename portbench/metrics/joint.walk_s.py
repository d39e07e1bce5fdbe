"""The joint schedule's walk, seconds a matrix: the segmented driver, the
unsegmented walk where it is taken, and the count-in-loop replay after
an event overflow."""

from portbench import phases

PREFIXES = ("segmented walk", "anchor chain dispatch", "event buffer of",
            "count-in-loop replay")


def read(record):
    return phases.mean_seconds(record,
                               lambda label: label.startswith(PREFIXES))
