"""The joint block's build, seconds a matrix: the SA doubling, the LCP
(and its host round trip), the block tables and the subject tables."""

from portbench import phases

PREFIXES = ("SA doubling", "LCP ", "host LCP round trip", "block tables",
            "subject tables")


def read(record):
    return phases.mean_seconds(record,
                               lambda label: label.startswith(PREFIXES))
