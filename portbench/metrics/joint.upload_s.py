"""The joint block's text upload, seconds a matrix (``H2D text``)."""

from portbench import phases


def read(record):
    return phases.mean_seconds(record,
                               lambda label: label.startswith("H2D text"))
