"""The flag scans' share of their memory roofline, in percent: 25 B a
padded block position a launch (``chip_smoke.py``'s arithmetic: the
inputs read once, the outputs written once) at 3.35 TB/s, over the flag
scan kernels' device time, both per profiled matrix."""

from portbench import phases


def read(record):
    seconds, launches = phases.kernel_seconds(
        record, lambda name: "flag_scan_kernel" in name)
    padded = phases.first_number(record, "H2D text (")
    if not seconds or not launches or not padded:
        return None
    bound = 25 * padded * launches / record["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
