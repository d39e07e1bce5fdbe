"""The suffix-array doubling loop's share of its memory roofline, in
percent: (8 + 4 x levels) B a padded block position (``chip_smoke.py``'s
``sa_bound``: the text read once, the SA and each level row written
once; the sort's passes are the sort's choice and not counted), with the
levels from the ``SA doubling (N levels`` phase, at 3.35 TB/s, over the
device time of the loop's kernels (keys, rerank, pair scatter) and of
the toolkit CUB radix sort it calls, per profiled matrix.  PyTorch's own
CUB copy (namespace ``at_cuda_detail``) is not the loop's."""

from portbench import phases

KERNELS = ("initial_key_kernel", "full_key_kernel", "tail_key_kernel",
           "rerank_kernel", "pair_scatter_kernel")


def loop_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS) or (
        "DeviceRadixSort" in name and "at_cuda_detail" not in name)


def read(record):
    seconds, _ = phases.kernel_seconds(record, loop_kernel)
    padded = phases.first_number(record, "H2D text (")
    levels = phases.first_number(record, "SA doubling (")
    if not seconds or not padded or not levels:
        return None
    bound = (8 + 4 * levels) * padded / record["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
