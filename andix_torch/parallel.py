"""The pair grid over several devices and processes (counterpart of
``andix/parallel.py``, without shard_map).

``andix`` shards subject rows over a device mesh and runs one SPMD program
per block.  Here each device gets a worker thread that runs its share of
rows through the one-device code (``pipeline._process_block``, or the
subject-index group driver); torch ops, the kernels' ctypes calls and the
host counting release the GIL, so the cards work at once while the host
drivers interleave.  Across processes (torchrun, ``_distributed``) every
rank computes its rows and rank 0 gathers them.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch.distributed as dist

from . import _distributed, kernels, native, spans
from .chain import segdrive
from .model import CountMatrix


def round_robin_blocks(n_subjects: int, n_devices: int) -> list[list[int]]:
    """Contiguous split of subject indices across devices."""
    per = -(-n_subjects // n_devices)
    return [
        list(range(d * per, min(n_subjects, (d + 1) * per)))
        for d in range(n_devices)
    ]


def run_workers(jobs: list[Callable[[], None]],
                devices: list | None = None) -> list[float]:
    """Run each job on a thread of its own and wait for every one.  Each
    job's exception is kept; after the join the first is raised, with the
    others, when there are any, as its cause.  Returns each job's wall
    seconds.  Each job runs in a ``worker`` span on its device
    (``devices[k]``) under the caller's open span, whose ``cpu_ns`` counts
    the thread's CPU nanoseconds over the job (the rest of its wall it
    waited: on the GIL, a readback or the card)."""
    walls = [0.0] * len(jobs)
    errors: list[BaseException | None] = [None] * len(jobs)
    parent = spans.current()

    def run(k):
        t0 = time.perf_counter()
        try:
            with spans.span("worker", devices[k] if devices else None,
                            parent=parent) as sp:
                c0 = time.thread_time_ns() if sp else 0
                try:
                    jobs[k]()
                finally:
                    if sp:
                        spans.count("cpu_ns", time.thread_time_ns() - c0)
        except BaseException as e:  # raised after the join
            errors[k] = e
        walls[k] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if len(failed) > 1:
        raise failed[0] from RuntimeError(
            f"{len(failed) - 1} other worker(s) failed too: {failed[1:]!r}")
    if failed:
        raise failed[0]
    return walls


def load_libraries(devices) -> None:
    """Build and load the kernel library (for CUDA devices), the host
    counting library and the segmented walk driver once, before worker
    threads start."""
    if any(d.type == "cuda" for d in devices):
        kernels.cuda_lib()
    native.available()
    segdrive.available()


class LockedProgress:
    """A progress meter that several workers advance (``andix``'s
    ``publish_lock``)."""

    def __init__(self, meter):
        self.meter = meter
        self.lock = threading.Lock()

    def advance(self, k: int) -> None:
        with self.lock:
            self.meter.advance(k)


def broadcast(obj):
    """Rank 0's ``obj`` on every rank."""
    if _distributed.world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    if _distributed.world_size() == 1:
        return [obj]
    out = [None] * _distributed.world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_rows(rows: dict[int, dict[int, CountMatrix]], n: int):
    """Rank 0 receives every rank's finished rows ``{i: {j: CountMatrix}}``
    (each row complete but for ``j == i``), its own included; the other
    ranks get None.  What crosses is int64 host arrays: the row ids, the
    [R, n, 16] counts and the [R, n] ``seq_len``s."""
    ids = np.array(sorted(rows), dtype=np.int64)
    counts = np.zeros((len(ids), n, 16), dtype=np.int64)
    seq_len = np.zeros((len(ids), n), dtype=np.int64)
    for r, i in enumerate(ids):
        for j, cm in rows[int(i)].items():
            counts[r, j] = cm.counts
            seq_len[r, j] = cm.seq_len
    world = _distributed.world_size()
    if world == 1:
        parts = [(ids, counts, seq_len)]
    else:
        parts = [None] * world if _distributed.rank() == 0 else None
        dist.gather_object((ids, counts, seq_len), parts, dst=0)
        if parts is None:
            return None
    return {
        int(i): {j: CountMatrix(c[r, j].copy(), int(sl[r, j]))
                 for j in range(n) if j != i}
        for ids_, c, sl in parts
        for r, i in enumerate(ids_)
    }
