"""Process group from torchrun's environment (counterpart of
``andix/_distributed.py``).

``torchrun --nproc-per-node=N -m andix_torch.cli ...`` sets, per process:

  RANK, WORLD_SIZE   this process's rank and the process count
  LOCAL_RANK         its rank on this host (picks its card, ``device``)
  LOCAL_WORLD_SIZE   the process count on this host (which ranks share a
                     card's memory, ``device.ranks_on``)
  MASTER_ADDR, MASTER_PORT   where rank 0 listens

The group is ``gloo``: what crosses it are host arrays (the 16-cell
counts and ``seq_len``s of finished rows, the rows left to do), and NCCL
refuses two ranks on one card.  ``andix``'s ``ANDIX_COORDINATOR``,
``ANDIX_NUM_PROCESSES`` and ``ANDIX_PROCESS_ID`` are not read: a process
that imports ``andix`` joins a JAX cluster from them.  Without
``WORLD_SIZE`` > 1 nothing happens and the run is single-process.

A rank whose run raises exits, and the other ranks' next collective then
fails at once on the closed connection, so every rank fails.  The
collective timeout, COLLECTIVE_TIMEOUT_S, bounds how long a rank waits in
a collective for the others: the gather after the grid waits for the
slowest rank's share, hours into a large run, so it is a day (as
``andix``'s scripts/st131_mesh.py sets it), not gloo's default 30 minutes;
it only ever cuts a rank that hangs.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 86_400


def maybe_init_distributed() -> bool:
    """Join the process group torchrun's variables describe (idempotent);
    False when they describe none."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}:{port}",
        rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
