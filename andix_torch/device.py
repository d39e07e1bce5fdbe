"""Device choice from the CLI's ``--backend`` flag.

* ``auto`` and ``cuda``: the CUDA cards.  No card is an error — there is
  no CPU fallback.  ``resolve_devices`` gives every visible card
  (``CUDA_VISIBLE_DEVICES`` narrows the list), as ``andix`` takes every
  ``jax.devices()``; under a process group each process takes one card,
  ``LOCAL_RANK % torch.cuda.device_count()`` (torchrun's layout).
* ``cpu``: the kernels' plain PyTorch versions on the CPU (the tests).
* ``jax`` and ``numpy`` name the reference package's backends and are
  refused.
"""

from __future__ import annotations

import os

import torch

from . import _distributed

BACKENDS = ("auto", "cuda", "cpu")


def memory_budget(device: torch.device, share: int = 1) -> int:
    """Bytes a block may use: 90% of the card's free memory, or half the
    host's physical memory for the CPU backend, split evenly between the
    ``share`` workers that run on the device."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * 0.9) // share
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
               * 0.5) // share


class DeviceError(RuntimeError):
    """The requested backend cannot run here."""


def resolve_devices(backend: str) -> list[torch.device]:
    """The devices this process runs on, in worker order."""
    if backend in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise DeviceError(
                f"--backend {backend} needs a CUDA device and none was "
                f"found; pass --backend cpu to run the plain PyTorch "
                f"versions on the CPU."
            )
        count = torch.cuda.device_count()
        if _distributed.world_size() > 1:
            return [torch.device("cuda", _distributed.local_rank() % count)]
        return [torch.device("cuda", i) for i in range(count)]
    if backend == "cpu":
        return [torch.device("cpu")]
    raise DeviceError(
        f"unknown backend '{backend}'; expected one of "
        f"{', '.join(BACKENDS)} (the 'jax' and 'numpy' backends belong to "
        f"the andix package)."
    )


def ranks_on(device: torch.device) -> int:
    """The processes of this host whose workers run in ``device``'s memory:
    1 in a single-process run; under a process group every local rank for
    the CPU, and for a card the local ranks that take it
    (``LOCAL_RANK % device_count``, as ``resolve_devices``).  The local
    ranks are torchrun's ``LOCAL_WORLD_SIZE``, else every rank."""
    world = _distributed.world_size()
    if world == 1:
        return 1
    local = _distributed.local_world_size()
    if device.type != "cuda":
        return local
    count = torch.cuda.device_count()
    return max(1, sum(1 for r in range(local) if r % count == device.index))
