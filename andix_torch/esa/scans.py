"""Flag-window scan (the matching statistics' one pass primitive).

``flag_scan`` is the inclusive scan of the flag-window monoid
``_fs_combine`` (``andix/esa/scans.py``): per position it returns

* ``k``   — number of flagged entries seen so far (capped at 2),
* ``g``   — min of values in (second-last flag, last flag],
* ``sa``  — payload of the last flagged entry,
* ``suf`` — min of values in (last flag, here].

On a CUDA tensor it launches the hand-written kernel
(``csrc/flag_scan.cu``, one pass with decoupled look-back); on a CPU
tensor it runs the plain version below, a log-step (Hillis-Steele) scan
of the same monoid — exact because the monoid is associative.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

INF32 = 2**31 - 1


def _fs_combine(a, b):
    """Window-composition monoid; state (k, pre, g, sa, suf), identity
    (0, INF, INF, -1, INF)."""
    k1, p1, g1, s1, f1 = a
    k2, p2, g2, s2, f2 = b
    has1 = k1 > 0
    has2 = k2 > 0
    inf = torch.full_like(p1, INF32)
    bridge = torch.minimum(f1, p2)
    k = torch.clamp(k1 + k2, max=2)
    pre = torch.where(has1, p1, torch.minimum(p1, p2))
    sa_ = torch.where(has2, s2, s1)
    g = torch.where(
        has2, torch.where(k2 >= 2, g2, torch.where(has1, bridge, inf)), g1
    )
    suf = torch.where(has2, f2, torch.where(has1, bridge, inf))
    return (k, pre, g, sa_, suf)


def flag_scan_plain(values: torch.Tensor, flags: torch.Tensor,
                    sa_vals: torch.Tensor):
    """Plain PyTorch evaluation: log2(n) rounds of combine-with-shifted."""
    fl = flags.to(torch.int32)
    inf = torch.full_like(values, INF32)
    state = (
        fl,
        values.to(torch.int32),
        inf,
        torch.where(flags, sa_vals.to(torch.int32), -1),
        inf.clone(),
    )
    n = values.shape[0]
    ident = (0, INF32, INF32, -1, INF32)
    shift = 1
    while shift < n:
        left = tuple(
            torch.cat([torch.full((shift,), i0, dtype=torch.int32,
                                  device=x.device), x[:-shift]])
            for i0, x in zip(ident, state)
        )
        state = _fs_combine(left, state)
        shift *= 2
    k, _, g, sa_, suf = state
    return k, g, sa_, suf


def flag_scan(values: torch.Tensor, flags: torch.Tensor,
              sa_vals: torch.Tensor, reverse: bool = False):
    """(k, g, sa, suf) int32 tensors of the scan over (values int32,
    flags bool, sa_vals int32).  ``reverse=True`` scans from the last
    element to the first (outputs stay in memory order)."""
    if values.device.type == "cpu":
        if reverse:
            outs = flag_scan_plain(values.flip(0), flags.flip(0),
                                   sa_vals.flip(0))
            return tuple(x.flip(0) for x in outs)
        return flag_scan_plain(values, flags, sa_vals)
    return _flag_scan_cuda(values, flags, sa_vals, reverse)


def _check_inputs(values, flags, sa_vals, device_type):
    n = values.shape[0]
    for name, t, dt in (("values", values, torch.int32),
                        ("flags", flags, torch.bool),
                        ("sa_vals", sa_vals, torch.int32)):
        if t.device != values.device or t.device.type != device_type:
            raise ValueError(f"flag_scan: {name} must be on the "
                             f"{device_type.upper()} device")
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(
                f"flag_scan: {name} must be 1-D {dt} of length {n}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"flag_scan: {name} must be contiguous")


def flag_scan_scratch(n: int, reverse: bool, device) -> torch.Tensor:
    """The kernel's int32 scratch for a scan of n positions: one status
    word per tile, the tile counter, and each tile's aggregate and
    inclusive prefix (``flag_scan_tile.cuh``)."""
    ints = kernels.cuda_lib().andix_flag_scan_scratch_ints(n, int(reverse))
    return torch.empty(max(ints, 4), dtype=torch.int32, device=device)


def _flag_scan_cuda(values, flags, sa_vals, reverse, scratch=None):
    """One launch of the kernel; ``scratch`` (``flag_scan_scratch``) may be
    given to read the tiles' published states afterwards."""
    _check_inputs(values, flags, sa_vals, "cuda")
    n = values.shape[0]
    lib = kernels.cuda_lib()
    outs = [torch.empty(n, dtype=torch.int32, device=values.device)
            for _ in range(4)]
    if scratch is None:
        scratch = flag_scan_scratch(n, reverse, values.device)
    elif (scratch.dtype != torch.int32 or scratch.device != values.device
          or scratch.numel() < lib.andix_flag_scan_scratch_ints(
              n, int(reverse))):
        raise ValueError("flag_scan: scratch must come from "
                         "flag_scan_scratch for this n and direction")
    # the kernel reads and writes 16 bytes at a time
    for name, t in (("values", values), ("flags", flags),
                    ("sa_vals", sa_vals), ("scratch", scratch)):
        if t.data_ptr() % 16:
            raise ValueError(f"flag_scan: {name} must be 16-byte aligned")
    with kernels.launch_on(values.device) as stream:
        err = lib.andix_flag_scan(
            values.data_ptr(), flags.data_ptr(), sa_vals.data_ptr(),
            ctypes.c_int64(n), 1 if reverse else 0, scratch.data_ptr(),
            *(o.data_ptr() for o in outs), stream,
        )
    kernels.check(err, "flag_scan")
    kernels.count_launch("flag_scan", values.device)
    return tuple(outs)


def flag_scan_cpu_twin(values, flags, sa_vals, reverse: bool = False,
                       agg_only=None, tiny: bool = False):
    """The kernel's tile body and look-back (``flag_scan_tile.cuh``) built
    for the host with g++, tiles run in counter order — for testing the
    kernel's logic without a card.  ``agg_only``, a bool [tiles] tensor
    (``flag_scan_cpu_tiles``), marks tiles that publish only their
    aggregate; ``tiny`` takes tiles of 64 positions instead of the
    kernel's 4096.  Returns (k, g, sa, suf, status), status being each
    tile's final status word (1 aggregate, 2 inclusive)."""
    _check_inputs(values, flags, sa_vals, "cpu")
    n = values.shape[0]
    tiles = flag_scan_cpu_tiles(n, reverse, tiny)
    if agg_only is not None and (agg_only.dtype != torch.bool
                                 or agg_only.shape != (tiles,)):
        raise ValueError(f"flag_scan_cpu_twin: agg_only must be bool "
                         f"[{tiles}]")
    outs = [torch.empty(n, dtype=torch.int32) for _ in range(4)]
    status = torch.zeros(tiles, dtype=torch.int32)
    kernels.cpu_twin().andix_flag_scan_cpu(
        values.data_ptr(), flags.data_ptr(), sa_vals.data_ptr(),
        ctypes.c_int64(n), 1 if reverse else 0,
        None if agg_only is None else agg_only.contiguous().data_ptr(),
        int(tiny), *(o.data_ptr() for o in outs), status.data_ptr())
    return (*outs, status)


def flag_scan_cpu_tiles(n: int, reverse: bool = False,
                        tiny: bool = False) -> int:
    """Tiles of the host twin's scan of n positions."""
    return int(kernels.cpu_twin().andix_flag_scan_cpu_tiles(
        n, int(reverse), int(tiny)))
