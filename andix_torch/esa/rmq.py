"""Range-minimum structure over the adjacent-LCP array (counterpart of
``andix/esa/rmq.py``).

O(1) longest-common-extension queries for lucky anchors:
``lce(a, b) = min LCP[(min(ISA[a],ISA[b]), max(ISA[a],ISA[b])]]`` — the
reference's byte-compare ``lcp()`` (src/process.c:59-65).

Three levels, all int32: fine blocks of 8 (per-element prefix/suffix
mins), a sparse table over fine-block mins for spans up to 64 fine
blocks, and groups of 64 fine blocks with per-fine-block prefix/suffix
mins plus a full sparse table over group mins.  The JAX package's
element-span rows (``tsm``) are left out: a same-fine-block query takes
the masked 8-way min instead, which is the same number.

``build`` launches the hand CUDA kernel (``csrc/rmq.cu``, tile bodies in
``csrc/rmq_tile.cuh``) for a CUDA tensor and runs the plain version
``build_plain`` for a CPU tensor; ``build_cpu_twin`` runs the kernel's
tile bodies built with g++.  ``range_min`` here is the plain torch
version; the walk kernel carries the same function as ``range_min`` in
``csrc/walk_lane.cuh``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import kernels

INF = 2**31 - 1
FINE = 8  # elements per fine block
GROUP = 64  # fine blocks per group (512 elements)


@dataclasses.dataclass
class RangeMin:
    values: torch.Tensor  # int32[Np] padded with INF
    pref8: torch.Tensor  # int32[Np] min over [fine_start..t]
    suff8: torch.Tensor  # int32[Np] min over [t..fine_end]
    t8: torch.Tensor  # int32[7, nf] sparse table over fine mins
    prefg: torch.Tensor  # int32[nf] min over fine mins [group_start..c]
    suffg: torch.Tensor  # int32[nf] min over fine mins [c..group_end]
    tg: torch.Tensor  # int32[Lg, ng] full sparse table over group mins


def _shift_min(prev: torch.Tensor, w: int) -> torch.Tensor:
    """min(prev[i], prev[i + w]) with INF past the end."""
    shifted = torch.cat([prev[w:], prev.new_full((min(w, len(prev)),), INF)])
    return torch.minimum(prev, shifted[: len(prev)])


def _cummin(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummin(x.flip(1), dim=1).values.flip(1)
    return torch.cummin(x, dim=1).values


def _padded(values: torch.Tensor) -> torch.Tensor:
    """int32 values padded with INF to a multiple of FINE * GROUP (the
    same tensor when it is one already)."""
    v = values.to(torch.int32)
    pad = (-len(v)) % (FINE * GROUP)
    if pad:
        v = torch.cat([v, v.new_full((pad,), INF)])
    return v


def _tg_rows(ng: int) -> int:
    """Rows of the sparse table over ``ng`` group mins: spans 1, 2, 4, ...
    below ng, and the first."""
    rows, span = 1, 1
    while span < ng:
        rows, span = rows + 1, span * 2
    return rows


def build(values: torch.Tensor) -> RangeMin:
    """The range-min structure over ``values`` (int32 [N]).  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version."""
    if values.device.type == "cpu":
        return build_plain(values)
    v, out = _kernel_outputs(values)
    if v.numel():
        with kernels.launch_on(v.device) as stream:
            err = kernels.cuda_lib().andix_range_min_build(
                v.data_ptr(), ctypes.c_int64(v.numel()),
                *(t.data_ptr() for t in out), out[-1].shape[0], stream)
        kernels.check(err, "range_min_build")
        kernels.count_launch("range_min_build", v.device)
    return RangeMin(v, *out)


def build_cpu_twin(values: torch.Tensor, tiny: bool = False) -> RangeMin:
    """The kernel's tile bodies (``rmq_tile.cuh``) built for the host with
    g++, at the kernel's tiles or (``tiny``) at tiles of 64 and 8 fine
    blocks."""
    if values.device.type != "cpu":
        raise ValueError("rmq: the host twin takes a CPU tensor")
    v, out = _kernel_outputs(values)
    kernels.cpu_twin().andix_range_min_build_cpu(
        v.data_ptr(), ctypes.c_int64(v.numel()),
        *(t.data_ptr() for t in out), out[-1].shape[0], int(tiny))
    return RangeMin(v, *out)


def _kernel_outputs(values: torch.Tensor):
    """The kernel's input, padded, contiguous and 16-byte aligned, and its
    outputs (pref8, suff8, t8, prefg, suffg, tg), uninitialised."""
    v = _padded(values.contiguous())
    if v.data_ptr() % 16:
        v = v.clone()
    if v.numel() >= 1 << 31:
        raise ValueError("rmq: more than 2^31 - 1 values")
    np_, dev = v.numel(), v.device
    nf = np_ // FINE
    ng = nf // GROUP

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    return v, (empty(np_), empty(np_), empty(7, nf), empty(nf), empty(nf),
               empty(_tg_rows(ng), ng))


def build_plain(values: torch.Tensor) -> RangeMin:
    """Plain PyTorch version of ``build``."""
    v = _padded(values)
    nf = len(v) // FINE
    ng = nf // GROUP

    v2 = v.view(nf, FINE)
    pref8 = _cummin(v2).reshape(-1)
    suff8 = _cummin(v2, reverse=True).reshape(-1)
    fmin = v2.amin(dim=1)

    levels = [fmin]
    for k in range(1, 7):
        levels.append(_shift_min(levels[-1], 1 << (k - 1)))
    t8 = torch.stack(levels)

    g2 = fmin.view(ng, GROUP)
    prefg = _cummin(g2).reshape(-1)
    suffg = _cummin(g2, reverse=True).reshape(-1)
    gmin = g2.amin(dim=1)

    glevels = [gmin]
    span = 1
    while span < ng:
        glevels.append(_shift_min(glevels[-1], span))
        span *= 2
    tg = torch.stack(glevels)
    return RangeMin(v, pref8, suff8, t8, prefg, suffg, tg)


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) as an exact integer bit length."""
    x = torch.clamp(x, min=1).to(torch.int64)
    out = torch.zeros_like(x)
    for b in (16, 8, 4, 2, 1):
        hi = x >= (1 << b)
        out = out + torch.where(hi, b, 0)
        x = torch.where(hi, x >> b, x)
    return out


def range_min(rm: RangeMin, lo: torch.Tensor, hi: torch.Tensor):
    """min(values[lo..hi]) inclusive; INF when lo > hi.  Elementwise over
    1-D (lo, hi); both branches of every gate are evaluated."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    empty = lo > hi
    los = torch.where(empty, 0, lo)
    his = torch.where(empty, 0, hi)

    f1 = los // FINE
    f2 = his // FINE
    is_same = f1 == f2

    same = rm.values[los]
    for d in range(1, FINE):
        same = torch.minimum(same, rm.values[torch.minimum(los + d, his)])

    edge = torch.minimum(rm.suff8[los], rm.pref8[his])
    c1 = f1 + 1
    c2 = f2 - 1
    has_mid = c2 >= c1
    c1s = torch.where(has_mid, c1, 0)
    c2s = torch.where(has_mid, c2, 0)
    span = c2s - c1s + 1

    k8 = torch.clamp(ilog2(span), max=6)
    w8 = 1 << k8
    mid_small = torch.minimum(rm.t8[k8, c1s], rm.t8[k8, c2s - w8 + 1])

    g1 = c1s // GROUP
    g2 = c2s // GROUP
    gedge = torch.minimum(rm.suffg[c1s], rm.prefg[c2s])
    h1 = g1 + 1
    h2 = g2 - 1
    has_gm = h2 >= h1
    h1s = torch.where(has_gm, h1, 0)
    h2s = torch.where(has_gm, h2, 0)
    kg = torch.clamp(ilog2(h2s - h1s + 1), max=rm.tg.shape[0] - 1)
    wg = 1 << kg
    gmid = torch.minimum(rm.tg[kg, h1s], rm.tg[kg, h2s - wg + 1])
    inf = torch.full_like(same, INF)
    mid_big = torch.minimum(gedge, torch.where(has_gm, gmid, inf))

    mid = torch.where(span <= 64, mid_small, mid_big)
    mid = torch.where(has_mid, mid, inf)
    out = torch.where(is_same, same, torch.minimum(edge, mid))
    return torch.where(empty, inf, out)
