"""Device bootstrap: every resampling round in one launch (counterpart of
``andix/bootstrap.py``).

``device_bootstrap_rounds`` draws [rounds, pairs, 16] multinomial
resamples of the averaged count matrices, each pair's total kept, in one
launch of a hand-written kernel (``csrc/bootstrap.cu``): a warp a pair,
its lanes 32 of the pair's rounds, the 16 cells as conditional binomials
over Philox4x32-10 words keyed by the seed (``csrc/bootstrap_lane.cuh``
sets out the sampler).  ``andix`` draws with ``jax.random.multinomial``, whose
threefry stream torch cannot reproduce, so the two agree in their
properties and their distribution, not in their draws.  Counts are
carried as int64 (``andix`` carries float64, exact below 2^53).

As in ``andix``, the CLI does not call this: ``-b`` keeps the host
resampler, whose stream is the same on every backend, and
``ANDIX_DEVICE_BOOTSTRAP=1`` only prints a note.

Three routes, like every kernel of the port: on a CUDA tensor the kernel;
its g++ twin (``resample_cpu_twin``, the same body); and
``resample_plain``, the same sampler in torch ops run in lock step over
every (round, pair) at once, which a CPU tensor takes.  All three draw the
same Philox words and do the same float64 operations in the same order,
so they give the same counts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .device import resolve_devices
from .model import CountMatrix

CELLS = 16
INV_MEAN = 10.0  # BOOT_INV_MEAN: inversion below this mean, BTRS above
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
         0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
         0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
         0.00833056343336287)


def device_bootstrap_rounds(averaged: list[CountMatrix], rounds: int,
                            seed: int, device=None) -> np.ndarray:
    """All bootstrap replicates of the upper-triangle pair list in one
    launch: int64 [rounds, len(averaged), 16].  ``device`` defaults to the
    card; pass ``torch.device("cpu")`` for the plain version."""
    if not averaged or rounds <= 0:
        return np.zeros((max(rounds, 0), len(averaged), CELLS),
                        dtype=np.int64)
    device = device or resolve_devices("cuda")[0]
    counts = np.stack([m.counts for m in averaged]).astype(np.int64)
    out = resample(torch.from_numpy(counts).to(device), rounds, seed)
    return out.cpu().numpy()


def resample(counts, rounds: int, seed: int):
    """int64 [rounds, P, 16] resamples of int64 [P, 16] ``counts``: the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if counts.device.type == "cpu":
        return resample_plain(counts, rounds, seed)
    if counts.device.type != "cuda":
        raise ValueError(f"bootstrap: counts on {counts.device}")
    out = _out(counts, rounds)
    lib = kernels.cuda_lib()
    with kernels.launch_on(counts.device) as stream:
        err = lib.andix_bootstrap_resample(
            counts.data_ptr(), counts.shape[0], rounds, seed & _MASK,
            out.data_ptr(), stream)
    kernels.check(err, "bootstrap_resample")
    kernels.count_launch("bootstrap_resample", counts.device)
    return out


def resample_cpu_twin(counts, rounds: int, seed: int, tally=None):
    """The kernel's body (``bootstrap_lane.cuh``) built for the host with
    g++, at the kernel's mapping: each pair's constants once a chunk of
    32 rounds, then the chunk's rounds.  ``tally``, when a dict, receives
    the sampler's work, as ``resample_plain``'s."""
    out = _out(counts, rounds, torch.device("cpu"))
    t = torch.zeros(3, dtype=torch.int64)
    kernels.cpu_twin().andix_bootstrap_resample_cpu(
        counts.data_ptr(), counts.shape[0], rounds, seed & _MASK,
        out.data_ptr(), t.data_ptr())
    if tally is not None:
        tally.update(zip(("inv_attempts", "inv_steps", "btrs_attempts"),
                         t.tolist()))
    return out


def _out(counts, rounds, device=None):
    """Check ``counts`` and allocate the output."""
    if device is not None and counts.device != device:
        raise ValueError(f"bootstrap: counts on {counts.device}, expected "
                         f"{device}")
    if (counts.dtype != torch.int64 or counts.dim() != 2
            or counts.shape[1] != CELLS or not counts.is_contiguous()):
        raise ValueError(f"bootstrap: counts must be a contiguous int64 "
                         f"[P, 16] tensor, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if not 0 < rounds < 1 << 31 or not 0 < counts.shape[0] < 1 << 31:
        raise ValueError(f"bootstrap: {rounds} rounds of "
                         f"{counts.shape[0]} pairs")
    return torch.empty((rounds, counts.shape[0], CELLS), dtype=torch.int64,
                       device=counts.device)


def _mulhilo(a, b: int):
    """(hi, lo) 32-bit words of a * b for int64 tensors a < 2^32 and a
    constant b < 2^32, without passing 2^63."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Philox4x32-10 of int64 counter words (each < 2^32, broadcast
    together) under the key (k0, k1): four int64 word tensors."""
    x0, x1, x2, x3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, _M0)
        hi1, lo1 = _mulhilo(x2, _M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return x0, x1, x2, x3


def _u53(hi, lo):
    return ((hi << 21) | (lo >> 11)).double() * (1.0 / 9007199254740992.0)


def _stirling_tail(k):
    table = torch.tensor(_TAIL, dtype=torch.float64, device=k.device)
    kp1sq = (k + 1) * (k + 1)
    series = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    return torch.where(k <= 9, table[k.clamp(0, 9).long()], series)


def _inversion(n, p, words, tally):
    """Binomial(n, p) by inversion for the lanes given (mean below
    ``INV_MEAN``, p <= 1/2); ``words(attempt)`` draws the lanes' Philox
    words of an attempt."""
    nd = n.double()
    q = 1 - p
    qn = torch.exp(nd * torch.log1p(-p))
    np_ = nd * p
    bound = torch.fmin(nd, np_ + 10 * torch.sqrt(np_ * q + 1))
    x_out = torch.zeros_like(n)
    attempt = torch.zeros_like(n)
    pending = torch.ones_like(n, dtype=torch.bool)
    while bool(pending.any()):
        i = pending.nonzero().squeeze(1)
        w = words(i, attempt[i])
        tally["inv_attempts"] += i.numel()
        u = _u53(w[0], w[1])
        px, ni, pi, qi, bi = qn[i], n[i], p[i], q[i], bound[i]
        x = torch.zeros_like(ni)
        live = torch.ones_like(ni, dtype=torch.bool)
        restart = torch.zeros_like(live)
        while bool(live.any()):
            step = live & (u > px)
            x = torch.where(step, x + 1, x)
            tally["inv_steps"] += int(step.sum())
            over = step & (x.double() > bi)
            restart |= over
            cont = step & ~over
            u = torch.where(cont, u - px, u)
            px = torch.where(
                cont, (ni - x + 1).double() * pi * px / (x.double() * qi), px)
            live = cont
        done = i[~restart]
        x_out[done] = x[~restart]
        pending[done] = False
        attempt[i] += 1
    return x_out


def _btrs(n, p, words, tally):
    """Binomial(n, p) by BTRS for the lanes given (mean at least
    ``INV_MEAN``, p <= 1/2)."""
    nd = n.double()
    stddev = torch.sqrt(nd * p * (1 - p))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = nd * p + 0.5
    v_r = 0.92 - 4.2 / b
    r = p / (1 - p)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((nd + 1) * p)
    x_out = torch.zeros_like(n)
    attempt = torch.zeros_like(n)
    pending = torch.ones_like(n, dtype=torch.bool)
    while bool(pending.any()):
        i = pending.nonzero().squeeze(1)
        w = words(i, attempt[i])
        tally["btrs_attempts"] += i.numel()
        U = _u53(w[0], w[1]) - 0.5
        V = _u53(w[2], w[3])
        us = 0.5 - torch.abs(U)
        ai, bi, ndi, mi, ri = a[i], b[i], nd[i], m[i], r[i]
        k = torch.floor((2 * ai / us + bi) * U + c[i])
        ok = (k >= 0) & (k <= ndi)
        quick = ok & (us >= 0.07) & (V <= v_r[i])
        V = torch.log(V * alpha[i] / (ai / (us * us) + bi))
        upper = ((mi + 0.5) * torch.log((mi + 1) / (ri * (ndi - mi + 1)))
                 + (ndi + 1) * torch.log((ndi - mi + 1) / (ndi - k + 1))
                 + (k + 0.5) * torch.log(ri * (ndi - k + 1) / (k + 1))
                 + _stirling_tail(mi) + _stirling_tail(ndi - mi)
                 - _stirling_tail(k) - _stirling_tail(ndi - k))
        acc = quick | (ok & (V <= upper))
        done = i[acc]
        x_out[done] = k[acc].long()
        pending[done] = False
        attempt[i] += 1
    return x_out


def resample_plain(counts, rounds: int, seed: int, tally=None):
    """The resampler in torch ops, every (round, pair) in lock step, cell
    after cell: the kernel's draws.  ``tally``, when a dict, receives the
    sampler's work (inversion attempts and steps, BTRS attempts), which
    sets the kernel's operation bound."""
    out = _out(counts, rounds)
    device = counts.device
    pairs = counts.shape[0]
    key = seed & _MASK
    t = {"inv_attempts": 0, "inv_steps": 0, "btrs_attempts": 0}
    lane = torch.arange(rounds * pairs, dtype=torch.int64, device=device)
    rnd, pair = lane // pairs, lane % pairs
    src = counts[pair]  # [E, 16]
    n = src.sum(dim=1)
    mass = n.clone()
    for cell in range(CELLS - 1):
        cc = src[:, cell]
        x = torch.zeros_like(n)
        live = (n > 0) & (cc > 0)
        x = torch.where(live & (cc == mass), n, x)
        draw = (live & (cc != mass)).nonzero().squeeze(1)
        if draw.numel():
            p = cc[draw].double() / mass[draw].double()
            flip = p > 0.5
            pp = torch.where(flip, 1 - p, p)
            nn = n[draw]
            got = torch.zeros_like(nn)
            inv = nn.double() * pp < INV_MEAN
            for sel, sampler in ((inv, _inversion), (~inv, _btrs)):
                j = sel.nonzero().squeeze(1)
                if not j.numel():
                    continue
                lanes = draw[j]

                def words(i, attempt, lanes=lanes):
                    return philox(rnd[lanes[i]], pair[lanes[i]],
                                  torch.full_like(attempt, cell), attempt,
                                  key)

                got[j] = sampler(nn[j], pp[j], words, t)
            x[draw] = torch.where(flip, nn - got, got)
        out[:, :, cell] = x.reshape(rounds, pairs)
        n = n - x
        mass = mass - cc
    out[:, :, CELLS - 1] = n.reshape(rounds, pairs)
    if tally is not None:
        tally.update(t)
    return out
