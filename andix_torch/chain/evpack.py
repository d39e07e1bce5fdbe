"""Packed anchor-event fetch (counterpart of ``andix/chain/evpack.py``).

The subject-index schedule's walk leaves its events in four int32
buffers (lane, q, s, len), 16 B an event.  ``encode_events`` packs the
first ``k`` slots on the device at about 6 B an event: a stable sort by
lane (as ``andix`` sorts with ``jnp.sort``), then

* ``counts``  int32[n_lanes] events per lane (replaces the lane array),
* ``packed``  int32[3, ceil(k / 2)]: (dq, ddiag, len) 16-bit fields, two
  events an int32; dq = q - the previous q of the lane (the lane's first:
  q), ddiag = (s - q) - the previous diagonal, biased by ``BIAS``,
* ``esc``     int32[4, esc_cap]: exact (sorted index, dq, ddiag, len)
  records, at ascending sorted index, for events a field of which does
  not fit 16 bits (at least each lane's first event whose q is 65,535 or
  more), esc_cap = max(4096, 2 * n_lanes),
* ``n_esc`` and ``esc_ovf`` (n_esc > esc_cap: the caller fetches raw).

``decode_events`` rebuilds the (lane, q, s, len) stream in lane-major
chain order on the host, exactly (``andix``'s decode, copied).

Three routes, like every kernel of the port: on a CUDA tensor the
hand-written kernels (``csrc/evpack.cu``: a key pass, CUB's radix sort of
the lane bits, one encode pass with a decoupled look-back for the escape
slots); their g++ twin (``encode_events_cpu_twin``, the same bodies,
``evpack_lane.cuh``, tiles in a shuffled order); and
``encode_events_plain``, ``andix``'s ``_encode_fn`` in torch ops, which a
CPU tensor takes.  Live lanes must lie in [0, n_lanes), as the walk
writes them.

Deliberate differences from ``andix``: an odd ``k`` (an odd
``ANDIX_EVENT_CAP``) pads the pairing by one slot, where ``andix``'s
``pair()`` fails; a slot past ``cnt`` encodes as an all-zero event after
its lane's end, (0, BIAS, 0), whatever the buffer holds there (``andix``'s
buffers are zero-filled, so its padding is the same).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

BIAS = 1 << 15


def esc_capacity(n_lanes: int) -> int:
    return max(4096, 2 * n_lanes)


def encoded_size(k: int, n_lanes: int) -> int:
    """int32 words of one encoding: packed, esc, counts, n_esc, esc_ovf."""
    return 3 * ((k + 1) // 2) + 4 * esc_capacity(n_lanes) + n_lanes + 2


def split_encoded(flat, k: int, n_lanes: int):
    """(packed [3, ceil(k / 2)], esc [4, esc_cap], counts [n_lanes], n_esc,
    esc_ovf) as views of one encoding (a tensor or a numpy array; the two
    scalars are 0-d views)."""
    kh, cap = (k + 1) // 2, esc_capacity(n_lanes)
    packed = flat[: 3 * kh].reshape(3, kh)
    esc = flat[3 * kh: 3 * kh + 4 * cap].reshape(4, cap)
    counts = flat[3 * kh + 4 * cap: 3 * kh + 4 * cap + n_lanes]
    return packed, esc, counts, flat[-2], flat[-1] != 0


def encode_events(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k: int,
                  n_lanes: int):
    """The device pack of the first ``k`` slots (``cnt = ev_cnt`` of them
    live, ``cnt <= k``): (packed, esc, counts, n_esc, esc_ovf), views of
    ``encode_events_flat``'s one buffer."""
    return split_encoded(
        encode_events_flat(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes),
        k, n_lanes)


def encode_events_flat(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k: int,
                       n_lanes: int):
    """One int32 [encoded_size] buffer holding the encoding, so that one
    copy fetches it.  A CPU tensor takes ``encode_events_plain``; a CUDA
    tensor launches the kernel."""
    if ev_lane.device.type == "cpu":
        return encode_events_plain(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k,
                                   n_lanes)
    if ev_lane.device.type != "cuda":
        raise ValueError(f"encode_events: events on {ev_lane.device}")
    return _encode_cuda(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes)


def _args(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes, device):
    """Checked arguments shared by the kernels and their host twin, and
    the output buffer."""
    cnt = int(ev_cnt)
    if not 0 <= cnt <= k or k < 1:
        raise ValueError(f"encode_events: cnt {cnt} outside [0, k = {k}]")
    for name, t in (("ev_lane", ev_lane), ("ev_q", ev_q), ("ev_s", ev_s),
                    ("ev_len", ev_len)):
        if (t.device != device or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous() or t.shape[0] < k):
            raise ValueError(f"encode_events: {name} must be a contiguous "
                             f"1-D int32 tensor of at least {k} slots on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty(encoded_size(k, n_lanes), dtype=torch.int32,
                      device=device)
    args = [ev_lane.data_ptr(), ev_q.data_ptr(), ev_s.data_ptr(),
            ev_len.data_ptr(), ctypes.c_int64(cnt), ctypes.c_int64(k),
            n_lanes, esc_capacity(n_lanes), out.data_ptr()]
    return args, out


def _encode_cuda(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes):
    device = ev_lane.device
    args, out = _args(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes,
                      device)
    lib = kernels.cuda_lib()
    nbytes = lib.andix_evpack_scratch_bytes(k, n_lanes)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    with kernels.launch_on(device) as stream:
        err = lib.andix_evpack_encode(*args, scratch.data_ptr(), nbytes,
                                      stream)
    kernels.check(err, "evpack_encode")
    kernels.count_launch("evpack_encode", device)
    return out


def encode_events_cpu_twin(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k: int,
                           n_lanes: int, tiny: bool = False, seed: int = 0):
    """The kernels' passes (``evpack_lane.cuh``) built for the host with
    g++: the key pass, a stable sort, and the encode pass with its tiles
    in an order shuffled by ``seed`` against the look-back — for testing
    the kernels' logic without a card.  ``tiny`` takes tiles of 4 pairs
    instead of the kernel's."""
    args, out = _args(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k, n_lanes,
                      torch.device("cpu"))
    err = kernels.cpu_twin().andix_evpack_encode_cpu(*args, int(tiny), seed)
    if err:
        raise RuntimeError("evpack twin: a look-back met a tile that had "
                           "not published")
    return out


def _int32(x):
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def encode_events_plain(ev_lane, ev_q, ev_s, ev_len, ev_cnt, k: int,
                        n_lanes: int):
    """``andix``'s ``_encode_fn`` (evpack.py:42-100) in torch ops, line for
    line, on the four int32 buffers; the same one-buffer layout as the
    kernel's."""
    device = ev_lane.device
    esc_cap = esc_capacity(n_lanes)
    cnt = int(ev_cnt)
    lane = ev_lane[:k].long()
    ln = ev_len[:k].long()
    q = ev_q[:k].long()
    s = ev_s[:k].long()
    idx = torch.arange(k, dtype=torch.int64, device=device)
    live = idx < cnt
    lane_l = torch.where(live, lane, n_lanes)
    # stable sort by lane: composite key keeps buffer order per lane
    key = (lane_l << 32) | idx
    order = torch.sort(key).values & 0xFFFFFFFF
    lane_s = lane_l[order]
    q_s = q[order]
    s_s = s[order]
    ln_s = ln[order]
    diag = s_s - q_s
    one = torch.ones(1, dtype=torch.int64, device=device)
    prev_lane = torch.cat([-one, lane_s[:-1]])
    first = lane_s != prev_lane
    prev_q = torch.cat([0 * one, q_s[:-1]])
    prev_d = torch.cat([0 * one, diag[:-1]])
    dq = q_s - torch.where(first, 0, prev_q)
    dd = diag - torch.where(first, 0, prev_d)
    live_s = lane_s < n_lanes
    esc = (
        (dq < 0) | (dq > 0xFFFF - 1)
        | (dd < -BIAS) | (dd >= BIAS)
        | (ln_s < 0) | (ln_s > 0xFFFF)
    ) & live_s
    dq16 = torch.where(esc, 0xFFFF, dq)
    dd16 = torch.where(esc, 0, dd + BIAS)
    ln16 = torch.where(esc, 0, ln_s)
    # a dead slot, and the slot past an odd k: an all-zero event's fields
    kh = (k + 1) // 2
    pad = torch.zeros(2 * kh - k, dtype=torch.bool, device=device)
    fields = []
    for x, dead in ((dq16, 0), (dd16, BIAS), (ln16, 0)):
        x = torch.where(torch.cat([live_s, pad]),
                        torch.cat([x, 0 * pad.long()]), dead)
        fields.append(_int32(x[0::2] | (x[1::2] << 16)))
    packed = torch.stack(fields)
    # compact escape records
    e32 = esc.long()
    slot = torch.where(esc, torch.cumsum(e32, 0) - e32, esc_cap)
    esc_rec = torch.zeros((4, esc_cap + 1), dtype=torch.int64,
                          device=device)
    keep = slot <= esc_cap
    esc_rec[:, slot[keep]] = torch.stack([idx, dq, dd, ln_s])[:, keep]
    n_esc = int(e32.sum())
    counts = torch.zeros(n_lanes + 1, dtype=torch.int64, device=device)
    counts.index_add_(0, lane_s, torch.ones_like(lane_s))
    tail = torch.tensor([n_esc, int(n_esc > esc_cap)], dtype=torch.int64,
                        device=device)
    return torch.cat([packed.reshape(-1),
                      _int32(esc_rec[:, :esc_cap]).reshape(-1),
                      counts[:n_lanes].to(torch.int32),
                      tail.to(torch.int32)])


def decode_events(packed, esc, counts, n_esc, cnt):
    """Host-side exact reconstruction -> (lane, q, s, len) int32[cnt] in
    per-lane chain order (lane-major)."""
    packed = np.asarray(packed).view(np.uint32)
    esc = np.asarray(esc)
    counts = np.asarray(counts, dtype=np.int64)

    def unpair(x):
        out = np.empty(2 * len(x), np.int32)
        out[0::2] = (x & 0xFFFF).astype(np.int32)
        out[1::2] = (x >> 16).astype(np.int32)
        return out

    dq = unpair(packed[0])[:cnt]
    dd = unpair(packed[1])[:cnt] - BIAS
    ln = unpair(packed[2])[:cnt]
    if n_esc:
        ei = esc[0, :n_esc]
        keep = ei < cnt
        ei = ei[keep]
        dq[ei] = esc[1, :n_esc][keep]
        dd[ei] = esc[2, :n_esc][keep]
        ln[ei] = esc[3, :n_esc][keep]
    lanes = np.repeat(
        np.arange(len(counts), dtype=np.int32), counts
    )[:cnt].astype(np.int32)
    # segmented cumsum over lane runs
    ends = np.cumsum(counts)
    starts = ends - counts
    starts = starts[counts > 0]
    tot_q = np.cumsum(dq, dtype=np.int64)
    tot_d = np.cumsum(dd, dtype=np.int64)
    off_q = np.zeros(cnt, dtype=np.int64)
    off_d = np.zeros(cnt, dtype=np.int64)
    s0 = starts[starts < cnt]
    nz = s0[s0 > 0]
    off_q[nz] = tot_q[nz - 1]
    off_d[nz] = tot_d[nz - 1]
    off_q = _runfill(off_q, s0, cnt)
    off_d = _runfill(off_d, s0, cnt)
    q = (tot_q - off_q).astype(np.int32)
    d = (tot_d - off_d).astype(np.int32)
    return lanes, q, (q + d).astype(np.int32), ln


def _runfill(off, starts, cnt):
    """Propagate per-run offsets forward (offsets set at run starts)."""
    if cnt == 0:
        return off
    mark = np.zeros(cnt, dtype=np.int64)
    mark[starts] = 1
    run_id = np.cumsum(mark) - 1
    per_run = off[starts]
    return per_run[run_id]
