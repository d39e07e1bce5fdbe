"""Subject tables and the flat chain walk (counterpart of
``andix/chain/replay_device.py``).

* ``prepare_subject_tables`` / ``single_subject_tables`` /
  ``group_subject_tables``: per subject, the matching statistics gathered
  into query-blob order — ``mlun`` packs the match length with the
  uniqueness flag (bit 30), ``ps`` is the subject position.  Rows stack
  into ``[Sg, QB]`` tables.
* ``chain_walk_flat``: the segmented schedule's resumable walk over a
  flat list of lanes, called by the host loop in ``chain.segmented`` (a
  copy of ``andix.chain.segmented``).  On CUDA tensors it launches the
  hand-written kernel (``csrc/chain_walk.cu``, one warp per lane, which
  compares the text bytes along the diagonal for lucky anchors); on CPU
  tensors it runs ``chain_walk_flat_plain``, the lock-step loop of the JAX
  version written in torch ops, which takes every LCE by ISA + range-min
  as the JAX version does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..esa import matchstats, rmq

UNIQ_BIT = 1 << 30


def prepare_subject_tables(ml_sa, un_sa, ps_sa, tq):
    """Blob-ordered (mlun, ps) rows from SA-order match statistics."""
    mlun_sa = ml_sa | torch.where(un_sa, UNIQ_BIT, 0).to(torch.int32)
    tq = tq.long()
    return mlun_sa[tq], ps_sa[tq]


def single_subject_tables(sa, lcp, segid, tq, subj_seg: int,
                          subj_start: int):
    ml, un, ps = matchstats.match_stats_device(sa, lcp, segid, subj_seg,
                                               subj_start)
    return prepare_subject_tables(ml, un, ps, tq)


def group_subject_tables(sa, lcp, segid, tq, subj_segs, subj_starts):
    """[Sg, QB] (mlun, ps) tables, built one subject at a time into the
    output rows (peak: one subject's [N] scan intermediates).  A padding
    row (segment -1) matches nothing: mlun 0, ps -1."""
    sg = len(subj_segs)
    qb = tq.shape[0]
    mlun = torch.zeros((sg, qb), dtype=torch.int32, device=sa.device)
    ps = torch.full((sg, qb), -1, dtype=torch.int32, device=sa.device)
    for k in range(sg):
        if int(subj_segs[k]) < 0:
            continue
        mlun[k], ps[k] = single_subject_tables(
            sa, lcp, segid, tq, int(subj_segs[k]), int(subj_starts[k])
        )
    return mlun, ps


LANE_FIELDS = ("row", "qoff", "qs", "ss", "rl", "thr", "seg_end",
               "pos0", "lq0", "ls0", "ll0")


def chain_walk_flat(isa, rm, text, mlun, ps, lanes: dict, max_iters: int,
                    max_events: int, ecap: int, chase: int, unroll: int):
    """Flat-lane resumable chain-walk chunk.

    ``text`` is the block text as uint8 [n] (``BlockContext.text``: the
    bytes of the joint text, 0 at every separator).  ``lanes`` maps each
    of ``LANE_FIELDS`` to an int32 [Lb] tensor (the lane's subject row,
    blob offset, text offsets, RS length, threshold, exclusive stop
    position and entry state).  Returns (ev_lane, ev_q,
    ev_s, ev_len — int32[ecap] valid up to ev_cnt, each lane's events in
    chain order; ev_cnt; ovf; iters; pos, lq, ls, ll, fin) with the JAX
    version's meaning (``andix/chain/replay_device.py:chain_walk_flat``);
    ev_cnt, ovf and iters are 0-d tensors."""
    if mlun.device.type == "cpu":
        return chain_walk_flat_plain(isa, rm, text, mlun, ps, lanes,
                                     max_iters, max_events, ecap, chase,
                                     unroll)
    return _chain_walk_flat_cuda(isa, rm, text, mlun, ps, lanes, max_iters,
                                 max_events, ecap, chase, unroll)


def fetch_walk(out):
    """Either walk's outputs -> the (ev [4, cnt] lane/q/s/len, state [4, Lb]
    pos/lq/ls/ll, fin, iters, ovf) tuple the segmented driver consumes:
    one readback of the exit state with (ev_cnt, ovf, iters) riding along,
    then the events (none after an overflow)."""
    (ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters,
     pos, lq, ls, ll, fin) = out
    lb = pos.shape[0]
    meta = torch.stack([x.to(pos.device, torch.int32)
                        for x in (ev_cnt, ovf, iters)])
    h = torch.cat([torch.stack([pos, lq, ls, ll, fin.to(torch.int32)])
                   .reshape(-1), meta]).cpu().numpy()
    state_h = h[: 5 * lb].reshape(5, lb)
    cnt, ovf_h, iters_h = (int(x) for x in h[5 * lb:])
    if ovf_h:
        return (np.zeros((4, 0), np.int32), state_h[:4],
                state_h[4].astype(bool), iters_h, True)
    ev = torch.stack([ev_lane[:cnt], ev_q[:cnt], ev_s[:cnt],
                      ev_len[:cnt]]).cpu().numpy()
    return ev, state_h[:4], state_h[4].astype(bool), iters_h, False


def _check(name, t, dtype, device, dim=1):
    if t.device != device:
        raise ValueError(f"chain_walk_flat: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"chain_walk_flat: {name} must be {dim}-D {dtype},"
                         f" got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"chain_walk_flat: {name} must be contiguous")


def _walk_args(isa, rm, text, mlun, ps, lanes, max_iters, max_events,
               ecap, chase, unroll, device):
    """Checked arguments and output buffers shared by the kernel and its
    host twin."""
    i32 = torch.int32
    lb = lanes["row"].shape[0]
    _check("text", text, torch.uint8, device)
    for name, t in (("isa", isa), ("rm.values", rm.values),
                    ("rm.pref8", rm.pref8), ("rm.suff8", rm.suff8),
                    ("rm.prefg", rm.prefg), ("rm.suffg", rm.suffg)):
        _check(name, t, i32, device)
    for name, t in (("rm.t8", rm.t8), ("rm.tg", rm.tg), ("mlun", mlun),
                    ("ps", ps)):
        _check(name, t, i32, device, dim=2)
    if ps.shape != mlun.shape:
        raise ValueError("chain_walk_flat: mlun and ps shapes differ")
    for name in LANE_FIELDS:
        _check(name, lanes[name], i32, device)
        if lanes[name].shape[0] != lb:
            raise ValueError(f"chain_walk_flat: {name} has "
                             f"{lanes[name].shape[0]} lanes, expected {lb}")
    ev = [torch.empty(max(ecap, 1), dtype=i32, device=device)
          for _ in range(4)]
    counters = torch.zeros(2, dtype=i32, device=device)
    state = [torch.empty(lb, dtype=i32, device=device) for _ in range(4)]
    fin = torch.empty(lb, dtype=torch.bool, device=device)
    args = (
        [isa.data_ptr(), text.data_ptr(), ctypes.c_int64(text.shape[0]),
         rm.values.data_ptr(), rm.pref8.data_ptr(),
         rm.suff8.data_ptr(), rm.t8.data_ptr(), rm.prefg.data_ptr(),
         rm.suffg.data_ptr(), rm.tg.data_ptr(),
         rm.t8.shape[1], rm.tg.shape[1], rm.tg.shape[0],
         mlun.data_ptr(), ps.data_ptr(), ctypes.c_int64(mlun.shape[1])]
        + [lanes[name].data_ptr() for name in LANE_FIELDS]
        + [lb, int(max_iters), int(max_events), int(ecap), int(chase),
           int(unroll)]
        + [e.data_ptr() for e in ev] + [counters.data_ptr()]
        + [s.data_ptr() for s in state] + [fin.data_ptr()]
    )
    return args, ev, counters, state, fin


def _walk_result(ev, counters, state, fin, ecap, unroll):
    ev_cnt = counters[0]
    return (ev[0][:ecap], ev[1][:ecap], ev[2][:ecap], ev[3][:ecap], ev_cnt,
            ev_cnt > ecap, counters[1] * unroll, *state, fin)


def _chain_walk_flat_cuda(isa, rm, text, mlun, ps, lanes, max_iters,
                          max_events, ecap, chase, unroll):
    device = mlun.device
    if device.type != "cuda":
        raise ValueError("chain_walk_flat: tables must be on a CUDA device")
    args, ev, counters, state, fin = _walk_args(
        isa, rm, text, mlun, ps, lanes, max_iters, max_events, ecap, chase,
        unroll, device,
    )
    # the row window loads 4 entries at once, 16-byte aligned
    if (mlun.shape[1] % 4 or mlun.data_ptr() % 16 or ps.data_ptr() % 16):
        raise ValueError("chain_walk_flat: mlun and ps must be 16-byte "
                         "aligned with a row length divisible by 4")
    lib = kernels.cuda_lib()
    with kernels.launch_on(device) as stream:
        err = lib.andix_chain_walk_flat(*args, stream)
    kernels.check(err, "chain_walk_flat")
    kernels.count_launch("chain_walk_flat", device)
    return _walk_result(ev, counters, state, fin, ecap, unroll)


def chain_walk_flat_cpu_twin(isa, rm, text, mlun, ps, lanes, max_iters,
                             max_events, ecap, chase, unroll,
                             tiny: bool = False):
    """The kernel's lane body (``walk_lane.cuh``) built for the host with
    g++, one thread per lane — for testing the kernel's logic without a
    card.  ``tiny`` runs it with tiny windows and event staging (4 row
    entries, 8 diagonal pairs, 3 events) instead of the kernel's."""
    args, ev, counters, state, fin = _walk_args(
        isa, rm, text, mlun, ps, lanes, max_iters, max_events, ecap, chase,
        unroll, torch.device("cpu"),
    )
    kernels.cpu_twin().andix_chain_walk_flat_cpu(*args, int(tiny))
    return _walk_result(ev, counters, state, fin, ecap, unroll)


def walk_lce_cpu_twin(isa, rm, text, a, b, tiny: bool = False):
    """The kernel's LCE of text suffix pairs (a[i], b[i]), taken in order
    through one lane's diagonal window (``WalkWindows::lce`` built for the
    host with g++), and the same by ISA + range-min (``walk_lce``): two
    int32 [len(a)] tensors.  ``tiny`` takes an 8-pair window instead of
    the kernel's."""
    cpu = torch.device("cpu")
    for name, t in (("isa", isa), ("rm.values", rm.values), ("a", a),
                    ("b", b)):
        _check(name, t, torch.int32, cpu)
    _check("text", text, torch.uint8, cpu)
    if a.shape != b.shape:
        raise ValueError("walk_lce_cpu_twin: a and b shapes differ")
    win, ref = torch.empty_like(a), torch.empty_like(a)
    kernels.cpu_twin().andix_walk_lce_cpu(
        isa.data_ptr(), text.data_ptr(), ctypes.c_int64(text.shape[0]),
        rm.values.data_ptr(), rm.pref8.data_ptr(), rm.suff8.data_ptr(),
        rm.t8.data_ptr(), rm.prefg.data_ptr(), rm.suffg.data_ptr(),
        rm.tg.data_ptr(), rm.t8.shape[1], rm.tg.shape[1], rm.tg.shape[0],
        a.shape[0], a.data_ptr(), b.data_ptr(), win.data_ptr(),
        ref.data_ptr(), int(tiny))
    return win, ref


def chain_walk_flat_plain(isa, rm, text, mlun, ps, lanes, max_iters,
                          max_events, ecap, chase, unroll, counts=None,
                          diag_win=None):
    """Lock-step loop over all lanes in torch ops — the JAX version's
    iteration structure, with its scalar gates as ``any()`` tests.  Every
    LCE is taken by ISA + range-min; ``text`` is not read.

    ``counts``, when a dict, receives what the walk's data needs, each
    table entry counted once (a lane's positions only rise): in-range
    ``probes``; ``hops`` (mlun entries the jump chain reads);
    ``table_probes`` (mlun entries read at a probe without a lucky anchor
    that the chain had not read); ``table_anchors`` (anchors taken from
    the table, the only probes that need ps); ``lucky_checks``;
    ``lucky_bytes`` (per check the fewer of 2 * (LCE + 1) text bytes and
    16 B of ISA and range-min entries); ``events``; and, given the
    kernel's diagonal window ``diag_win``, ``rm_fallbacks`` (lucky checks
    whose LCE reaches it, which the kernel finishes by ISA +
    range-min)."""
    device = mlun.device
    i64 = torch.int64
    row = lanes["row"].to(i64)
    qoff = lanes["qoff"].to(i64)
    qs, ss, rl, thr, seg_end = (lanes[n] for n in
                                ("qs", "ss", "rl", "thr", "seg_end"))
    pos, lq, ls, ll = (lanes[n].clone() for n in ("pos0", "lq0", "ls0",
                                                  "ll0"))
    lb = row.shape[0]
    lane_iota = torch.arange(lb, dtype=torch.int32, device=device)
    zero = torch.zeros(lb, dtype=torch.int32, device=device)
    evn = zero.clone()
    fin = (pos >= seg_end) | (max_events <= 0)
    last_read = torch.full_like(pos, -1)  # the lane's last mlun entry read

    def hop(p):
        v = mlun[row, qoff + p.to(i64)]
        ml = v & (UNIQ_BIT - 1)
        cand = ((v & UNIQ_BIT) != 0) & (ml >= thr)
        return torch.where(cand, p, p + ml + 1)

    def lce(a_text, b_text):
        t1 = isa[a_text.to(i64)]
        t2 = isa[b_text.to(i64)]
        return rmq.range_min(rm, torch.minimum(t1, t2) + 1,
                             torch.maximum(t1, t2)).to(torch.int32)

    def tally_reads(key, read, p):
        nonlocal last_read
        new = read & (p != last_read)
        tally[key] += new.sum()
        last_read = torch.where(read, p, last_read)

    events = []  # (lane, q, s, len) per step, step-major
    tally = {k: torch.zeros((), dtype=torch.int64, device=device)
             for k in ("probes", "hops", "table_probes", "table_anchors",
                       "lucky_checks", "rm_fallbacks", "lucky_bytes")}
    it = 0
    while it < max_iters and not bool(fin.all()):
        for _ in range(unroll):
            probe = ~fin
            took = probe & (pos - lq - ll > thr)
            pos_qj = pos
            if bool(took.any()):
                pos_qj = torch.where(took, hop(torch.where(probe, pos, 0)),
                                     pos)
                if counts is not None:
                    tally_reads("hops", took, pos)
                for _ in range(chase):
                    can = took & (pos_qj < seg_end)
                    nxt = hop(torch.where(can, pos_qj, 0))
                    if counts is not None:
                        tally_reads("hops", can, pos_qj)
                    pos_qj = torch.where(can & (nxt != pos_qj), nxt, pos_qj)
            in_range = probe & (pos_qj < seg_end)
            safe = torch.where(in_range, pos_qj, 0)
            probe_c = qoff + safe.to(i64)
            advance = pos_qj - lq
            gap = advance - ll
            try_s = ls + advance
            lucky_pre = in_range & (try_s < rl) & (gap >= 0) & (gap <= thr)
            lucky_len = zero
            if bool(lucky_pre.any()):
                lucky_len = torch.where(
                    lucky_pre,
                    lce(qs + safe, ss + torch.where(lucky_pre, try_s, 0)),
                    0,
                )
            lucky_found = lucky_pre & (lucky_len >= thr)
            v = mlun[row, probe_c]
            aml = v & (UNIQ_BIT - 1)
            aun = (v & UNIQ_BIT) != 0
            found = in_range & (lucky_found | (aun & (aml >= thr)))
            if counts is not None:
                tally["probes"] += in_range.sum()
                tally_reads("table_probes", in_range & ~lucky_found, pos_qj)
                tally["table_anchors"] += (found & ~lucky_found).sum()
                tally["lucky_checks"] += lucky_pre.sum()
                if diag_win is not None:
                    tally["rm_fallbacks"] += (lucky_pre
                                              & (lucky_len >= diag_win)).sum()
                tally["lucky_bytes"] += torch.where(
                    lucky_pre, torch.clamp(2 * (lucky_len.long() + 1),
                                           max=16), 0).sum()
            this_len = torch.where(lucky_found, lucky_len, aml)
            this_s = torch.where(lucky_found, try_s, ps[row, probe_c])
            if bool(found.any()):
                events.append(torch.stack([lane_iota[found], pos_qj[found],
                                           this_s[found], this_len[found]]))
            lq = torch.where(found, pos_qj, lq)
            ls = torch.where(found, this_s, ls)
            ll = torch.where(found, this_len, ll)
            pos = torch.where(
                probe, torch.where(in_range, pos_qj + this_len + 1, pos_qj),
                pos,
            )
            evn = evn + found.to(torch.int32)
            fin = fin | (probe & ((pos >= seg_end) | (evn >= max_events)))
        it += 1

    ev = (torch.cat(events, dim=1) if events
          else torch.zeros((4, 0), dtype=torch.int32, device=device))
    cnt = ev.shape[1]
    if counts is not None:
        if diag_win is None:
            del tally["rm_fallbacks"]
        counts.update({k: int(v) for k, v in tally.items()}, events=cnt)
    buf = torch.zeros((4, ecap), dtype=torch.int32, device=device)
    keep = min(cnt, ecap)
    buf[:, :keep] = ev[:, :keep]
    ev_cnt = torch.tensor(cnt, dtype=torch.int32)
    return (buf[0], buf[1], buf[2], buf[3], ev_cnt, ev_cnt > ecap,
            torch.tensor(it * unroll, dtype=torch.int32), pos, lq, ls, ll,
            fin)
