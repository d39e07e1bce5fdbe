"""Subject tables and the flat chain walk (counterpart of
``andix/chain/replay_device.py``).

* ``prepare_subject_tables`` / ``single_subject_tables`` /
  ``group_subject_tables``: per subject, the matching statistics gathered
  into query-blob order — ``mlun`` packs the match length with the
  uniqueness flag (bit 30), ``ps`` is the subject position.  Rows stack
  into ``[Sg, QB]`` tables.
* ``chain_walk_flat``: the segmented schedule's resumable walk over a
  flat list of lanes, called by the segmented walk driver
  (``chain.segdrive``) and, one lane a (subject, query)
  pair walked to its end into one event buffer, by
  ``chain_anchors_device`` (``andix``'s unsegmented events walk).  On
  CUDA tensors it launches the
  hand-written kernel (``csrc/chain_walk.cu``, one warp per lane, which
  compares the text bytes along the diagonal for lucky anchors); on CPU
  tensors it runs ``chain_walk_flat_plain``, the lock-step loop of the JAX
  version written in torch ops, which takes every LCE by ISA + range-min
  as the JAX version does.
* ``replay_rows``: ``andix``'s count-in-loop replay (``replay_rows_device``)
  of a subject group, every (subject, query) lane walked with the same
  probe step, counting the 16 substitution cells on the device (kernels
  ``csrc/replay.cu``: query segments walked at once and spliced exactly
  on the card; ``replay_rows_plain``, unsegmented, on the CPU).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels, spans
from ..esa import matchstats, rmq
from . import segdrive

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


def fetch_walk(out, events=None):
    """Either walk's outputs -> the (ev [4, cnt] lane/q/s/len, state [4, Lb]
    pos/lq/ls/ll, fin, iters, ovf) tuple the segmented driver consumes:
    one readback of the exit state with (ev_cnt, ovf, iters) riding along,
    then the events (none after an overflow): ``events(ev4, cnt, lb)``
    when given (the four buffers, the event count, the lane count; it
    returns the [4, cnt] array), else the first ``cnt`` of each buffer as
    they are.  Counts ``walk.probe_steps`` and ``walk.events`` on the open
    span (the driver's ``walk.dispatch``)."""
    (ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters,
     pos, lq, ls, ll, fin) = out
    lb = pos.shape[0]
    meta = torch.stack([x.to(pos.device, torch.int32)
                        for x in (ev_cnt, ovf, iters)])
    h = spans.readback(torch.cat([
        torch.stack([pos, lq, ls, ll, fin.to(torch.int32)]).reshape(-1),
        meta])).numpy()
    state_h = h[: 5 * lb].reshape(5, lb)
    cnt, ovf_h, iters_h = (int(x) for x in h[5 * lb:])
    spans.count("walk.probe_steps", iters_h)
    if ovf_h:
        return (np.zeros((4, 0), np.int32), state_h[:4],
                state_h[4].astype(bool), iters_h, True)
    ev4 = (ev_lane, ev_q, ev_s, ev_len)
    if events is not None:
        ev = events(ev4, cnt, lb)
    else:
        ev = spans.readback(torch.stack([x[:cnt] for x in ev4])).numpy()
    spans.count("walk.events", cnt)
    return ev, state_h[:4], state_h[4].astype(bool), iters_h, False


def _check(who, name, t, dtype, device, dim=1):
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{who}: {name} must be {dim}-D {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _table_args(who, isa, rm, text, mlun, ps, device) -> list:
    """The text, ISA, range-min and row tables the walk kernels read,
    checked (errors name the wrapper ``who``), as the leading arguments
    of their C entries."""
    i32 = torch.int32
    _check(who, "text", text, torch.uint8, device)
    for name, t in (("isa", isa), ("rm.values", rm.values),
                    ("rm.pref8", rm.pref8), ("rm.suff8", rm.suff8),
                    ("rm.prefg", rm.prefg), ("rm.suffg", rm.suffg)):
        _check(who, name, t, i32, device)
    for name, t in (("rm.t8", rm.t8), ("rm.tg", rm.tg), ("mlun", mlun),
                    ("ps", ps)):
        _check(who, name, t, i32, device, dim=2)
    if ps.shape != mlun.shape:
        raise ValueError(f"{who}: mlun and ps shapes differ")
    return [isa.data_ptr(), text.data_ptr(), ctypes.c_int64(text.shape[0]),
            rm.values.data_ptr(), rm.pref8.data_ptr(), rm.suff8.data_ptr(),
            rm.t8.data_ptr(), rm.prefg.data_ptr(), rm.suffg.data_ptr(),
            rm.tg.data_ptr(), rm.t8.shape[1], rm.tg.shape[1],
            rm.tg.shape[0], mlun.data_ptr(), ps.data_ptr(),
            ctypes.c_int64(mlun.shape[1])]


def _check_row_window(who, mlun, ps):
    # the row window loads 4 entries at once, 16-byte aligned
    if (mlun.shape[1] % 4 or mlun.data_ptr() % 16 or ps.data_ptr() % 16):
        raise ValueError(f"{who}: mlun and ps must be 16-byte aligned with "
                         "a row length divisible by 4")


def _walk_args(isa, rm, text, mlun, ps, lanes, max_iters, max_events,
               ecap, chase, unroll, device):
    """Checked arguments and output buffers shared by the kernel and its
    host twin."""
    i32 = torch.int32
    lb = lanes["row"].shape[0]
    tables = _table_args("chain_walk_flat", isa, rm, text, mlun, ps, device)
    for name in LANE_FIELDS:
        _check("chain_walk_flat", name, lanes[name], i32, device)
        if lanes[name].shape[0] != lb:
            raise ValueError(f"chain_walk_flat: {name} has "
                             f"{lanes[name].shape[0]} lanes, expected {lb}")
    ev = [torch.empty(max(ecap, 1), dtype=i32, device=device)
          for _ in range(4)]
    counters = torch.zeros(2, dtype=i32, device=device)
    state = [torch.empty(lb, dtype=i32, device=device) for _ in range(4)]
    fin = torch.empty(lb, dtype=torch.bool, device=device)
    args = (
        tables + [lanes[name].data_ptr() for name in LANE_FIELDS]
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
    _check_row_window("chain_walk_flat", mlun, ps)
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
        _check("walk_lce_cpu_twin", name, t, torch.int32, cpu)
    _check("walk_lce_cpu_twin", "text", text, torch.uint8, cpu)
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


class _LockStep:
    """The plain walks' probe step over all lanes in lock-step, in torch
    ops (the JAX loops' body, with their scalar gates as ``any()`` tests,
    or, with ``gates`` false, both sides of each gate computed, which
    reads nothing back to the host):
    every lane in ``probe`` whose gap to its last anchor exceeds its
    threshold hops the pure chain (one hop plus ``chase`` more, derived
    from mlun, stopping at ``stop``); below ``stop`` the position is
    probed, the lucky check by ISA + range-min, else the table entry.

    ``counts``, when a dict, makes it tally what the walk's data needs,
    each table entry counted once (a lane's positions only rise): in-range
    ``probes``; ``hops`` (mlun entries the jump chain reads);
    ``table_probes`` (mlun entries read at a probe without a lucky anchor
    that the chain had not read); ``table_anchors`` (anchors taken from
    the table, the only probes that need ps); ``lucky_checks``;
    ``lucky_bytes`` (per check the fewer of 2 * (LCE + 1) text bytes and
    16 B of ISA and range-min entries); and, given the kernel's diagonal
    window ``diag_win``, ``rm_fallbacks`` (lucky checks whose LCE reaches
    it, which the kernel finishes by ISA + range-min)."""

    def __init__(self, isa, rm, mlun, ps, row, qoff, qs, ss, rl, thr, stop,
                 chase, counts=None, diag_win=None, gates=True):
        self.gates = gates
        self.isa, self.rm, self.mlun, self.ps = isa, rm, mlun, ps
        self.row, self.qoff = row.to(torch.int64), qoff.to(torch.int64)
        self.qs, self.ss, self.rl, self.thr = qs, ss, rl, thr
        self.stop, self.chase, self.diag_win = stop, chase, diag_win
        self.zero = torch.zeros_like(qs)
        self.last_read = torch.full_like(qs, -1)  # last mlun entry read
        self.tally = None
        if counts is not None:
            self.tally = {k: torch.zeros((), dtype=torch.int64,
                                         device=qs.device)
                          for k in ("probes", "hops", "table_probes",
                                    "table_anchors", "lucky_checks",
                                    "rm_fallbacks", "lucky_bytes")}
            if diag_win is None:
                del self.tally["rm_fallbacks"]

    def _hop(self, p):
        v = self.mlun[self.row, self.qoff + p.to(torch.int64)]
        ml = v & (UNIQ_BIT - 1)
        cand = ((v & UNIQ_BIT) != 0) & (ml >= self.thr)
        return torch.where(cand, p, p + ml + 1)

    def _lce(self, a_text, b_text):
        t1 = self.isa[a_text.to(torch.int64)]
        t2 = self.isa[b_text.to(torch.int64)]
        return rmq.range_min(self.rm, torch.minimum(t1, t2) + 1,
                             torch.maximum(t1, t2)).to(torch.int32)

    def _reads(self, key, read, p):
        if self.tally is not None:
            self.tally[key] += (read & (p != self.last_read)).sum()
            self.last_read.copy_(torch.where(read, p, self.last_read))

    def __call__(self, pos, lq, ls, ll, probe):
        """(pos_qj, in_range, found, this_s, this_len) of one probe step;
        lanes outside ``probe`` or at or past ``stop`` find nothing."""
        thr = self.thr
        took = probe & (pos - lq - ll > thr)
        pos_qj = pos
        if not self.gates or bool(took.any()):
            pos_qj = torch.where(took, self._hop(torch.where(probe, pos, 0)),
                                 pos)
            self._reads("hops", took, pos)
            for _ in range(self.chase):
                can = took & (pos_qj < self.stop)
                nxt = self._hop(torch.where(can, pos_qj, 0))
                self._reads("hops", can, pos_qj)
                pos_qj = torch.where(can & (nxt != pos_qj), nxt, pos_qj)
        in_range = probe & (pos_qj < self.stop)
        safe = torch.where(in_range, pos_qj, 0)
        probe_c = self.qoff + safe.to(torch.int64)
        advance = pos_qj - lq
        gap = advance - ll
        try_s = ls + advance
        lucky_pre = in_range & (try_s < self.rl) & (gap >= 0) & (gap <= thr)
        lucky_len = self.zero
        if not self.gates or bool(lucky_pre.any()):
            lucky_len = torch.where(
                lucky_pre,
                self._lce(self.qs + safe,
                          self.ss + torch.where(lucky_pre, try_s, 0)),
                0,
            )
        lucky_found = lucky_pre & (lucky_len >= thr)
        v = self.mlun[self.row, probe_c]
        aml = v & (UNIQ_BIT - 1)
        aun = (v & UNIQ_BIT) != 0
        found = in_range & (lucky_found | (aun & (aml >= thr)))
        t = self.tally
        if t is not None:
            t["probes"] += in_range.sum()
            self._reads("table_probes", in_range & ~lucky_found, pos_qj)
            t["table_anchors"] += (found & ~lucky_found).sum()
            t["lucky_checks"] += lucky_pre.sum()
            if self.diag_win is not None:
                t["rm_fallbacks"] += (lucky_pre
                                      & (lucky_len >= self.diag_win)).sum()
            t["lucky_bytes"] += torch.where(
                lucky_pre, torch.clamp(2 * (lucky_len.long() + 1), max=16),
                0).sum()
        this_len = torch.where(lucky_found, lucky_len, aml)
        this_s = torch.where(lucky_found, try_s, self.ps[self.row, probe_c])
        return pos_qj, in_range, found, this_s, this_len

    def totals(self) -> dict:
        return {k: int(v) for k, v in self.tally.items()}


def chain_walk_flat_plain(isa, rm, text, mlun, ps, lanes, max_iters,
                          max_events, ecap, chase, unroll, counts=None,
                          diag_win=None):
    """Lock-step loop over all lanes in torch ops — the JAX version's
    iteration structure (``_LockStep``).  Every LCE is taken by ISA +
    range-min; ``text`` is not read.  ``counts``, when a dict, receives
    ``_LockStep``'s tallies and the ``events`` found."""
    device = mlun.device
    qs, ss, rl, thr, seg_end = (lanes[n] for n in
                                ("qs", "ss", "rl", "thr", "seg_end"))
    pos, lq, ls, ll = (lanes[n].clone() for n in ("pos0", "lq0", "ls0",
                                                  "ll0"))
    lb = pos.shape[0]
    lane_iota = torch.arange(lb, dtype=torch.int32, device=device)
    evn = torch.zeros(lb, dtype=torch.int32, device=device)
    fin = (pos >= seg_end) | (max_events <= 0)
    step = _LockStep(isa, rm, mlun, ps, lanes["row"], lanes["qoff"], qs, ss,
                     rl, thr, seg_end, chase, counts, diag_win)

    events = []  # (lane, q, s, len) per step, step-major
    it = 0
    while it < max_iters and not bool(fin.all()):
        for _ in range(unroll):
            probe = ~fin
            pos_qj, in_range, found, this_s, this_len = step(pos, lq, ls,
                                                             ll, probe)
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
        counts.update(step.totals(), events=cnt)
    buf = torch.zeros((4, ecap), dtype=torch.int32, device=device)
    keep = min(cnt, ecap)
    buf[:, :keep] = ev[:, :keep]
    ev_cnt = torch.tensor(cnt, dtype=torch.int32)
    return (buf[0], buf[1], buf[2], buf[3], ev_cnt, ev_cnt > ecap,
            torch.tensor(it * unroll, dtype=torch.int32), pos, lq, ls, ll,
            fin)


# no iteration or per-lane event cap: a walk runs every lane to its end
UNCAPPED = (1 << 31) - 1


def anchor_lanes(subj_start, rs_len, threshold, q_base, q_start, q_len2d,
                 device) -> dict:
    """``chain_walk_flat``'s lanes for a group's unsegmented walk: lane
    ``s * G + g`` is subject row s against query g, from the query's start
    (entry state 0) to its end.  ``subj_start``, ``rs_len`` and
    ``threshold`` are per subject row [Sg], ``q_base`` and ``q_start``
    per query [G], ``q_len2d`` [Sg, G] (0 disables a lane); numpy arrays
    or int32 tensors."""

    def dev(x):
        if not isinstance(x, torch.Tensor):
            x = spans.upload(np.ascontiguousarray(x, dtype=np.int32), device)
        return x.to(device, torch.int32)

    q_len2d = dev(q_len2d)
    sg, g = q_len2d.shape
    per_row = [dev(x).reshape(sg, 1).expand(sg, g)
               for x in (subj_start, rs_len, threshold)]
    per_query = [dev(x).reshape(1, g).expand(sg, g) for x in (q_base,
                                                             q_start)]
    rows = torch.arange(sg, dtype=torch.int32, device=device)
    zero = torch.zeros(sg * g, dtype=torch.int32, device=device)
    vals = ([rows.reshape(sg, 1).expand(sg, g)] + per_query + per_row
            + [q_len2d])
    lanes = {name: v.reshape(-1).contiguous()
             for name, v in zip(LANE_FIELDS[:7], vals)}
    lanes.update({name: zero for name in LANE_FIELDS[7:]})
    return lanes


def chain_anchors_device(isa, rm, text, mlun, ps, subj_start, rs_len,
                         threshold, q_base, q_start, q_len2d, ecap: int,
                         chase: int = 4, unroll: int = 4):
    """The unsegmented anchor-event walk of a subject group (``andix``'s
    ``chain_anchors_device``): every (subject, query) lane of
    ``anchor_lanes`` walked to its end in one ``chain_walk_flat``
    dispatch with no iteration cap, every event into one buffer of
    ``ecap`` slots.  Returns (ev_lane, ev_q, ev_s, ev_len — int32[ecap]
    valid up to ev_cnt, each lane's events in chain order; ev_cnt; ovf =
    ev_cnt > ecap over the whole walk; iterations, the walk's own)."""
    lanes = anchor_lanes(subj_start, rs_len, threshold, q_base, q_start,
                         q_len2d, mlun.device)
    out = chain_walk_flat(isa, rm, text, mlun, ps, lanes, UNCAPPED,
                          UNCAPPED, ecap, chase, unroll)
    return out[:7]


def subject_group_anchors_device(sa, lcp, segid, tq, isa, rm, text,
                                 subj_segs, subj_starts, rs_lens,
                                 thresholds, q_base, q_start, q_len2d,
                                 ecap: int, chase: int = 4, unroll: int = 4):
    """A group's ``[Sg, QB]`` subject tables, then its unsegmented
    anchor-event walk (``andix``'s ``subject_group_anchors_device``); the
    same tuple as ``chain_anchors_device``."""
    mlun, ps = group_subject_tables(sa, lcp, segid, tq, subj_segs,
                                    subj_starts)
    return chain_anchors_device(isa, rm, text, mlun, ps, subj_starts,
                                rs_lens, thresholds, q_base, q_start,
                                q_len2d, ecap, chase, unroll)


# the count-in-loop replay's lanes: per subject row (int32 [Sg]) its text
# base, RS length and threshold; per query (int32 [G]) its blob offset and
# text offset; per lane (int32 [Sg, G]) the query length, 0 for none
REPLAY_FIELDS = ("ss", "rl", "thr", "q_base", "q_start", "q_len")
# cells AtoA CtoC TtoT GtoG of the byte codes (s >> 1) & 3 (_EQ_CELL)
_EQ_CELL = (0, 5, 15, 10)
A_BYTE = 65
_SITE_BATCH = 1 << 24


# the replay's query segments (replay_segments): one below the segmented
# walk's threshold (esa.backend.chain_segments); above it, enough that the
# live lanes fill the card with REPLAY_WARPS_PER_SM warps an SM, each
# segment at least REPLAY_MIN_SEGMENT symbols long.  The trail is the
# segmented walk's repair budget.
REPLAY_MIN_QLEN = 1 << 17
REPLAY_MIN_SEGMENT = 1 << 15
REPLAY_WARPS_PER_SM = 24
REPLAY_TRAIL = segdrive.REPAIR_EVENTS


def replay_segments(q_len, sms: int) -> int:
    """Query segments K of every lane of a replay over the [Sg, G] query
    lengths ``q_len`` on a card of ``sms`` SMs."""
    if not q_len.numel():
        return 1
    max_qlen, live = spans.readback(torch.stack(
        [q_len.max(), (q_len > 0).sum().to(q_len.dtype)])).tolist()
    if max_qlen < REPLAY_MIN_QLEN:
        return 1
    want = -(-sms * REPLAY_WARPS_PER_SM // max(1, live))
    return max(1, min(want, max_qlen // REPLAY_MIN_SEGMENT))


def replay_rows(isa, rm, text, mlun, ps, lanes: dict, exact_counts: bool,
                chase: int, segments: int | None = None, splice=None):
    """Count-in-loop replay of a subject group (``andix``'s
    ``replay_rows_device``): every (subject row k, query g) lane walked
    from position 0 with the flat walk's probe step, counting the 16
    substitution cells as it goes — the gap between paired anchors byte
    against byte, equal anchors as ``model_count_equal`` does (exactly,
    byte by byte, when ``exact_counts``: LogDet and ANI).

    ``text`` is the block's uint8 text (``BlockContext.text``); ``lanes``
    maps each of ``REPLAY_FIELDS`` to an int32 tensor.  Returns (counts,
    int32 [Sg, G, 16]; tally, int32 [Sg, G, 3]: each lane's probe steps,
    gap sites and exact-mode equal sites, those of the unsegmented walk).

    On CPU tensors it runs ``replay_rows_plain``.  On CUDA tensors it
    launches the two passes of ``csrc/replay.cu``: each lane cut into
    ``segments`` query segments (default ``replay_segments``) walked at
    once, then spliced exactly on the card; the result does not depend on
    ``segments``.  ``splice``, when a dict, receives the segments, the
    trail length and int32 [Sg, G, 3]: each lane's merges, fallbacks and
    repair steps."""
    if mlun.device.type == "cpu":
        return replay_rows_plain(isa, rm, text, mlun, ps, lanes,
                                 exact_counts, chase)
    return _replay_rows_cuda(isa, rm, text, mlun, ps, lanes, exact_counts,
                             chase, segments, splice)


def _replay_args(isa, rm, text, mlun, ps, lanes, exact_counts, chase,
                 segments, trail, seg_ints, device):
    """Checked arguments, the workspace (``seg_ints`` ints a sublane: the
    library's ``replay_seg_ints``) and the zeroed outputs shared by the
    kernels and their host twin."""
    i32 = torch.int32
    tables = _table_args("replay_rows", isa, rm, text, mlun, ps, device)
    sg, g = lanes["q_len"].shape
    for name, dim, size in (("ss", 1, (sg,)), ("rl", 1, (sg,)),
                            ("thr", 1, (sg,)), ("q_base", 1, (g,)),
                            ("q_start", 1, (g,)), ("q_len", 2, (sg, g))):
        _check("replay_rows", name, lanes[name], i32, device, dim)
        if tuple(lanes[name].shape) != size:
            raise ValueError(f"replay_rows: {name} has shape "
                             f"{tuple(lanes[name].shape)}, expected {size}")
    if sg > mlun.shape[0]:
        raise ValueError("replay_rows: more subject rows than table rows")
    if segments < 1 or trail < 1:
        raise ValueError(f"replay_rows: {segments} segments and a trail of "
                         f"{trail} (both must be at least 1)")
    out = {
        # each sublane's workspace is written by pass 1 before pass 2
        # reads it; -1 elsewhere
        "ws": torch.full((sg * g * segments * seg_ints(trail),), -1,
                         dtype=i32, device=device),
        "counts": torch.zeros((sg, g, 16), dtype=i32, device=device),
        "tally": torch.zeros((sg, g, 3), dtype=i32, device=device),
        "splice": torch.zeros((sg, g, 3), dtype=i32, device=device),
        "err": torch.zeros(1, dtype=i32, device=device),
    }
    head = (tables + [lanes[name].data_ptr() for name in REPLAY_FIELDS]
            + [sg, g, segments, trail, int(bool(exact_counts)), int(chase)])
    return head, out


def _replay_checked(out, segments, trail, splice):
    err = int(spans.readback(out["err"]))
    if err:
        raise RuntimeError(f"replay_rows: {err} counted intervals reach "
                           "outside the text")
    if splice is not None:
        splice.update(segments=segments, trail=trail, lanes=out["splice"])
    return out["counts"], out["tally"]


def _replay_rows_cuda(isa, rm, text, mlun, ps, lanes, exact_counts, chase,
                      segments, splice):
    device = mlun.device
    if device.type != "cuda":
        raise ValueError("replay_rows: tables must be on a CUDA device")
    if segments is None:
        segments = replay_segments(
            lanes["q_len"],
            torch.cuda.get_device_properties(device).multi_processor_count)
    lib = kernels.cuda_lib()
    head, out = _replay_args(isa, rm, text, mlun, ps, lanes, exact_counts,
                             chase, segments, REPLAY_TRAIL,
                             lib.andix_replay_seg_ints, device)
    _check_row_window("replay_rows", mlun, ps)
    p = {k: v.data_ptr() for k, v in out.items()}
    with kernels.launch_on(device) as stream:
        kernels.check(lib.andix_replay_cold(*head, p["ws"], p["err"], stream),
                      "replay_rows (pass 1, cold walks)")
        kernels.check(lib.andix_replay_splice(
            *head, p["ws"], p["counts"], p["tally"], p["splice"], p["err"],
            stream), "replay_rows (pass 2, splice)")
    kernels.count_launch("replay", device)
    return _replay_checked(out, segments, REPLAY_TRAIL, splice)


def replay_rows_cpu_twin(isa, rm, text, mlun, ps, lanes, exact_counts,
                         chase, segments: int = 1, trail: int = REPLAY_TRAIL,
                         tiny: bool = False, splice=None):
    """The kernels' two passes (``replay_lane.cuh``) built for the host
    with g++, one thread, at ``segments`` query segments a lane and a
    trail of ``trail`` anchors.  ``tiny`` runs them with tiny windows (4
    row entries, 8 diagonal pairs) instead of the kernels'.  ``splice`` as
    for ``replay_rows``.  An interval reaching outside the text raises,
    as on the card."""
    lib = kernels.cpu_twin()
    head, out = _replay_args(isa, rm, text, mlun, ps, lanes, exact_counts,
                             chase, segments, trail,
                             lib.andix_replay_seg_ints_cpu,
                             torch.device("cpu"))
    lib.andix_replay_rows_cpu(
        *head, *(out[k].data_ptr() for k in ("ws", "counts", "tally",
                                             "splice", "err")), int(tiny))
    return _replay_checked(out, segments, trail, splice)


def replay_equal_cpu_twin(text, start: int, length: int):
    """The kernels' exact-mode equal count of ``text[start:start +
    length]`` (uint8 CPU tensor) built for the host: int32 [16] cells, a
    byte at least 'A' on the diagonal cell of ``(s >> 1) & 3``."""
    _check("replay_equal_cpu_twin", "text", text, torch.uint8,
           torch.device("cpu"))
    out = torch.zeros(16, dtype=torch.int32)
    sites = kernels.cpu_twin().andix_replay_equal_cpu(
        text.data_ptr(), text.shape[0], start, length, out.data_ptr())
    if sites != length:
        raise RuntimeError("replay_equal_cpu_twin: the interval reaches "
                           "outside the text")
    return out


def _sites(starts, lens):
    """Text positions of every site of the intervals (starts, lens), in
    batches of about ``_SITE_BATCH`` sites: (interval index, position)."""
    if not lens.numel():
        return
    first = torch.cumsum(lens, 0) - lens
    _, sizes = torch.unique_consecutive(
        torch.div(first, _SITE_BATCH, rounding_mode="floor"),
        return_counts=True)
    lo = 0
    for size in sizes.tolist():
        part = slice(lo, lo + size)
        lo += size
        idx = torch.repeat_interleave(
            torch.arange(part.start, part.stop, device=lens.device),
            lens[part])
        yield idx, starts[idx] + (torch.arange(idx.shape[0],
                                               device=lens.device)
                                  - (first[idx] - first[part.start]))


def _nucl2bit(c):
    c = c & 6
    c = c ^ (c >> 1)
    return c >> 1


def replay_rows_plain(isa, rm, text, mlun, ps, lanes, exact_counts, chase,
                      counts=None, diag_win=None):
    """Lock-step torch version of ``replay_rows``: ``replay_walk_plain``,
    then ``replay_count_plain``.  ``counts``, when a dict, receives the
    walk's tallies and the sites counted."""
    walk = replay_walk_plain(isa, rm, mlun, ps, lanes, chase, counts,
                             diag_win)
    return replay_count_plain(walk, text, exact_counts, counts)


# a walk step's record, per lane: four due intervals, each a mask row and
# its columns (an equal anchor: start, length; a gap: subject start,
# query start, length)
_DUE = ((0, 1, 2), (3, 4, 5, 6), (7, 8, 9), (10, 11, 12))
_GRAPH_STEPS = 32


def replay_walk_plain(isa, rm, mlun, ps, lanes, chase, counts=None,
                      diag_win=None):
    """The probe steps of ``andix``'s ``replay_rows_device`` over all
    lanes in lock-step (``_LockStep``, every LCE by ISA + range-min, hops
    derived from mlun), recording each interval that a step makes due:
    a gap (subject and query start, length) or an equal anchor (start,
    length).  ``andix`` counts them chunk by chunk inside its loop;
    ``replay_count_plain`` counts them after it, and the sums are the
    same integers.  The walk does not depend on the model.

    Each step only updates the loop's tensors in place, so on a card the
    steps run ``_GRAPH_STEPS`` at a time as one CUDA graph, with one read
    back to the host a graph; on the CPU they run one at a time.
    ``counts``, when a dict, receives ``_LockStep``'s tallies.  Returns
    (gap intervals int64 [4, *]: lane, subject start, query start,
    length; equal intervals int64 [3, *]: lane, start, length; probe
    steps per lane int64 [Sg * G]; (Sg, G))."""
    device = mlun.device
    i32 = torch.int32
    q_len = lanes["q_len"]
    sg, g = q_len.shape
    lane = torch.arange(sg * g, dtype=i32, device=device)
    k, q = (lane // g).long(), (lane % g).long()
    qs, ss = lanes["q_start"][q], lanes["ss"][k]
    rl, thr = lanes["rl"][k], lanes["thr"][k]
    qlen = q_len.reshape(-1)
    graph = device.type == "cuda"
    step = _LockStep(isa, rm, mlun, ps, k, lanes["q_base"][q], qs, ss, rl,
                     thr, qlen, chase, counts, diag_win, gates=not graph)
    # pos, lq, ls, ll, last_right, probe steps
    state = torch.zeros((6, sg * g), dtype=i32, device=device)
    fin = qlen <= 0
    border = rl // 2
    chunk = _GRAPH_STEPS if graph else 1
    rec = torch.zeros((chunk, 13, sg * g), dtype=i32, device=device)

    def body(j):
        pos, lq, ls, ll, last_right, probes = state
        last_right = last_right != 0
        probe = ~fin
        pos_qj, in_range, found, this_s, this_len = step(pos, lq, ls, ll,
                                                         probe)
        # diagonal pairing (src/process.c:160-189)
        end_s, end_q = ls + ll, lq + ll
        paired = (found & (this_s > end_s)
                  & (pos_qj - end_q == this_s - end_s)
                  & ((this_s < border) == (ls < border)))
        due = [found & (paired | last_right | (ll >= 2 * thr)), qs + lq, ll,
               paired, ss + end_s, qs + end_q, pos_qj - end_q]
        lq = torch.where(found, pos_qj, lq)
        ls = torch.where(found, this_s, ls)
        ll = torch.where(found, this_len, ll)
        last_right = torch.where(found, paired, last_right)
        pos = torch.where(
            probe, torch.where(in_range, pos_qj + this_len + 1, pos_qj), pos)
        # chain end: identical sequences or the trailing anchor
        # (src/process.c:199-211)
        done = probe & (pos >= qlen)
        identical = ll >= qlen
        due += [done & identical, qs, qlen,
                done & ~identical & (last_right | (ll >= 2 * thr)), qs + lq,
                ll]
        rec[j] = torch.stack([d.to(i32) for d in due])
        state.copy_(torch.stack([pos, lq, ls, ll, last_right.to(i32),
                                 probes + probe.to(i32)]))
        fin.logical_or_(done)

    def steps():
        for j in range(chunk):
            body(j)

    records = []
    if graph and not bool(fin.all()):
        # the first steps run eagerly, on a side stream as capture wants
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            steps()
        torch.cuda.current_stream(device).wait_stream(side)
        records.append(rec.clone())
        if not bool(fin.all()):
            cuda_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cuda_graph):
                steps()
            steps = cuda_graph.replay
    while not bool(fin.all()):
        steps()
        records.append(rec.clone())

    rec = (torch.cat(records) if records
           else torch.zeros((0, 13, sg * g), dtype=i32, device=device))
    parts = []
    for mask_row, *cols in _DUE:
        at, lanes_at = torch.nonzero(rec[:, mask_row], as_tuple=True)
        parts.append(torch.stack([lanes_at] + [rec[at, c, lanes_at].long()
                                               for c in cols]))
    if counts is not None:
        counts.update(step.totals())
    return (parts[1], torch.cat([parts[0], parts[2], parts[3]], dim=1),
            state[5].long(), (sg, g))


def replay_count_plain(walk, text, exact_counts, counts=None):
    """The 16 cells of every lane from ``replay_walk_plain``'s intervals:
    a gap site by site, subject byte against query byte; an equal anchor
    as ``model_count_equal`` does (byte by byte when ``exact_counts``:
    LogDet and ANI).  A site counts where both bytes are nucleotides.  An
    interval reaching outside the text raises.  Returns (counts, int32
    [Sg, G, 16]; tally, int32 [Sg, G, 3]: probe steps, gap sites,
    exact-mode equal sites).  ``counts``, when a dict, receives
    ``gap_sites`` and ``equal_sites``."""
    gap, eq, probes, (sg, g) = walk
    device = gap.device
    n = text.shape[0]
    gap = gap[:, gap[-1] > 0]
    eq = eq[:, eq[-1] > 0]
    for iv in (gap, eq):
        for start in iv[1:-1]:
            if bool(((start < 0) | (start + iv[-1] > n)).any()):
                raise RuntimeError("replay_rows_plain: a counted interval "
                                   "reaches outside the text")
    cells = torch.zeros(sg * g * 16, dtype=torch.int64, device=device)
    sites = torch.zeros((2, sg * g), dtype=torch.int64, device=device)

    def add(idx_cell, ok):
        cells.index_add_(0, idx_cell[ok], torch.ones_like(idx_cell[ok]))

    sites[0].index_add_(0, gap[0], gap[3])
    for idx, spos in _sites(gap[1], gap[3]):
        s = text[spos].long()
        qb = text[gap[2][idx] + (spos - gap[1][idx])].long()
        ok = (s >= A_BYTE) & (qb >= A_BYTE)
        add(gap[0][idx] * 16 + (_nucl2bit(s) << 2) + _nucl2bit(qb), ok)
    if exact_counts:
        sites[1].index_add_(0, eq[0], eq[2])
        eq_cell = torch.tensor(_EQ_CELL, dtype=torch.int64, device=device)
        for idx, spos in _sites(eq[1], eq[2]):
            s = text[spos].long()
            add(eq[0][idx] * 16 + eq_cell[(s >> 1) & 3], s >= A_BYTE)
    else:
        # model_count_equal's fast path: len / 4 on each diagonal cell and
        # the rest on TtoT (src/model.c:247-253)
        for c in (0, 5, 10, 15):
            cells.index_add_(0, eq[0] * 16 + c, eq[2] // 4)
        cells.index_add_(0, eq[0] * 16 + 15, eq[2] & 3)
    if counts is not None:
        counts.update(gap_sites=int(sites[0].sum()),
                      equal_sites=int(sites[1].sum()))
    tally = torch.stack([probes, sites[0], sites[1]], dim=1)
    return (cells.view(sg, g, 16).to(torch.int32),
            tally.view(sg, g, 3).to(torch.int32))


def replay_lanes(starts, rs_lens, thresholds, q_base, q_start, q_len2d,
                 device) -> dict:
    """``replay_rows``' lanes from a group's host arrays (per subject row:
    text base, RS length, threshold; per query: blob and text offset; the
    [Sg, G] query lengths)."""
    vals = (starts, rs_lens, thresholds, q_base, q_start, q_len2d)
    return {name: spans.upload(np.ascontiguousarray(v, dtype=np.int32),
                               device)
            for name, v in zip(REPLAY_FIELDS, vals)}
