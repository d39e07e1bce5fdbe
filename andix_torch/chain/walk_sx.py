"""Chain walk over the subject-only index: the search-in-the-loop walk
(counterpart of ``andix/chain/walk_sx.py``).

Same chain semantics and event contract as ``replay_device.chain_walk_flat``
(``dist_anchor``, src/process.c:141-214), but each probe's match
statistics come from a seeded binary search over the lane's subject
suffix array (``esa.subject_index``) instead of precomputed tables: the
k-mer cache brackets the insertion point, the bisection compares 16
symbols per packed-word pair, and the two boundary extensions run from
the shared offset ``min(l_lo, l_hi)``.  Lucky anchors extend the last
anchor's diagonal with the same word compares.

A lane is a state machine over four phases (``P_FIRST`` probe start,
``P_LUCKY``, ``P_BIS``, ``P_AB``); one iteration advances every active
lane by one step.  ``chain_walk_flat_sx`` dispatches on the device: CUDA
tensors launch the hand-written kernel (``csrc/walk_sx.cu``, one warp per
lane, whole probes with 32-word compares, the iterations of the one-step
loop counted from their outcomes), CPU tensors run
``chain_walk_flat_sx_plain``, the JAX loop's lock-step iteration written
in torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# probe pipeline phases (per lane)
P_FIRST = 0  # fresh probe: cache seed + first compare
P_LUCKY = 1  # lucky-anchor extension
P_BIS = 2  # bisection compare vs SA[mid]
P_AB = 3  # both boundary extensions vs SA[ip-1] / SA[ip]

# iterations per super-step: the JAX loop tests its exit condition once
# per `UNROLL` iterations and counts iterations in whole super-steps
UNROLL = 8

SX_LANE_FIELDS = ("row", "qwb", "rl", "thr", "seg_end", "pos0", "lq0",
                  "ls0", "ll0")


def _combine_window(w0, w1, r):
    """16-symbol window starting ``r`` nibbles into w0 (0 <= r <= 15);
    int64 shifts are arithmetic, and the mask keeps w1's sign bits out."""
    r1 = torch.clamp(r, min=1)
    return torch.where(
        r > 0,
        (w0 << (4 * r)) | ((w1 >> (4 * (16 - r1))) & ((1 << (4 * r1)) - 1)),
        w0,
    )


def _clz_nibbles(x):
    """Leading zero nibbles of the int64 bit pattern (16 for zero), by a
    binary search over shifts: ``x >> k == 0`` holds exactly when the top
    64 - k bits are zero, also for negative x."""
    n = torch.zeros_like(x, dtype=torch.int32)
    y = x
    for bits in (32, 16, 8, 4):
        top_zero = (y >> (64 - bits)) == 0
        n += torch.where(top_zero, bits // 4, 0).to(torch.int32)
        y = torch.where(top_zero, y << bits, y)
    return torch.where(x == 0, 16, n).to(torch.int32)


def _word_lcp(wa, wb):
    """Agreeing symbols between two windows (16 iff equal)."""
    return _clz_nibbles(wa ^ wb)


def _nibble(w, i):
    return ((w >> (4 * (15 - i))) & 15).to(torch.int32)


def chain_walk_flat_sx(salcp, sw, cache2, nreal, qw, lanes: dict,
                       max_iters: int, max_events: int, cache_k: int,
                       ecap: int):
    """Resumable flat-lane chain-walk chunk over the subject index.

    ``salcp`` int32[S, 2, Lp] stacks each subject's suffix array and
    adjacent LCP, ``sw`` int64[S, Lp / 16] its packed words, ``cache2``
    int32[S, 4^cache_k + 1] its k-mer cache and ``nreal`` int32[S] its real
    length; ``qw`` int64[QW] holds the packed query words.  ``lanes`` maps
    each of ``SX_LANE_FIELDS`` to an int32 [Lb] tensor: the lane's subject
    row, its query base in ``qw`` symbols, RS length, threshold, exclusive
    stop position and entry state (pos, lq, ls, ll).

    Returns (ev_lane, ev_q, ev_s, ev_len — int32[ecap] valid up to ev_cnt,
    each lane's events in chain order; ev_cnt; ovf = ev_cnt > ecap; iters;
    pos, lq, ls, ll, fin) with the JAX version's meaning; ev_cnt, ovf and
    iters are 0-d tensors."""
    if salcp.device.type == "cpu":
        return chain_walk_flat_sx_plain(salcp, sw, cache2, nreal, qw, lanes,
                                        max_iters, max_events, cache_k, ecap)
    return _chain_walk_flat_sx_cuda(salcp, sw, cache2, nreal, qw, lanes,
                                    max_iters, max_events, cache_k, ecap)


def _check(name, t, dtype, device, dim=1):
    if t.device != device:
        raise ValueError(f"chain_walk_flat_sx: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"chain_walk_flat_sx: {name} must be {dim}-D "
                         f"{dtype}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"chain_walk_flat_sx: {name} must be contiguous")


def _walk_args(salcp, sw, cache2, nreal, qw, lanes, max_iters, max_events,
               cache_k, ecap, device):
    """Checked arguments and output buffers shared by the kernel and its
    host twin."""
    i32 = torch.int32
    _check("salcp", salcp, i32, device, dim=3)
    _check("sw", sw, torch.int64, device, dim=2)
    _check("cache2", cache2, i32, device, dim=2)
    _check("nreal", nreal, i32, device)
    _check("qw", qw, torch.int64, device)
    s, two, lp = salcp.shape
    if two != 2 or lp % 16 or sw.shape != (s, lp // 16):
        raise ValueError(f"chain_walk_flat_sx: salcp {tuple(salcp.shape)} "
                         f"and sw {tuple(sw.shape)} do not stack")
    if not 0 <= cache_k <= 15 or cache2.shape != (s, (1 << 2 * cache_k) + 1):
        raise ValueError(f"chain_walk_flat_sx: cache2 {tuple(cache2.shape)} "
                         f"does not fit cache_k={cache_k}")
    if nreal.shape[0] != s or qw.shape[0] == 0:
        raise ValueError("chain_walk_flat_sx: nreal or qw has a bad length")
    lb = lanes["row"].shape[0]
    for name in SX_LANE_FIELDS:
        _check(name, lanes[name], i32, device)
        if lanes[name].shape[0] != lb:
            raise ValueError(f"chain_walk_flat_sx: {name} has "
                             f"{lanes[name].shape[0]} lanes, expected {lb}")
    ev = [torch.empty(max(ecap, 1), dtype=i32, device=device)
          for _ in range(4)]
    counters = torch.zeros(2, dtype=i32, device=device)
    state = [torch.empty(lb, dtype=i32, device=device) for _ in range(4)]
    fin = torch.empty(lb, dtype=torch.bool, device=device)
    args = (
        [salcp.data_ptr(), sw.data_ptr(), cache2.data_ptr(),
         nreal.data_ptr(), qw.data_ptr(), ctypes.c_int64(lp),
         ctypes.c_int64(qw.shape[0]), ctypes.c_int64(cache2.shape[1]),
         int(cache_k)]
        + [lanes[name].data_ptr() for name in SX_LANE_FIELDS]
        + [lb, int(max_iters), int(max_events), int(ecap), UNROLL]
        + [e.data_ptr() for e in ev] + [counters.data_ptr()]
        + [t.data_ptr() for t in state] + [fin.data_ptr()]
    )
    return args, ev, counters, state, fin


def _walk_result(ev, counters, state, fin, ecap):
    ev_cnt = counters[0]
    return (ev[0][:ecap], ev[1][:ecap], ev[2][:ecap], ev[3][:ecap], ev_cnt,
            ev_cnt > ecap, counters[1], *state, fin)


def _chain_walk_flat_sx_cuda(salcp, sw, cache2, nreal, qw, lanes, max_iters,
                             max_events, cache_k, ecap):
    device = salcp.device
    if device.type != "cuda":
        raise ValueError("chain_walk_flat_sx: the index must be on a CUDA "
                         "device")
    args, ev, counters, state, fin = _walk_args(
        salcp, sw, cache2, nreal, qw, lanes, max_iters, max_events, cache_k,
        ecap, device,
    )
    lib = kernels.cuda_lib()
    with kernels.launch_on(device) as stream:
        err = lib.andix_chain_walk_sx(*args, stream)
    kernels.check(err, "chain_walk_flat_sx")
    kernels.count_launch("chain_walk_flat_sx", device)
    return _walk_result(ev, counters, state, fin, ecap)


def chain_walk_flat_sx_cpu_twin(salcp, sw, cache2, nreal, qw, lanes,
                                max_iters, max_events, cache_k, ecap,
                                tiny: bool = False):
    """The kernel's lane body (``walk_sx_lane.cuh``) built for the host
    with g++, one thread per lane — for testing the kernel's logic without
    a card.  ``tiny`` runs it with tiny compare rounds, windows and event
    staging (2 words a round, 3 query words, 4 diagonal words, 3 events)
    instead of the kernel's."""
    args, ev, counters, state, fin = _walk_args(
        salcp, sw, cache2, nreal, qw, lanes, max_iters, max_events, cache_k,
        ecap, torch.device("cpu"),
    )
    kernels.cpu_twin().andix_chain_walk_sx_cpu(*args, int(tiny))
    return _walk_result(ev, counters, state, fin, ecap)


def chain_walk_flat_sx_plain(salcp, sw, cache2, nreal, qw, lanes,
                             max_iters: int, max_events: int, cache_k: int,
                             ecap: int, counts=None):
    """Lock-step loop over all lanes in torch ops: the JAX loop body line
    for line, with its exit test as an ``any()`` once per super-step.

    ``counts``, when a dict, receives what the walk's data needs: the
    index entries it reads, each counted once over the dispatch (``sa``,
    ``lcp`` and ``cache`` entries, ``sw`` subject words and ``qw`` query
    words; a window that starts on a word boundary needs only that word;
    cache entries only for probes the lucky check does not settle; LCP
    entries only for the uniqueness test of a boundary pair), and
    ``probes``, ``lucky_checks``, ``bis_steps`` (resolved bisection
    steps), ``ab_pairs`` (boundary pairs), ``words`` (word pairs compared)
    and ``events``."""
    device = salcp.device
    i64 = torch.int64
    row = lanes["row"].to(i64)
    qwb, rl, thr, seg_end = (lanes[n] for n in ("qwb", "rl", "thr",
                                                "seg_end"))
    pos, lq, ls, ll = (lanes[n].clone() for n in ("pos0", "lq0", "ls0",
                                                  "ll0"))
    lb = row.shape[0]
    lanes_sq = sw.shape[1]
    sa_last = salcp.shape[2] - 1
    qw_last = qw.shape[0] - 1
    lane_iota = torch.arange(lb, dtype=torch.int32, device=device)
    nr = nreal[row]
    sa_rows = salcp[:, 0]
    lcp_rows = salcp[:, 1]

    def qwin(p):
        j = (p >> 4).to(i64)
        w0 = qw[torch.clamp(j, max=qw_last)]
        w1 = qw[torch.clamp(j + 1, max=qw_last)]
        return _combine_window(w0, w1, (p & 15).to(i64))

    def swin(p):
        j = (p >> 4).to(i64)
        w0 = sw[row, torch.clamp(j, max=lanes_sq - 1)]
        w1 = sw[row, torch.clamp(j + 1, max=lanes_sq - 1)]
        return _combine_window(w0, w1, (p & 15).to(i64))

    def gather(rows, col):
        return rows[row, torch.clamp(col, 0, sa_last).to(i64)]

    def lucky_cond(pos, lq, ls, ll, fin):
        """Reference lucky-anchor precondition (src/process.c:82-100,156):
        within threshold of the last anchor, projected onto the diagonal."""
        in_range = (~fin) & (pos < seg_end)
        advance = pos - lq
        gap = advance - ll
        try_s = ls + advance
        return in_range & (try_s < rl) & (gap >= 0) & (gap <= thr), try_s

    def setup_sp(pos, lq, ls, ll, fin):
        pre, try_s = lucky_cond(pos, lq, ls, ll, fin)
        return torch.where(pre, try_s, 0)

    z = torch.zeros(lb, dtype=torch.int32, device=device)
    fin = (pos >= seg_end) | (max_events <= 0)
    evn, ph, h, spB, lo, hi, llo, lhi, ipv = (z.clone() for _ in range(9))
    aa = torch.full_like(z, -1)
    bb = aa.clone()
    spA = setup_sp(pos, lq, ls, ll, fin)

    if counts is not None:
        seen = {"sa": torch.zeros(salcp.shape[0], salcp.shape[2],
                                  dtype=torch.bool, device=device),
                "cache": torch.zeros(cache2.shape, dtype=torch.bool,
                                     device=device),
                "sw": torch.zeros(sw.shape, dtype=torch.bool, device=device),
                "qw": torch.zeros(qw.shape, dtype=torch.bool, device=device)}
        seen["lcp"] = seen["sa"].clone()
        tally = {k: torch.zeros((), dtype=i64, device=device)
                 for k in ("probes", "lucky_checks", "bis_steps", "ab_pairs",
                           "words")}
        pcode = torch.full_like(z, -1)  # the probe's cache code, if valid

        def mark(key, where, col, row_=row):
            """Entries [row, col] at lanes ``where`` were read."""
            if key == "qw":
                seen[key][col[where]] = True
            else:
                seen[key][row_[where], col[where].to(i64)] = True

        def mark_words(key, where, p, last):
            j = (p >> 4).to(i64)
            mark(key, where, torch.clamp(j, max=last))
            mark(key, where & ((p & 15) != 0), torch.clamp(j + 1, max=last))

    events = []  # (lane, q, s, len) per iteration, iteration-major
    it = 0
    while it < max_iters and not bool(fin.all()):
        for _ in range(UNROLL):
            act = ~fin
            qa = qwb + torch.where(act, pos, 0)
            wq = qwin(qa + h)

            # ---- probe-start control: k-mer code + cache bracket + seek
            is_first = act & (ph == P_FIRST)
            code = z
            valid = is_first
            for i in range(cache_k):
                nib = _nibble(wq, i)
                valid = valid & (nib >= 4) & (nib <= 7)
                code = (code << 2) | torch.clamp(nib - 4, 0, 3)
            safe_code = torch.where(valid, code, 0).to(i64)
            clo = cache2[row, safe_code]
            chi = cache2[row, safe_code + 1]
            lo = torch.where(is_first, torch.where(valid, clo, 0), lo)
            hi = torch.where(is_first, torch.where(valid, chi, nr), hi)
            llo = torch.where(is_first, 0, llo)
            lhi = torch.where(is_first, 0, lhi)

            lucky_pre, _ = lucky_cond(pos, lq, ls, ll, fin)
            first_lucky = is_first & lucky_pre
            first_nl = is_first & ~lucky_pre
            e_to_bis = first_nl & (lo < hi)
            e_to_ab = first_nl & (lo >= hi)
            ipv = torch.where(e_to_ab, lo, ipv)
            mid_e = (lo + hi) >> 1
            tgA = gather(sa_rows, torch.where(e_to_bis, mid_e, ipv - 1))
            tgB = gather(sa_rows, torch.where(e_to_bis, mid_e, ipv))
            spA = torch.where(e_to_bis | e_to_ab, tgA, spA)
            spB = torch.where(e_to_ab, tgB, spB)
            ph = torch.where(first_lucky, P_LUCKY, ph)
            ph = torch.where(e_to_bis, P_BIS, ph)
            ph = torch.where(e_to_ab, P_AB, ph)
            if counts is not None:
                tally["probes"] += is_first.sum()
                tally["lucky_checks"] += first_lucky.sum()
                mark_words("qw", act, qa + h, qw_last)
                pcode = torch.where(is_first, torch.where(valid, code, -1),
                                    pcode)
                for d in (0, 1):
                    mark("cache", first_nl & valid, code + d)
                mark("sa", e_to_bis, mid_e)
                mark("sa", e_to_ab & (ipv > 0), ipv - 1)
                mark("sa", e_to_ab & (ipv < nr), ipv)

            # ---- compares (A slot: lucky/bis/left boundary; B: right) --
            in_lucky = act & (ph == P_LUCKY)
            in_bis = act & (ph == P_BIS)
            in_ab = act & (ph == P_AB)
            a_active = in_lucky | in_bis | (in_ab & (aa < 0) & (ipv > 0))
            b_active = in_ab & (bb < 0) & (ipv < nr)
            wsA = swin(torch.where(a_active, spA, 0) + h)
            wsB = swin(torch.where(b_active, spB, 0) + h)
            mA = _word_lcp(wq, wsA)
            mB = _word_lcp(wq, wsB)
            miA = torch.clamp(mA, max=15)
            qnA = _nibble(wq, miA)
            snA = _nibble(wsA, miA)
            mmA = mA < 16
            mmB = mB < 16
            if counts is not None:
                tally["words"] += a_active.sum() + b_active.sum()
                mark_words("sw", a_active, spA + h, lanes_sq - 1)
                mark_words("sw", b_active, spB + h, lanes_sq - 1)
            lcpA = h + mA
            lcpB = h + mB

            # lucky resolution
            l_done = in_lucky & mmA
            l_acc = l_done & (lcpA >= thr)
            l_fail = l_done & ~l_acc

            # bisection resolution (mid from pre-update lo/hi)
            b_done = in_bis & mmA
            mid = (lo + hi) >> 1
            qless = qnA < snA
            go_hi = b_done & qless
            go_lo = b_done & ~qless
            hi = torch.where(go_hi, mid, hi)
            lhi = torch.where(go_hi, lcpA, lhi)
            lo = torch.where(go_lo, mid + 1, lo)
            llo = torch.where(go_lo, lcpA, llo)

            # boundary resolutions
            aa = torch.where(in_ab & a_active & mmA, lcpA, aa)
            bb = torch.where(in_ab & b_active & mmB, lcpB, bb)
            doneA = (aa >= 0) | (ipv <= 0)
            doneB = (bb >= 0) | (ipv >= nr)
            ab_done = in_ab & doneA & doneB

            # shared-offset advance while anything still extends
            still = (
                (in_lucky & ~mmA)
                | (in_bis & ~mmA)
                | (in_ab & ~ab_done & ((a_active & ~mmA)
                                       | (b_active & ~mmB)))
            )
            h = torch.where(still, h + 16, h)

            # ---- late seek: failed lucky / resolved bisect step ----
            seek = l_fail | b_done
            post_to_bis = seek & (lo < hi)
            post_to_ab = seek & (lo >= hi)
            ipv = torch.where(post_to_ab, lo, ipv)
            mid2 = (lo + hi) >> 1
            ip1s_pre = torch.where(ipv + 1 < nr, ipv + 1, 0)
            tgA2 = gather(sa_rows, torch.where(post_to_bis, mid2, ipv - 1))
            tgB2 = gather(sa_rows, torch.where(post_to_bis, mid2, ipv))
            lcpPA = gather(lcp_rows, torch.clamp(ipv - 1, min=0))
            lcpPB = gather(lcp_rows, ip1s_pre)
            spA = torch.where(post_to_bis | post_to_ab, tgA2, spA)
            spB = torch.where(post_to_ab, tgB2, spB)
            ph = torch.where(post_to_bis, P_BIS, ph)
            ph = torch.where(post_to_ab, P_AB, ph)
            h = torch.where(seek, torch.minimum(llo, lhi), h)
            if counts is not None:
                tally["bis_steps"] += b_done.sum()
                for d in (0, 1):
                    mark("cache", l_fail & (pcode >= 0), pcode + d)
                mark("sa", post_to_bis, mid2)
                mark("sa", post_to_ab & (ipv > 0), ipv - 1)
                mark("sa", post_to_ab & (ipv < nr), ipv)

            # ---- FINAL: stats, chain update, next-probe setup ----
            finishing = ab_done | l_acc
            ml = torch.clamp(torch.maximum(aa, bb), min=0)
            use_a = aa >= bb
            unique = (
                (ml > 0)
                & (aa != bb)
                & torch.where(use_a, lcpPA < aa,
                              (ipv + 1 >= nr) | (lcpPB < bb))
            )
            psv = torch.where(use_a, spA, spB)
            if counts is not None:
                tally["ab_pairs"] += ab_done.sum()
                tested = ab_done & (ml > 0) & (aa != bb)
                mark("lcp", tested & use_a, torch.clamp(ipv - 1, min=0))
                mark("lcp", tested & ~use_a & (ipv + 1 < nr), ipv + 1)
            found = l_acc | (ab_done & unique & (ml >= thr))
            this_len = torch.where(l_acc, lcpA, ml)
            this_s = torch.where(l_acc, spA, psv)

            if bool(found.any()):
                events.append(torch.stack([lane_iota[found], pos[found],
                                           this_s[found], this_len[found]]))
            lq = torch.where(found, pos, lq)
            ls = torch.where(found, this_s, ls)
            ll = torch.where(found, this_len, ll)
            pos = torch.where(finishing, pos + this_len + 1, pos)
            evn = evn + found.to(torch.int32)
            fin = fin | (finishing & ((pos >= seg_end)
                                      | (evn >= max_events)))
            ph = torch.where(finishing, P_FIRST, ph)
            h = torch.where(finishing, 0, h)
            aa = torch.where(finishing, -1, aa)
            bb = torch.where(finishing, -1, bb)
            spA = torch.where(finishing, setup_sp(pos, lq, ls, ll, fin), spA)
        it += UNROLL

    ev = (torch.cat(events, dim=1) if events
          else torch.zeros((4, 0), dtype=torch.int32, device=device))
    cnt = ev.shape[1]
    if counts is not None:
        counts.update({k: int(v) for k, v in tally.items()},
                      **{k: int(v.sum()) for k, v in seen.items()},
                      events=cnt)
    buf = torch.zeros((4, max(ecap, 1)), dtype=torch.int32, device=device)
    keep = min(cnt, ecap)
    buf[:, :keep] = ev[:, :keep]
    ev_cnt = torch.tensor(cnt, dtype=torch.int32)
    return (buf[0][:ecap], buf[1][:ecap], buf[2][:ecap], buf[3][:ecap],
            ev_cnt, ev_cnt > ecap, torch.tensor(it, dtype=torch.int32), pos,
            lq, ls, ll, fin)
