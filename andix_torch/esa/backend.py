"""Torch block backend: one joint block's SA/LCP and tables on the device,
the segmented chain walk, host counting (counterpart of
``andix/esa/backend_jax.py``'s ``JaxBackend``).

Per block (``prepare_block``): the block's uint8 text goes to the device
(``BlockContext.text``, which stays there for the walk's lucky checks)
and ``ingest.block_text`` widens it there to the padded int32 symbols;
suffix array by prefix doubling and the
adjacent LCP (``doubling.sa_lcp_device``: the sampled-PLCP kernel over a
capped level buffer, or the level walk), with ``andix``'s retreat to the
host Φ LCP (``native.lcp_from_sa``) when the levels overflow or do not
fit; then segment ids, inverse SA, the query blob's SA slots and the
range-min structure.  Per subject group
(``subject_group_counts``): ``[Sg, QB]`` match-statistics tables (two
flag scans per subject), the
segmented chain walk (``chain.segdrive`` driving ``chain_walk_flat``)
when queries are cut into K > 1 segments, else the unsegmented walk
(``chain_anchors_device``), and the 16-cell counts from the anchor
events on the host; or, under ``ANDIX_REPLAY=loop`` and when the
unsegmented walk's event buffer overflows, the count-in-loop replay
(``replay_rows``), which counts on the device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import ingest, spans
from ..chain import events as chain_events
from ..chain import segdrive
from ..chain.replay_device import (
    LANE_FIELDS, chain_anchors_device, chain_walk_flat, fetch_walk,
    group_subject_tables, replay_lanes, replay_rows,
)
from .. import native
from ..device import memory_budget
from ..model import CountMatrix
from ..runtime import Model
from . import doubling, matchstats, plcp, rmq, sa_numpy
from .joint import SEPARATOR_BASE, BlockLayout

# the smallest padded size: ``ANDIX_MIN_BUCKET`` as in ``andix``, whose
# parity tests set it for both packages, for small pads at test sizes
_MIN_BUCKET = int(os.environ.get("ANDIX_MIN_BUCKET", 1 << 16))
# walk probe steps per loop iteration, and jump-chain hops chased per
# probe: the JAX backend's defaults for the segmented walk
# (backend_jax.py:696-704), so iteration counts match it
UNROLL = 4
CHASE = 4


def bucket(n: int, minimum: int | None = None) -> int:
    """Round up to {2^k, 1.5*2^k} so device programs compile per bucket,
    not per exact block size (waste <= 33%)."""
    b = minimum if minimum is not None else _MIN_BUCKET
    while b < n:
        b2 = b + b // 2
        if b2 >= n:
            return b2
        b *= 2
    return b


def pad_symbols(sym: np.ndarray, padded_n: int) -> np.ndarray:
    """Pad the joint text with strictly increasing symbols larger than every
    real symbol.  All real suffixes compare below all padding suffixes and
    no two real suffixes can tie into the padding (segments end with unique
    separators), so ``SA[:n_real]`` of the padded text equals the real SA."""
    n = len(sym)
    if padded_n == n:
        return sym
    pad_base = max(
        1 << 20,
        (int(sym.max(initial=SEPARATOR_BASE)) + 1) if n else SEPARATOR_BASE,
    )
    pad = pad_base + np.arange(padded_n - n, dtype=np.int32)
    return np.concatenate([sym, pad])


# andix's largest padded block whose LCP is built on the device
# (backend_jax.py:306); larger blocks build the SA without levels and take
# the host LCP.  Re-derived on the card with the ``auto`` rule (ROADMAP).
DEVICE_LCP_MAX = 192 * 1024 * 1024
# device bytes per padded symbol that the SA build needs besides its level
# rows: the text, ranks, SA and a full round's int64 sort operands.  On an
# H100 80GB HBM3 (700 W; chip_smoke.py phase 4, PERF.md) a random 5 Mbp
# subject's SA + LCP stage peaked at 60.22 B over its text (4 B), 4 B of
# it its one level row; rounded up.
LEVEL_RESERVE_BYTES_PER_SYM = 64


def level_budget(padded_n: int, budget: int) -> int:
    """Int32 rank levels of ``padded_n`` symbols that fit ``budget`` bytes
    beside the build's other arrays (``andix``'s ``level_budget``, from
    this worker's memory budget instead of a TPU's 12 GB)."""
    reserve = LEVEL_RESERVE_BYTES_PER_SYM * padded_n
    return max(0, (budget - reserve) // (4 * padded_n))


_OUTSIDE_ALPHABET = np.ones(256, dtype=bool)
_OUTSIDE_ALPHABET[sorted(plcp.ALPHABET_U8)] = False


def alphabet_ok(sym: torch.Tensor, n: int) -> bool:
    """Every byte of the first ``n`` symbols (separators count as 0) in
    the block alphabet (``plcp.ALPHABET_U8``): the condition of the wide
    initial ranks and the sampled-PLCP LCP.  One table lookup on the
    symbols' device, one flag read back."""
    real = sym[:n]
    outside = spans.upload(_OUTSIDE_ALPHABET, sym.device)
    return not bool(spans.readback(
        outside[torch.where(real < SEPARATOR_BASE, real, 0)].any()))


def host_lcp(padded: np.ndarray, sa: torch.Tensor, threads: int):
    """The LCP by the host's parallel Φ algorithm, on ``sa``'s device."""
    sa_h = spans.readback(sa).numpy()
    if native.available():
        lcp = native.lcp_from_sa(padded, sa_h, threads)
    else:  # pragma: no cover - toolchain-less fallback
        lcp = sa_numpy.lcp_array(padded, sa_h).astype(np.int32)
    return spans.upload(lcp, sa.device)


@dataclasses.dataclass
class BlockContext:
    layout: BlockLayout
    q_genomes: list[int]  # genome ids in blob order
    q_off: np.ndarray  # int64[g+1] offsets into the query blob
    query_blob: np.ndarray  # uint8 concatenated forward sequences
    sa: torch.Tensor  # int32[Np]
    lcp: torch.Tensor  # int32[Np]
    segid: torch.Tensor  # int32[Np] segment of SA[t]
    isa: torch.Tensor  # int32[Np]
    tq: torch.Tensor  # int32[QB] SA slots of the query blob (padded)
    rm: rmq.RangeMin
    # uint8[n] text bytes, 0 at separators: the walk kernel takes a 0 byte
    # for a unique symbol, so no real symbol may be 0 (sequences hold
    # ``ACGT!;#`` only; ``prepare_block`` checks)
    text: torch.Tensor
    q_start_h: np.ndarray  # int32[Gp] text base per query lane
    q_len_h: np.ndarray  # int32[Gp] (0 = padding lane)
    q_base_h: np.ndarray  # int32[Gp] blob base per query lane

    @classmethod
    def from_numpy(cls, layout: BlockLayout, sa, lcp, segid, isa, tq,
                   q_start, q_len, q_base, device) -> "BlockContext":
        """Block state from host arrays (e.g. another implementation's
        exact SA/LCP/tables), so later stages can be checked alone."""
        def dev(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

        genomes, q_off, blob = _query_lanes(layout)[:3]
        lcp_d = dev(lcp)
        return cls(
            layout=layout, q_genomes=genomes, q_off=q_off, query_blob=blob,
            sa=dev(sa), lcp=lcp_d, segid=dev(segid), isa=dev(isa),
            tq=dev(tq), rm=rmq.build(lcp_d),
            text=torch.from_numpy(layout.u8).to(device),
            q_start_h=np.asarray(q_start, np.int32),
            q_len_h=np.asarray(q_len, np.int32),
            q_base_h=np.asarray(q_base, np.int32),
        )


def _query_lanes(layout: BlockLayout):
    """Query blob and its lane table, padded to a multiple of 8 lanes:
    (genomes, q_off int64[g+1], blob, q_start, q_len, q_base)."""
    genomes = [int(g) for g in layout.genome_ids]
    gp = max(8, -(-len(genomes) // 8) * 8)
    q_start = np.zeros(gp, dtype=np.int32)
    q_len = np.zeros(gp, dtype=np.int32)
    q_base = np.zeros(gp, dtype=np.int32)
    q_off = np.zeros(len(genomes) + 1, dtype=np.int64)
    for k, g in enumerate(genomes):
        qs, qe = layout.query_span(g)
        q_start[k] = qs
        q_len[k] = qe - qs
        q_off[k + 1] = q_off[k] + (qe - qs)
        q_base[k] = q_off[k]
    blob = (
        np.concatenate([layout.u8[q_start[k]: q_start[k] + q_len[k]]
                        for k in range(len(genomes))])
        if genomes else np.zeros(0, np.uint8)
    )
    return genomes, q_off, blob, q_start, q_len, q_base


def _segid(sa: torch.Tensor, seg_bounds: np.ndarray) -> torch.Tensor:
    """Segment id per SA entry: a text-order cumsum over segment starts
    (padding lands past the last segment), gathered through the SA."""
    n = sa.shape[0]
    boundary = torch.zeros(n, dtype=torch.int32, device=sa.device)
    boundary.index_fill_(0, spans.upload(
        seg_bounds[seg_bounds < n].astype(np.int64), sa.device), 1)
    segid_text = torch.cumsum(boundary, 0, dtype=torch.int32)
    return segid_text[sa.long()]


def _query_slots(isa: torch.Tensor, q_start: np.ndarray, q_off: np.ndarray,
                 qb: int) -> torch.Tensor:
    """SA slots of the query blob's positions (padded to ``qb``; padding
    slots read text position 0)."""
    dev = isa.device
    g = len(q_off) - 1
    q_off_d = spans.upload(q_off.astype(np.int64), dev)
    q_start_d = spans.upload(q_start[:g].astype(np.int64), dev)
    v = torch.arange(qb, dtype=torch.int64, device=dev)
    lane = torch.searchsorted(q_off_d[1:], v, right=True).clamp(max=g - 1)
    text = torch.where(v < q_off_d[-1], q_start_d[lane] + v - q_off_d[lane],
                       0)
    return isa[text]


class TorchBackend:
    """The block backend on one device; ``share`` is the number of workers
    that run on the device at once, which split its free memory, and
    ``budget`` the bytes a block may use (``pipeline.worker_memory``;
    by default this worker's share of the device's memory when the
    backend is built)."""

    def __init__(self, device: torch.device, threads: int = 0,
                 share: int = 1, budget: int | None = None):
        self.device = torch.device(device)
        self.threads = threads
        self.share = share
        self.budget = (budget if budget is not None
                       else memory_budget(self.device, share))

    def prepare_block(self, layout: BlockLayout) -> BlockContext:
        """The block's SA, LCP and tables on the device, by ``andix``'s
        decision chain (backend_jax.py:349-455): the device LCP for blocks
        up to DEVICE_LCP_MAX whose level budget (from ``budget``) is at
        least 6, from the wide packed ranks and the sampled-PLCP kernel
        where the block alphabet holds and the block has at most 700
        segments, ``levels`` mode otherwise; the level buffer keeps as
        many rows as the text needs and the budget holds (``andix``'s
        TPU cap of 14 rows is not kept); the host Φ LCP after an overflow
        or without the device LCP."""
        dev = self.device
        with spans.span("joint.upload", dev) as up:
            padded_n = bucket(layout.n)
            nseg = len(layout.genome_ids)
            sym, text = ingest.device_text(layout, padded_n, dev,
                                           "joint.text")
            up.set(padded=padded_n)

        lcp_span = spans.NULL

        def sa_done(lev_count, L):
            nonlocal lcp_span
            sa_span.set(levels=lev_count, buffer=L)
            sa_span.end()
            lcp_span = spans.span("joint.lcp", dev, kind=spans.HOST_LCP)

        with spans.span("joint.sa", dev) as sa_span:
            budget = level_budget(padded_n, self.budget)
            use_device_lcp = padded_n <= DEVICE_LCP_MAX and budget >= 6
            # the packed keys need separators within the 10-bit clamp
            packed = nseg <= 700
            wide = packed and alphabet_ok(sym, layout.n)
            mode = "hybrid" if wide else "levels"
            sa, lcp, ovf, may_ovf = doubling.sa_lcp_device(
                sym, packed=packed, max_levels=budget,
                want_lcp=use_device_lcp, lcp_mode=mode,
                base_width=doubling.wide_base_width(nseg, wide),
                on_sa=sa_done)
        del sym
        lcp_span.set(hybrid=int(wide))
        if not use_device_lcp:
            lcp = None
        elif may_ovf and bool(spans.readback(ovf)):
            lcp = None
            lcp_span.set(kind=spans.LCP_OVERFLOW)
            lcp_span.end()
            lcp_span = spans.span("joint.lcp", dev, kind=spans.HOST_LCP)
        else:
            lcp_span.set(kind=spans.LCP)
        if lcp is None:
            lcp = host_lcp(pad_symbols(layout.sym, padded_n), sa,
                           self.threads)
        lcp_span.end()

        with spans.span("joint.tables", dev):
            genomes, q_off, blob, q_start, q_len, q_base = _query_lanes(
                layout)
            segid = _segid(sa, layout.seg_start[1:])
            isa = matchstats.inverse_sa_device(sa)
            qb = bucket(max(int(q_off[-1]), 1))
            tq = _query_slots(isa, q_start, q_off, qb)
            rm = rmq.build(lcp)
        return BlockContext(
            layout=layout, q_genomes=genomes, q_off=q_off, query_blob=blob,
            sa=sa, lcp=lcp, segid=segid, isa=isa, tq=tq, rm=rm, text=text,
            q_start_h=q_start, q_len_h=q_len, q_base_h=q_base,
        )

    def replay_group(self, n_block_subjects: int, qb: int) -> int:
        """Subjects per chain-walk group: as many as the [Sg, QB] x 2 int32
        tables fit in half this worker's share of the free device memory
        (all of them on the CPU), balanced across groups."""
        if self.device.type != "cuda":
            return max(1, n_block_subjects)
        free, _ = torch.cuda.mem_get_info(self.device)
        fit = max(1, (free // 2 // self.share) // (8 * max(qb, 1)))
        if fit >= n_block_subjects:
            return max(1, n_block_subjects)
        k = -(-n_block_subjects // fit)
        return -(-n_block_subjects // k)

    def chain_segments(self, ctx: BlockContext) -> int:
        """Query segments per lane for the segmented walk (same rule and
        ANDIX_CHAIN_SEGMENTS override as the JAX backend)."""
        env = os.environ.get("ANDIX_CHAIN_SEGMENTS", "auto")
        max_qlen = int(np.max(ctx.q_len_h))
        if env != "auto":
            k = int(env)
        elif max_qlen >= 1 << 19:
            k = 8
        elif max_qlen >= 1 << 17:
            k = 4
        else:
            k = 1
        return max(1, min(k, max(max_qlen, 1)))

    def _group_tables(self, ctx, subject_genomes, subjects):
        """Per-subject segment, text base, RS length and threshold, and the
        [Sg, Gp] query-length grid of the group's lanes."""
        layout = ctx.layout
        sg = len(subject_genomes)
        segs = np.zeros(sg, dtype=np.int32)
        starts = np.zeros(sg, dtype=np.int32)
        rs_lens = np.zeros(sg, dtype=np.int32)
        thresholds = np.zeros(sg, dtype=np.int32)
        q_len2d = np.zeros((sg, len(ctx.q_len_h)), dtype=np.int32)
        for k, genome in enumerate(subject_genomes):
            seg = int(np.nonzero(
                (layout.genome_ids == genome) & layout.is_subject
            )[0][0])
            segs[k] = seg
            starts[k] = layout.seg_start[seg]
            rs_lens[k] = subjects[genome].len
            thresholds[k] = subjects[genome].threshold
            q_len2d[k] = ctx.q_len_h
        return segs, starts, rs_lens, thresholds, q_len2d

    def subject_group_counts(self, ctx: BlockContext, subject_genomes,
                             subjects, model_kind, replay: str | None = None):
        """{subject: {query: CountMatrix}} for one subject group, by
        ``andix``'s order (backend_jax.py:576-593): with ``replay``
        ``events`` (the default; ``None`` reads ``ANDIX_REPLAY``) host
        counting from the anchor events of the segmented walk when it
        cuts queries into K > 1 segments, of the unsegmented walk
        (``chain_anchors_device``, one event buffer) when K = 1 or the
        segments do not converge or overflow a dispatch's buffer, and the
        count-in-loop replay where the unsegmented walk overflows too;
        with any other value (``loop``) the count-in-loop replay alone."""
        dev = self.device
        replay = replay or os.environ.get("ANDIX_REPLAY", "events")
        tables = self._group_tables(ctx, subject_genomes, subjects)
        segs, starts = tables[:2]
        with spans.span("joint.subject_tables", dev, subjects=len(segs)):
            mlun, ps = group_subject_tables(ctx.sa, ctx.lcp, ctx.segid,
                                            ctx.tq, segs, starts)
        counts_h = None
        if replay == "events":
            counts_h = self._events_counts(ctx, subject_genomes, subjects,
                                           model_kind, tables, mlun, ps)
        if counts_h is None:
            counts_h = self._loop_counts(ctx, model_kind, tables, mlun, ps)
        del mlun, ps

        out: dict[int, dict[int, CountMatrix]] = {}
        for k, genome in enumerate(subject_genomes):
            row = {}
            for g, qgenome in enumerate(ctx.q_genomes):
                if qgenome == genome:
                    continue
                seq_len = int(ctx.q_off[g + 1] - ctx.q_off[g])
                row[qgenome] = CountMatrix(counts_h[k, g].copy(), seq_len)
            out[genome] = row
        return out

    def _events_counts(self, ctx, subject_genomes, subjects, model_kind,
                       tables, mlun, ps):
        """[Sg, Gp, 16] counts from the anchor events (the segmented walk
        at K > 1, else or after it fails the unsegmented walk) and the
        host count, or None after the unsegmented walk's event
        overflow."""
        dev = self.device
        _, starts, rs_lens, thresholds, q_len2d = tables
        sg, gp = q_len2d.shape
        qb = ctx.tq.shape[0]
        ecap = int(os.environ.get("ANDIX_EVENT_CAP",
                                  str(max(1 << 16, qb // 2))))

        def walk(arr, chunk_iters, maxev):
            with spans.span("walk.dispatch"):
                lanes = {name: spans.upload(arr[name], dev)
                         for name in LANE_FIELDS}
                return fetch_walk(chain_walk_flat(
                    ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, chunk_iters,
                    maxev, ecap, CHASE, UNROLL))

        seg_k = self.chain_segments(ctx)
        with spans.span("joint.walk", dev) as sp:
            res = None
            if seg_k > 1:
                res = segdrive.segmented_group_anchors(
                    walk, sg, gp, qb, starts, rs_lens, thresholds,
                    ctx.q_base_h, ctx.q_start_h, q_len2d, seg_k, ecap)
                if res is not None:
                    sp.set(kind=spans.WALK_SEGMENTED, events=len(res[1]))
            if res is None:
                # K = 1, or the segments did not converge or overflowed:
                # the unsegmented walk, every event into one buffer
                res = self._unsegmented_events(ctx, tables, mlun, ps, ecap,
                                               sp)
            if res is None:
                sp.set(kind=spans.WALK_OVERFLOW, cap=ecap)
                return None
        lanes, ev_q, ev_s, ev_len = res
        q_off_pad = np.full(gp + 1, ctx.q_off[-1], dtype=np.int64)
        q_off_pad[: len(ctx.q_off)] = ctx.q_off
        with spans.span("count", dev, events=ev_q.shape[0]):
            return chain_events.group_counts_from_events(
                lanes, ev_q, ev_s, ev_len, sg, gp,
                [subjects[genome].rs for genome in subject_genomes],
                thresholds, ctx.query_blob, q_off_pad, model_kind,
                self.threads,
            )

    def _unsegmented_events(self, ctx, tables, mlun, ps, ecap, sp):
        """The group's unsegmented walk (``chain_anchors_device``): its
        (lanes, q, s, len) event arrays, or None when its one buffer of
        ``ecap`` events overflowed; its counts go to the walk's span
        ``sp``."""
        _, starts, rs_lens, thresholds, q_len2d = tables
        out = chain_anchors_device(
            ctx.isa, ctx.rm, ctx.text, mlun, ps, starts, rs_lens, thresholds,
            ctx.q_base_h, ctx.q_start_h, q_len2d, ecap, CHASE, UNROLL)
        ev_cnt, ovf, iters = out[4:]
        cnt, ovf_h, iters_h = (int(x) for x in spans.readback(torch.stack(
            [x.to(mlun.device, torch.int32) for x in (ev_cnt, ovf, iters)])))
        if ovf_h:
            return None
        ev = spans.readback(torch.stack([x[:cnt] for x in out[:4]])).numpy()
        sp.set(kind=spans.WALK_UNSEGMENTED, subjects=q_len2d.shape[0],
               loop_iters=iters_h, events=cnt)
        return tuple(ev)

    def _loop_counts(self, ctx, model_kind, tables, mlun, ps):
        """[Sg, Gp, 16] counts from the count-in-loop replay on the
        device (exact equal counts for LogDet and ANI, as
        backend_jax.py:998)."""
        _, starts, rs_lens, thresholds, q_len2d = tables
        with spans.span("joint.walk", self.device, kind=spans.WALK_REPLAY,
                        subjects=q_len2d.shape[0]) as sp:
            lanes = replay_lanes(starts, rs_lens, thresholds, ctx.q_base_h,
                                 ctx.q_start_h, q_len2d, self.device)
            counts, tally = replay_rows(
                ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                model_kind in (Model.LOGDET, Model.ANI), CHASE)
            if sp:
                sp.set(probe_steps=tally[..., 0].max())
            return spans.readback(counts).numpy().astype(np.int64)
