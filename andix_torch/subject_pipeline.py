"""Subject-index schedule: build each subject's index once, stream every
query through the search-in-the-loop chain walk (counterpart of
``andix/subject_pipeline.py``).

andi's own design — one index per subject, queries streamed past it
(src/esa.c:254-277, src/dist_hack.h:64-68):

* query text is never sorted; it lives on the device only as 4-bit
  packed words,
* each subject's SA + LCP is built once per run, not once per joint block
  and query chunk,
* no ``[Sg, QB]`` match-statistics tables.

Subjects are grouped so that the group's resident index (SA + LCP +
words + k-mer caches), one build's transients and the walk's buffers fit
the device's memory budget (``pipeline.memory_budget``); each group walks
all of its (subject, query) pairs through the compiled segmented walk
driver (``chain.segdrive``, exact splicing) over
``chain.walk_sx.chain_walk_flat_sx``, each dispatch's events fetched
packed (``chain.evpack``, ``ANDIX_EVPACK``, as ``andix`` does), and the
16-cell counts come from the same host event counting as the joint
schedule (``chain.events``), so the output is byte-identical across
schedules.

A group the schedule cannot finish goes back to the caller, which runs
it on the joint schedule: after an event-buffer overflow the group is
walked again with a 4x larger buffer, at most twice; when the segmented
resolve does not converge it goes back at once (a larger buffer would not
change the walk); and when the segmented walk is about to repeat a
dispatch with the same inputs, which happens when a probe needs more
iterations than the chunk cap's ceiling (clonal genomes longer than a
few tens of kbp), it goes back at once too, where ``andix`` repeats the
dispatch forever.

With several devices in a single-process run (``andix``'s per-device
drivers, subject_pipeline.py:250-303) the groups are dealt round-robin to
``min(devices, groups)`` worker threads, one per device, each with its own
query words on its device; ``ANDIX_SX_MESH=0`` keeps one worker.  A plan
with fewer groups than workers is split first, so that every worker gets a
group (``plan_worker_groups``).  Every worker plans with the smallest
worker's memory budget, so all build the same caches.  ``LAST_BALANCE``
keeps each group's worker and events and each worker's wall.
"""

from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch

from . import _distributed, ingest, parallel, spans
from .chain import events as chain_events
from .chain import evpack, segdrive
from .chain.replay_device import fetch_walk
from .chain.walk_sx import SX_LANE_FIELDS, chain_walk_flat_sx
from .esa import backend, joint, subject_index
from .esa.backend import bucket, pad_symbols
from .model import CountMatrix
from .runtime import Context

# per worker, its groups and their events, then its wall, in the last run
LAST_BALANCE: list[str] = []

# resident device bytes per padded index symbol: SA 4 + LCP 4 + words 0.5
IDX_BYTES_PER_SYM = 8.5
# peak device bytes per padded index symbol while one subject's index
# builds (the padded text, the prefix-doubling sorts and the level rows,
# then the sampled-PLCP LCP, codes and words), over what the group already
# holds; the k-mer histogram and its prefix sums add four cache sizes.
# The level rows are allocated as the rounds produce them, up to what the
# budget left over holds (``_build_group_index``): a subject whose repeats
# need more takes the host LCP instead.  Measured by chip_smoke.py on an
# H100 80GB HBM3 (700 W; PERF.md): 4 B of text + 60.22 B for the SA + LCP
# stage of a random 5 Mbp genome (one level row).  Each row a genome's
# repeats need adds 4 B; 128 leaves room for about 16 rows.
BUILD_BYTES_PER_PADDED_SYM = 128


def plan_groups(subjects, todo, low_memory: bool, cache_k: int,
                budget: int, fixed_bytes: int) -> list[list[int]]:
    """Pack subject indices into groups whose resident index (rows padded
    to a multiple of 8, each at the group's largest padded length), one
    build's transients and ``fixed_bytes`` (query words, event buffers)
    fit ``budget``.  ``ANDIX_GROUP_SUBJECTS`` caps the subjects per group
    (default 16, 0 = no cap): rows checkpoint when their group completes."""
    if low_memory:
        return [[i] for i in todo]
    cap = int(os.environ.get("ANDIX_GROUP_SUBJECTS", "16"))
    cache_bytes = ((1 << (2 * cache_k)) + 1) * 4

    def need(count: int, lp: int) -> float:
        rows = -(-count // 8) * 8
        return (rows * (lp * IDX_BYTES_PER_SYM + cache_bytes)
                + lp * BUILD_BYTES_PER_PADDED_SYM + 4 * cache_bytes
                + fixed_bytes)

    groups: list[list[int]] = []
    cur: list[int] = []
    cur_lp = 0
    for i in todo:
        lp = max(cur_lp, index_length(subjects[i]))
        if cur and (need(len(cur) + 1, lp) > budget
                    or (cap and len(cur) >= cap)):
            groups.append(cur)
            cur = []
            lp = index_length(subjects[i])
        cur.append(i)
        cur_lp = lp
    if cur:
        groups.append(cur)
    return groups


def plan_worker_groups(subjects, todo, low_memory: bool, cache_k: int,
                       budget: int, fixed_bytes: int, workers: int
                       ) -> tuple[list[list[int]], bool]:
    """``plan_groups``'s plan, split where it has fewer groups than
    ``workers`` (a group's work is its subjects times every query): its
    subjects dealt, in plan order, into ``min(workers, subjects)``
    contiguous groups whose sizes differ by at most one, each planned
    again, so that the memory budget and the cap only ever split further.
    Returns the groups and whether the plan was split."""
    groups = plan_groups(subjects, todo, low_memory, cache_k, budget,
                         fixed_bytes)
    flat = [i for g in groups for i in g]
    k = min(workers, len(flat))
    if k <= len(groups):
        return groups, False
    per, extra = divmod(len(flat), k)
    cuts = [j * per + min(j, extra) for j in range(k + 1)]
    return [g for a, b in zip(cuts, cuts[1:])
            for g in plan_groups(subjects, flat[a:b], low_memory, cache_k,
                                 budget, fixed_bytes)], True


def index_length(subject) -> int:
    """Padded length of a subject's index text, RS + one separator
    (``Subject.len`` is the RS length).  ``andix`` pads to
    ``bucket(2 * len + 2)``, twice the text; the walk never reads past the
    real text, so the shorter padding changes no output."""
    return bucket(subject.len + 1)


def _build_group_index(group, subjects, cache_k: int, device, budget: int,
                       threads: int):
    """Stacked device index of one subject group, rows padded to a
    multiple of 8: (salcp int32[S, 2, Lp], sw int64[S, Lp / 16], cache2
    int32[S, 4^k + 1], nreal int32[S], the number of host LCPs taken).
    Padding rows have nreal 1 and no lanes.  Each subject builds as in
    ``andix`` (subject_pipeline.py:123-170), with the hybrid build, but
    with as many level rows as the subject needs and ``budget`` (bytes,
    less what the group's stacked index holds) allows, where ``andix``
    keeps at most 14 for a TPU's memory; the overflow flags are read once
    for the group, and an overflowed subject's LCP is then taken on the
    host (``backend.host_lcp``).  Each index text is made on ``device``
    (``_index_text``, counted in ``sx.text_device``); the host LCP's
    padded int32 text is made on the host (``sx.text_host``)."""
    rows = -(-len(group) // 8) * 8
    lp = max(index_length(subjects[i]) for i in group)
    salcp = torch.zeros((rows, 2, lp), dtype=torch.int32, device=device)
    sw = torch.zeros((rows, lp // 16), dtype=torch.int64, device=device)
    cache2 = torch.zeros((rows, (1 << (2 * cache_k)) + 1),
                         dtype=torch.int32, device=device)
    nreal = np.ones(rows, dtype=np.int32)
    held = sum(t.numel() * t.element_size() for t in (salcp, sw, cache2))
    # andix's fused build keeps at least one row
    max_levels = max(1, backend.level_budget(lp, budget - held))
    ovf_flags = []
    for k, i in enumerate(group):
        sym, n = _index_text(subjects[i].rs, lp, device)
        nreal[k] = n
        sa, lcp, ovf, words, cache = subject_index.build_subject_index(
            sym, n, cache_k, backend.alphabet_ok(sym, n), max_levels)
        salcp[k, 0] = sa
        salcp[k, 1] = lcp
        sw[k] = words
        cache2[k] = cache
        ovf_flags.append(ovf)
        del sym, sa, lcp, words, cache
    overflowed = spans.readback(torch.stack(ovf_flags)).numpy()
    for k in np.nonzero(overflowed)[0]:
        # pathologically repetitive subject: SA exact, LCP invalid
        layout = joint.build_block({group[k]: subjects[group[k]].rs}, {})
        with spans.span("sx.text"):
            padded = pad_symbols(layout.sym, lp)
        spans.count("sx.text_host")
        salcp[k, 1] = backend.host_lcp(padded, salcp[k, 0], threads)
    return (salcp, sw, cache2, spans.upload(nreal, device),
            int(overflowed.sum()))


def _index_text(rs, lp: int, device) -> tuple[torch.Tensor, int]:
    """(int32 [lp] symbols on ``device``, real symbols n) of a subject's
    index text, ``pad_symbols(joint.build_block({i: rs}, {}).sym, lp)``,
    made as the joint block's text is (``ingest.device_text``) from a view
    of the pinned buffer the ingest read the RS into, else one copy
    (``ingest.block_layout``).  Only the int32 text stays on the device."""
    with spans.span("sx.text"):
        layout = ingest.block_layout({0: rs}, {}, device)
    sym, _ = ingest.device_text(layout, lp, device, "sx.text")
    spans.count("sx.text_device")
    return sym, layout.n


# the lane count that the segment count K aims a dispatch at
# (``_chain_segments``): andix's value, like the walk driver's parameters
LANE_TARGET = 8192


def _chain_segments(max_qlen: int, lanes_base: int) -> int:
    """Segments per lane: the walk iteration's price is a ~0.4-0.9 ms
    FIXED gather-launch term that is nearly lane-count-independent (a
    32k-lane dependent gather costs only ~2x a 512-lane one,
    MICROBENCH_SX.json lane sweep), so K scales the lane count toward
    ~LANE_TARGET, bounded by a minimum segment length (reconciliation
    overhead) and K <= 128."""
    env = os.environ.get("ANDIX_CHAIN_SEGMENTS", "auto")
    if env != "auto":
        return max(1, min(int(env), max(max_qlen, 1)))
    if max_qlen < 1 << 17:
        return 1
    k = 1
    while (
        k < 128
        and lanes_base * (k * 2) <= LANE_TARGET
        and max_qlen // (k * 2) >= 4096
    ):
        k *= 2
    return max(1, min(k, max(max_qlen, 1)))


def cache_depth(subjects, n_todo: int, budget: int) -> int:
    """k-mer cache depth: ``ANDIX_CACHE_K``, else ``pick_cache_k`` with all
    caches together in at most an eighth of the memory budget."""
    env = os.environ.get("ANDIX_CACHE_K")
    if env:
        return int(env)
    # andix's input to the cache depth, kept so both packages pick one k
    max_len = max(s.len * 2 + 2 for s in subjects)
    return subject_index.pick_cache_k(max_len, n_todo, budget // 8)


def _event_cap(total_q: int) -> int:
    """Event-buffer slots of one walk chunk (16 B each): ``ANDIX_EVENT_CAP``
    (any positive value), else half the padded query total, within
    [2^16, 2^25]."""
    env = os.environ.get("ANDIX_EVENT_CAP")
    if env:
        return int(env)
    return min(max(1 << 16, bucket(total_q + 1) // 2), 1 << 25)


def process_subject_index(todo: list[int], seqs, subjects, ctx: Context, M,
                          progress, ckpt, devices) -> list[int]:
    """Run the subject-index schedule for the ``todo`` subject rows on
    ``devices`` (one worker each, see the module docstring; a device listed
    k times carries k workers); returns the rows it could not complete,
    for the caller's joint schedule."""
    from .pipeline import worker_memory

    n = len(seqs)
    total_q = sum(s.len + 1 for s in seqs)
    if total_q + 16 >= 1 << 31:
        # the packed query blob is int32-addressed; larger runs keep the
        # joint schedule, which chunks queries
        return list(todo)
    mesh = (len(devices) > 1 and _distributed.world_size() == 1
            and os.environ.get("ANDIX_SX_MESH", "1") != "0")
    if not mesh:
        devices = devices[:1]
    budget = worker_memory(devices)[1]
    cache_k = cache_depth(subjects, len(todo), budget)

    raw_blob, q_off, qw_base = _host_query_blob(seqs, n)
    gp = max(8, -(-n // 8) * 8)
    q_len_row = np.zeros(gp, dtype=np.int32)
    qw_base_pad = np.zeros(gp, dtype=np.int32)
    q_len_row[:n] = (q_off[1:] - q_off[:-1]).astype(np.int32)
    qw_base_pad[:n] = qw_base
    q_off_pad = np.full(gp + 1, q_off[-1], dtype=np.int64)
    q_off_pad[: n + 1] = q_off
    ecap = _event_cap(int(q_off[-1]))
    # the packed query words (``_pack_query_words``): the queries, one
    # sentinel each and 16 to 31 more, 16 symbols in 8 bytes
    qw_syms = int(q_off[-1]) + n
    qw_syms += (-qw_syms) % 16 + 16

    with spans.span("sx.plan") as sp:
        groups, split = plan_worker_groups(
            subjects, todo, ctx.low_memory, cache_k, budget,
            qw_syms // 2 + 16 * ecap, len(devices))
        n_workers = min(len(devices), len(groups))
        sp.set(groups=len(groups), workers=n_workers,
               largest_group=max(map(len, groups)), split=int(split))
    leftovers: list[int] = []
    lock = threading.Lock()
    meter = parallel.LockedProgress(progress) if progress is not None else None
    LAST_BALANCE.clear()

    def work(w: int) -> None:
        device = devices[w]
        with spans.span("sx.query_words", device):
            qw = _pack_query_words(seqs, qw_base, device)
        for group in groups[w::n_workers]:
            events = _process_group(group, qw, subjects, ctx, M, meter, ckpt,
                                    cache_k, ecap, n, gp, q_len_row,
                                    qw_base_pad, q_off, q_off_pad, raw_blob,
                                    device, budget, n_workers)
            status = ("to the joint schedule" if events is None
                      else f"{events} events")
            with lock:
                if events is None:
                    leftovers.extend(group)
                LAST_BALANCE.append(f"worker {w} on {device} group"
                                    f"[{group[0]}..{group[-1]}]: {status}")

    parallel.load_libraries(devices[:n_workers])
    walls = parallel.run_workers([functools.partial(work, w)
                                  for w in range(n_workers)],
                                 devices[:n_workers])
    LAST_BALANCE.extend(f"worker {w} on {devices[w]}: wall {wall:.3f} s"
                        for w, wall in enumerate(walls))
    return sorted(leftovers)


def _host_query_blob(seqs, n):
    q_off = np.zeros(n + 1, dtype=np.int64)
    qw_base = np.zeros(n, dtype=np.int32)
    pos = 0
    for g in range(n):
        q_off[g + 1] = q_off[g] + len(seqs[g].data)
        qw_base[g] = pos
        pos += len(seqs[g].data) + 1
    raw = np.concatenate(
        [np.asarray(seqs[g].data, dtype=np.uint8) for g in range(n)]
    ) if n else np.zeros(0, np.uint8)
    return raw, q_off, qw_base


def _pack_query_words(seqs, qw_base, device) -> torch.Tensor:
    """Sentinel-injected packed query words on ``device``: each query is
    followed by one sentinel (code 0), and the blob by at least 16 more.
    The blob is zeroed on the device and each query's bytes (views of the
    ingest's pinned buffer where it read them) copied to its slice at
    ``qw_base``."""
    n = len(qw_base)
    size = int(qw_base[-1]) + len(seqs[n - 1].data) + 1 if n else 0
    size += (-size) % 16 + 16
    blob = torch.zeros(size, dtype=torch.uint8, device=device)
    for g in range(n):
        a = int(qw_base[g])
        spans.upload(np.asarray(seqs[g].data, dtype=np.uint8), device,
                     out=blob[a: a + len(seqs[g].data)])
    return subject_index.pack_words_u8(blob)


def _fetch_events(ev4, cnt: int, lb: int, ecap: int) -> np.ndarray:
    """A walk dispatch's [4, cnt] (lane, q, s, len) events on the host,
    fetched as ``andix`` fetches them on this schedule
    (subject_pipeline.py:474-516): with ``ANDIX_EVPACK`` other than 0,
    packed on the device (``chain.evpack``, about 6 B an event), one copy,
    decoded on the host in lane-major order; after an escape overflow,
    and with ``ANDIX_EVPACK=0``, the raw int32 buffers in buffer order.
    Either order gives every lane its events in chain order."""
    if os.environ.get("ANDIX_EVPACK", "1") != "0":
        k = min(bucket(max(cnt, 1), 4096), ecap)
        flat = spans.readback(
            evpack.encode_events_flat(*ev4, cnt, k, lb)).numpy()
        packed, esc, counts, n_esc, esc_ovf = evpack.split_encoded(flat, k,
                                                                   lb)
        if not esc_ovf:
            return np.stack(evpack.decode_events(packed, esc, counts,
                                                 int(n_esc), cnt))
    return spans.readback(torch.stack([x[:cnt] for x in ev4])).numpy()


class _Stalled(Exception):
    """The segmented walk was about to repeat a dispatch that advanced no
    lane."""


def _process_group(group, qw, subjects, ctx, M, progress, ckpt, cache_k,
                   ecap, n, gp, q_len_row, qw_base_pad, q_off, q_off_pad,
                   raw_blob, device, budget, workers) -> int | None:
    """Build, walk and count one subject group and publish its rows;
    returns its event count, or None when the group goes back to the joint
    schedule.  The segment count fills the lanes of all ``workers`` at
    once, each walking a group like this one, toward ``LANE_TARGET``: the
    cards walk side by side, but every segment's reconciliation is host
    work the workers share under one interpreter lock, so a smaller group
    a worker must not take more segments."""
    with spans.span("sx.index", device, subjects=len(group)) as sp:
        salcp, sw, cache2, nreal, n_host = _build_group_index(
            group, subjects, cache_k, device,
            budget - qw.numel() * qw.element_size(), ctx.threads)
        sp.set(host_lcp=n_host)
    sg = salcp.shape[0]

    rs_lens = np.ones(sg, dtype=np.int32)
    thresholds = np.full(sg, 2**29, dtype=np.int32)
    q_len2d = np.zeros((sg, gp), dtype=np.int32)
    for k, i in enumerate(group):
        rs_lens[k] = subjects[i].len
        thresholds[k] = subjects[i].threshold
        q_len2d[k] = q_len_row
        q_len2d[k, i] = 0  # diagonal pair skipped
    seg_k = _chain_segments(
        int(q_len_row.max()) if n else 0,
        len(group) * max(n - 1, 1) * workers
    )

    overflowed = False
    idle_cap = None  # the iteration cap of a dispatch that advanced no lane

    def walk(arr, chunk_iters, maxev):
        nonlocal overflowed, idle_cap
        # the driver re-issues the lanes a dispatch leaves unfinished;
        # after a dispatch that advanced none of them, one at the same cap
        # returns the same, and so on forever: a probe needs more
        # iterations than the chunk cap's ceiling (a long exact match, as
        # between clonal genomes)
        if chunk_iters == idle_cap:
            raise _Stalled
        with spans.span("walk.dispatch"):
            # the driver's query start ("qs") is the lane's base in qw
            # symbols
            lanes = {name: spans.upload(arr["qs" if name == "qwb" else name],
                                        device)
                     for name in SX_LANE_FIELDS}
            res = fetch_walk(chain_walk_flat_sx(
                salcp, sw, cache2, nreal, qw, lanes, chunk_iters, maxev,
                cache_k, ecap_now,
            ), functools.partial(_fetch_events, ecap=ecap_now))
        overflowed |= res[4]
        ev, state, fin = res[:3]
        live = arr["pos0"] < arr["seg_end"]
        moved = (ev.shape[1] > 0 or fin[live].any() or any(
            (state[j][live] != arr[f][live]).any()
            for j, f in enumerate(("pos0", "lq0", "ls0", "ll0"))))
        idle_cap = None if moved else chunk_iters
        return res

    ecap_now = ecap
    with spans.span("sx.walk", device, kind=spans.NO_LINE,
                    segments=seg_k) as walk_span:
        for escalation in range(3):
            overflowed = False
            idle_cap = None
            try:
                res = segdrive.segmented_group_anchors(
                    walk, sg, gp, 0, np.zeros(sg, np.int32), rs_lens,
                    thresholds, qw_base_pad, qw_base_pad, q_len2d, seg_k,
                    ecap_now)
            except _Stalled:
                walk_span.set(kind=spans.SX_STALLED)
                return None
            if res is not None:
                break
            if not overflowed or escalation == 2:
                # the resolve did not converge (a wider buffer would walk
                # the same way), or the buffer still overflowed
                return None
            ecap_now *= 4
        walk_span.set(kind=spans.SX_WALKED, events=len(res[1]))
    del salcp, sw, cache2
    lanes, ev_q, ev_s, ev_len = res

    subjects_rs = [subjects[i].rs for i in group] + [None] * (sg - len(group))
    with spans.span("sx.count", device, events=ev_q.shape[0]):
        counts_h = chain_events.group_counts_from_events(
            lanes, ev_q, ev_s, ev_len, sg, gp, subjects_rs, thresholds,
            raw_blob, q_off_pad, ctx.model, ctx.threads,
        )

    for k, i in enumerate(group):
        row = {}
        for g in range(n):
            if g == i:
                continue
            seq_len = int(q_off[g + 1] - q_off[g])
            row[g] = CountMatrix(counts_h[k, g].copy(), seq_len)
        for g, cm in row.items():
            M[i][g] = cm
        if progress is not None:
            progress.advance(len(row))
        if ckpt is not None:
            ckpt.save_row(i, n, row)
    return int(ev_q.shape[0])
