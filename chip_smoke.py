"""Drive andix_torch's two schedules once on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, one
line each; any failed phase raises and the script exits non-zero:

1. require a CUDA device; print nvidia-smi's name and power limit;
2. build the kernels from ``andix_torch/csrc`` (nvcc, sm_90a, one process
   per source) and time it;
3. hold each kernel to its plain PyTorch version on the card, exactly:
   the flag scan at n in {64, 333, 4097, 70001, 2^24, 100,663,296} (the
   padded joint blocks of 8 x 1 and 8 x 5 Mbp), the chain walk over
   every lane of a
   3 x 20 kbp family (whole, truncated, and with its event buffer ending
   inside a staging batch) and over the first segmented dispatch of the
   8 x 1 Mbp and of the 8 x 5 Mbp joint runs; the search walk over a
   3 x 20 kbp subject-index group (whole, cut by max_iters=13 with
   max_events=1, and overflowing an 8-slot and a 50-slot event buffer)
   and over the first segmented dispatch of the 8 x 1 Mbp and of the
   8 x 5 Mbp subject-index runs; the sampled-PLCP LCP over the padded
   joint texts of 8 x 1 Mbp (2^24) and 8 x 5 Mbp (100,663,296) and of the
   8 x 1 Mbp clonal family (g1 = g0) with every level row it needs (its
   LCP also equal to the host Φ LCP) and cut to andix's 14 rows (entries
   left open, the overflow flag up), LCP and overflow flag; on each of
   those texts first the doubling loop's kernels (sa_keys, sa_rerank
   and its partitioned rank scatter's sa_pair_scatter) against the plain
   loop: SA, every level row, the level count and the overflow flag,
   with each round's kind, entries, tied count and the ms of its key
   build, sort, rerank and pair scatter and the kernels' byte bound; one
   full round's pairs scattered by the kernel and by index_put_; the
   range-min build over the 8 x 1 and 8 x 5 Mbp joint LCPs, every array
   it makes; print the times, the walks' counts and each kernel's byte
   bound from the data of its run;
4. one 1 Mbp subject's index built (hybrid: wide ranks, sampled-PLCP
   LCP) on the card and on the CPU: SA, LCP, words and cache equal; the
   build's levels and peak bytes per padded index symbol at 1 Mbp and
   5 Mbp; then a 1 Mbp subject made of one 500 kbp block twice over,
   whose own index needs 17 level rows, built as its group is: on the
   card with every row (the kernel's LCP), on the card with the level
   budget cut to andix's 14 rows (overflow, the host LCP) and on the CPU;
   all three equal;
5. a 4 x 30 kbp family with a duplicate and an unrelated genome through
   ``andix_torch.cli.main`` with ``--backend cuda`` and ``--backend cpu``:
   the PHYLIP bytes must be identical; then again with a ``--block-size``
   that splits the joint plan, so ``ANDIX_INDEX=auto`` picks the subject
   index;
6. the 8 x 1 Mbp synthetic family (the repository's benchmark size)
   through ``andix_torch.cli.main -m JC`` on the card: wall and per-phase
   seconds, peak device memory, bytes per padded symbol, kernel launch
   counts (each of the joint path's > 0), and a check of the matrix
   against the simulated rates; then the same family under
   ``ANDIX_INDEX=subject``, byte-identical;
7. the full-size path: 8 x 5 Mbp (bacterial genome length) through the
   CLI under ``ANDIX_INDEX=subject`` and ``ANDIX_INDEX=joint``:
   byte-identical PHYLIP, wall, phases, peak memory and launch counts of
   each (the subject run launches the search walk and never the joint
   walk), and the matrix check; then the repeat family (8 x 5 Mbp with
   g1 = g0) on both schedules (``phase_repeat``): the joint block's LCP
   from the kernel over every level row it needs, equal to the host Φ
   LCP that a 14-row budget retreats to; the subject schedule with one
   subject a group, whose groups of g0 and g1 stall and go to the joint
   schedule; the same bytes from both; the block's SA and LCP on the CPU
   backend too, and its doubling loop's kernels against the plain loop
   (SA, all 20 level rows, count, flag), round by round timed; and an
   8 x 50 kbp copy on both schedules, card and CPU;
   before the repeat family, the count-in-loop replay (``phase_replay``):
   the kernel against its plain version over every lane of the 8 x 50 kbp
   family and of 8 x 1 Mbp (JC and LogDet) and of the small family's
   clonal copy (LogDet), exactly; the loop path's counts against the
   events path's at 8 x 1 and 8 x 5 Mbp (JC and LogDet) with the kernel's
   times, each pass's, its query segments K and its splice counters, and
   in JC the same counts at K = 1, 8, 16 and 32; the CLI at both sizes
   under ``ANDIX_REPLAY=loop`` (phases 6 and 7's bytes, one replay launch and
   no walk launch, the loop phase beside the events run's walk and host
   count) and at 8 x 1 Mbp with ``ANDIX_EVENT_CAP=64`` (the buffer
   overflows and the replay kernel counts); after it, the 8 x 5 Mbp CLI
   under ``ANDIX_CHAIN_SEGMENTS=1`` (``andix``'s unsegmented events walk,
   one launch, every event in one buffer: the default run's bytes,
   ``phase_unsegmented``); the packed event fetch (``phase_evpack``): at
   8 x 1 and 8 x 5 Mbp on the subject index, the encode kernel against
   its plain version on every dispatch, exactly, with each dispatch's
   events, bytes fetched raw and packed, encode, copy and decode times,
   then three runs of each fetch (``ANDIX_EVPACK=1`` and ``0``) in turns,
   each with the joint bytes, and their "sx: segmented walk" phases; and
   the device bootstrap resampler (``phase_bootstrap``) at 406 pairs x
   1000 rounds, its properties and the kernel == its host twin == its
   plain version;
8. the pair grid over several workers.  It prints
   ``torch.cuda.device_count()`` and the worker layout: with two or more
   cards the workers are the cards and the CLI runs with every card
   visible; with one card two workers share cuda:0 through
   ``pipeline.calculate_matrix(devices=...)`` (peer placement is then not
   exercised).  The 8 x 5 Mbp joint grid (sharded, a contiguous share of
   subjects a worker) and the subject-index schedule under
   ``ANDIX_GROUP_SUBJECTS=4`` (two groups, two workers) each run four
   times in turns, one worker (this call's baseline), all workers, all
   workers, one worker; every run must print phase 7's bytes, and every
   worker's card must launch the schedule's kernels; printed: the walls,
   and per run over several workers each card's launch counts and peak
   memory and each worker's wall (``LAST_BALANCE``).  Then ``python -m
   andix_torch.cli`` as two processes at 8 x 1 Mbp (torchrun's variables,
   gloo on loopback; rank r on card r % device_count): both exit 0, rank
   0 prints phase 6's bytes and rank 1 nothing.

The line before the last is the kernel table as one JSON object; the
last line is ``{"ok": true, "device": {...}}``.  On a host with several
cards the same command runs phase 8 over all of them.

``bound_ms`` is the least time the card could take for a kernel's work:
the bytes it must move (each input read once, each output written once;
for the walks, what this run's data needs, counted as set out at
``walk_bound`` and ``sx_bound``) over the H100's 3.35 TB/s.  The walks
and the scan do a few integer operations per byte, so bytes bound them.
The sampled-PLCP LCP's bytes are the text and SA read and the LCP
written, 12 B a position, and the level entries the samples' walks read,
8 B a sample and row.  The range-min build's are the values read and its
arrays written once (``rmq_bound``).  The replay's are set out at
``replay_bound``; its row reports the kernel, the plain version and the
bound from the plain run's counts at 8 x 1 Mbp in JC.  The doubling
loop's two kernels' are counted round by round (``sa_kernel_bytes``);
their rows report each kernel's ms summed over one loop at 8 x 1 Mbp
(2^24) and, as ``plain_ms``, the plain loop's (the same sorts and the
torch passes the two kernels replace).  The packed
encode's are 16 B a live event read and its output written
(``evpack_bound``), at the 8 x 5 Mbp run's largest dispatch.  The
resampler's bound is the larger of its bytes and its float64 operations
(``boot_bound``).  No single PyTorch call computes any of the ten
functions (``torch.binomial`` draws one binomial an element, so a
resample that keeps each pair's total would take 15 calls), so
``library_ms`` is null.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
RATES = [0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# andix's hybrid level buffer (a TPU's memory cap), which the phases cut
# the port's to where they show the overflow and the host LCP
ANDIX_ROWS = 14


def say(msg: str) -> None:
    print(msg, flush=True)


def make_family(n_genomes: int, length: int, seed: int = 2026):
    """The benchmark family of bench.py: g0 random, g_k = g0 with
    substitutions at RATES[(k - 1) % 7]."""
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    seqs = [("g0", base)]
    for k in range(1, n_genomes):
        rate = RATES[(k - 1) % len(RATES)]
        codes = np.searchsorted(NUCL, base)
        hit = rng.random(length) < rate
        seqs.append((f"g{k}", NUCL[(codes + np.where(
            hit, rng.integers(1, 4, length), 0)) % 4]))
    return seqs


def write_fasta(directory: str, seqs) -> list[str]:
    paths = []
    for name, data in seqs:
        path = os.path.join(directory, f"{name}.fa")
        with open(path, "w") as f:
            f.write(f">{name}\n{data.tobytes().decode()}\n")
        paths.append(path)
    return paths


def run_cli(args: list[str]) -> tuple[int, str]:
    from andix_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(args)
    return code, buf.getvalue()


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a_list, b_list) -> int:
    err = 0
    for a, b in zip(a_list, b_list):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def phase_flag_scan(dev):
    """The flag scan against its plain version at every n, all, no and
    10% flags, forward and reverse; timed at n = 2^24 (the 8 x 1 Mbp joint
    block) and at the 8 x 5 Mbp joint block's padded length.  Returns
    (kernel ms, plain ms, max_abs_err, bound ms) at n = 2^24."""
    from andix_torch.esa import scans
    from andix_torch.esa.backend import bucket

    rng = np.random.default_rng(7)
    timed = (1 << 24, bucket(8 * (2 * 5_000_000 + 2)))
    timing = {}
    for n in (64, 333, 4097, 70001) + timed:
        vals = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
        pay = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
        cases = {"all": torch.ones(n, dtype=torch.bool),
                 "none": torch.zeros(n, dtype=torch.bool),
                 "p0.1": torch.from_numpy(rng.random(n) < 0.1)}
        v, p = vals.to(dev), pay.to(dev)
        del vals, pay
        for label, fl in cases.items():
            f = fl.to(dev)
            for reverse in (False, True):
                got = scans.flag_scan(v, f, p, reverse=reverse)
                if reverse:
                    ref = [x.flip(0) for x in scans.flag_scan_plain(
                        v.flip(0), f.flip(0), p.flip(0))]
                else:
                    ref = scans.flag_scan_plain(v, f, p)
                torch.cuda.synchronize()
                err = max_abs_err(got, ref)
                del got, ref
                if err:
                    raise AssertionError(
                        f"flag_scan n={n} flags={label} reverse={reverse}: "
                        f"max_abs_err {err}")
        say(f"flag_scan n={n}: kernel == plain (all/none/10% flags, "
            f"forward and reverse)")
        if n in timed:
            f = cases["p0.1"].to(dev)
            ms = cuda_ms(lambda: scans.flag_scan(v, f, p), 20)
            plain_ms = cuda_ms(lambda: scans.flag_scan_plain(v, f, p), 3)
            # values, payload (int32) and flags (bool) in; k, g, sa, suf
            # (int32) out
            bound_ms = 25 * n / HBM_BYTES_PER_S * 1e3
            timing[n] = (ms, plain_ms, 0, bound_ms)
            say(f"flag_scan n={n} (10% flags): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (25 B per "
                f"position) = {100 * bound_ms / ms:.1f}% of the kernel")
        del v, p, cases
        torch.cuda.empty_cache()
    return timing[1 << 24]


def _walk_lanes(ctx, be, subjects, genomes, dev, k=1):
    """Every (subject, query) lane of a block cut into k segments with the
    segmented walk's first-pass (cold) entries."""
    from andix_torch.chain import segmented

    segs, starts, rs_lens, thresholds, q_len2d = be._group_tables(
        ctx, genomes, dict(enumerate(subjects)))
    arr = {n: [] for n in ("row", "qoff", "qs", "ss", "rl", "thr",
                           "seg_end", "pos0", "lq0", "ls0", "ll0")}
    for s in range(len(genomes)):
        thr = int(thresholds[s])
        for g in range(q_len2d.shape[1]):
            for j, (st, en) in enumerate(
                    segmented.plan_segments(int(q_len2d[s, g]), k)):
                entry = (0, 0, 0, 0) if j == 0 else segmented._entry_arrays(
                    segmented._canon(st, -segmented.BIG, 0, thr))
                for name, val in zip(arr, (s, ctx.q_base_h[g],
                                           ctx.q_start_h[g], starts[s],
                                           rs_lens[s], thr, en) + entry):
                    arr[name].append(int(val))
    lanes = {n: torch.tensor(v, dtype=torch.int32, device=dev)
             for n, v in arr.items()}
    return lanes, segs, starts


def _per_lane(out, lb):
    ev = torch.stack([x[: int(out[4])] for x in out[:4]]).cpu().numpy()
    order = np.argsort(ev[0], kind="stable")
    ev = ev[:, order]
    bounds = np.searchsorted(ev[0], np.arange(lb + 1))
    return [ev[1:, bounds[i]: bounds[i + 1]] for i in range(lb)]


def _walk_block(dev, n_genomes, length, seed, k):
    from andix_torch.chain import replay_device as rd
    from andix_torch.esa import joint
    from andix_torch.esa.backend import TorchBackend
    from andix_torch.sequence import Seq, subject_init

    seqs = [Seq(d, name) for name, d in make_family(n_genomes, length, seed)]
    subjects = [subject_init(s, 0.025) for s in seqs]
    be = TorchBackend(dev)
    ctx = be.prepare_block(joint.build_block(
        {i: subjects[i].rs for i in range(n_genomes)}, {}))
    genomes = list(range(n_genomes))
    lanes, segs, starts = _walk_lanes(ctx, be, subjects, genomes, dev, k)
    mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                       segs, starts)
    return ctx, lanes, mlun, ps


def walk_bound(counts, lanes: int) -> tuple[int, float]:
    """Bytes a flat-walk dispatch must move, from the plain run's counts
    (each table entry counted once), and their time at the card's memory
    rate: 4 B per mlun entry read (by the hop chain, or at a probe without
    a lucky anchor), 4 B of ps per anchor taken from the table, per lucky
    check the fewer of its compared text bytes and 16 B of ISA and
    range-min entries, 16 B per event written, and per lane 44 B of entry
    fields read and 17 B of exit state written."""
    nbytes = (4 * (counts["hops"] + counts["table_probes"]
                   + counts["table_anchors"])
              + counts["lucky_bytes"] + 16 * counts["events"] + 61 * lanes)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _compare_walk(label, ctx, lanes, mlun, ps, iters, maxev, ecap):
    """Hold the kernel to the plain version on the same lanes; returns
    both as zero-argument callables for timing, and the plain run's
    counts (``chain_walk_flat_plain``'s ``counts``)."""
    from andix_torch import kernels
    from andix_torch.chain import replay_device as rd

    diag_win = kernels.cuda_lib().andix_walk_diag_win()

    def kernel():
        return rd.chain_walk_flat(ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                                  iters, maxev, ecap, 4, 4)

    def plain(counts=None):
        return rd.chain_walk_flat_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                        lanes, iters, maxev, ecap, 4, 4,
                                        counts, diag_win)

    lb = lanes["row"].shape[0]
    counts = {}
    got, ref = kernel(), plain(counts)
    torch.cuda.synchronize()
    scal = [int(got[i]) for i in (4, 5, 6)]
    if scal != [int(ref[i]) for i in (4, 5, 6)] or scal[1] != (
            scal[0] > ecap):
        raise AssertionError(f"walk {label}: (ev_cnt, ovf, iters) {scal} != "
                             f"{[int(ref[i]) for i in (4, 5, 6)]}")
    err = max_abs_err(got[7:], ref[7:])
    whole = ref
    if scal[1]:
        # past ecap the buffer is full and each lane keeps a prefix of its
        # chain (a lane's slots rise along it), which slots differ by run
        whole = rd.chain_walk_flat_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                         lanes, iters, maxev, scal[0], 4, 4)
    kept = _per_lane(got, lb)
    if sum(a.shape[1] for a in kept) != min(scal[0], ecap):
        raise AssertionError(f"walk {label}: {ecap} slots not all kept")
    for a, b in zip(kept, _per_lane(whole, lb)):
        if a.shape[1] > b.shape[1] or (a != b[:, :a.shape[1]]).any() or (
                not scal[1] and a.shape != b.shape):
            raise AssertionError(f"walk {label}: a lane's events differ")
    if err:
        raise AssertionError(f"walk {label}: exit state max_abs_err {err}")
    say(f"chain_walk_flat {label}, {lb} lanes, max_iters={iters} "
        f"max_events={maxev} ecap={ecap}: kernel == plain ({scal[0]} "
        f"events, overflow {bool(scal[1])}, {scal[2]} probe steps)")
    return kernel, plain, counts


def _walk_dispatch(dev, length, big):
    """The joint run's first segmented dispatch of 8 x ``length``: 64 lanes
    x 8 cold segments, the segmented walk's first chunk cap (768
    iterations) and its default event buffer (QB / 2); kernel == plain,
    both timed, the plain run's counts and the byte bound printed.
    Returns (kernel ms, plain ms, bound ms)."""
    ctx, lanes, mlun, ps = _walk_block(dev, 8, length, 2026, 8)
    label = f"8x{length // 1_000_000}Mbp first dispatch"
    kernel, plain, counts = _compare_walk(label, ctx, lanes, mlun, ps, 768,
                                          big, ctx.tq.shape[0] // 2)
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1, warm=False)
    lb = lanes["row"].shape[0]
    nbytes, bound_ms = walk_bound(counts, lb)
    say(f"chain_walk_flat {label}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    say(f"  counts {json.dumps(counts)}; {nbytes} B to move -> bound "
        f"{bound_ms:.6f} ms ({100 * bound_ms / ms:.3f}% of the kernel)")
    del ctx, lanes, mlun, ps
    torch.cuda.empty_cache()
    return ms, plain_ms, bound_ms


def phase_walk(dev):
    big = 1 << 28
    ctx, lanes, mlun, ps = _walk_block(dev, 3, 20_000, 5, 1)
    for iters, maxev, ecap in ((big, big, 1 << 16), (16, 1, 1 << 16),
                               (big, big, 50)):
        _compare_walk("3x20kbp", ctx, lanes, mlun, ps, iters, maxev, ecap)
    del ctx, lanes, mlun, ps
    ms, plain_ms, bound_ms = _walk_dispatch(dev, 1_000_000, big)
    ms5, _, _ = _walk_dispatch(dev, 5_000_000, big)
    return (ms, plain_ms, 0, bound_ms, ms5)


def _sx_walk_setup(dev, n_genomes, length, seed):
    """The family's subject-index group on ``dev``, with the schedule's own
    cache depth, segment count and event cap, and the lanes of its first
    segmented dispatch: every (subject, query) lane cut into K cold
    segments, padded to the driver's lane bucket."""
    from andix_torch import pipeline
    from andix_torch import subject_pipeline as sp
    from andix_torch.chain import segmented, walk_sx
    from andix_torch.sequence import Seq, subject_init

    seqs = [Seq(d, name) for name, d in make_family(n_genomes, length, seed)]
    subjects = [subject_init(s, 0.025) for s in seqs]
    n = len(seqs)
    cache_k = sp.cache_depth(subjects, n, pipeline.memory_budget(dev))
    salcp, sw, cache2, nreal, _ = sp._build_group_index(
        list(range(n)), subjects, cache_k, dev, pipeline.memory_budget(dev),
        0)
    raw, q_off, qw_base = sp._host_query_blob(seqs, n)
    qw = sp._pack_query_words(raw, q_off, n, dev)
    q_len = q_off[1:] - q_off[:-1]
    k = sp._chain_segments(int(q_len.max()), n * (n - 1))
    arr = {name: [] for name in walk_sx.SX_LANE_FIELDS}
    for s in range(n):
        thr = int(subjects[s].threshold)
        for g in range(n):
            if g == s:
                continue
            for j, (st, en) in enumerate(
                    segmented.plan_segments(int(q_len[g]), k)):
                entry = (0, 0, 0, 0) if j == 0 else segmented._entry_arrays(
                    segmented._canon(st, -segmented.BIG, 0, thr))
                vals = (s, qw_base[g], subjects[s].len, thr, en) + entry
                for name, v in zip(walk_sx.SX_LANE_FIELDS, vals):
                    arr[name].append(int(v))
    lb = segmented._lane_bucket(len(arr["row"]))
    pad = {"rl": 1, "thr": segmented.BIG}
    lanes = {name: torch.tensor(v + [pad.get(name, 0)] * (lb - len(v)),
                                dtype=torch.int32, device=dev)
             for name, v in arr.items()}
    return ((salcp, sw, cache2, nreal, qw), lanes, cache_k,
            sp._event_cap(int(q_off[-1])), k)


def _compare_sx(label, index, lanes, iters, maxev, cache_k, ecap):
    """Hold the search-walk kernel to its plain version on the same lanes
    (with a full event buffer, each lane must keep a prefix of its chain);
    returns (kernel, plain, max_abs_err, overflowed, the plain run's
    counts)."""
    from andix_torch.chain import walk_sx

    def kernel():
        return walk_sx.chain_walk_flat_sx(*index, lanes, iters, maxev,
                                          cache_k, ecap)

    def plain(counts=None, cap=ecap):
        return walk_sx.chain_walk_flat_sx_plain(*index, lanes, iters, maxev,
                                                cache_k, cap, counts)

    lb = lanes["row"].shape[0]
    counts = {}
    got, ref = kernel(), plain(counts)
    torch.cuda.synchronize()
    scal = [int(got[i]) for i in (4, 5, 6)]
    if scal != [int(ref[i]) for i in (4, 5, 6)] or scal[1] != (
            scal[0] > ecap):
        raise AssertionError(f"walk_sx {label}: (ev_cnt, ovf, iters) {scal}"
                             f" != {[int(ref[i]) for i in (4, 5, 6)]}")
    err = max_abs_err(got[7:], ref[7:])
    whole = plain(cap=scal[0]) if scal[1] else ref
    kept = _per_lane(got, lb)
    if sum(a.shape[1] for a in kept) != min(scal[0], ecap):
        raise AssertionError(f"walk_sx {label}: {ecap} slots not all kept")
    for a, b in zip(kept, _per_lane(whole, lb)):
        if a.shape[1] > b.shape[1] or (a != b[:, :a.shape[1]]).any() or (
                not scal[1] and a.shape != b.shape):
            raise AssertionError(f"walk_sx {label}: a lane's events differ")
    if err:
        raise AssertionError(f"walk_sx {label}: exit state max_abs_err "
                             f"{err}")
    say(f"chain_walk_flat_sx {label}, {lb} lanes, cache_k={cache_k}, "
        f"max_iters={iters} max_events={maxev} ecap={ecap}: kernel == plain "
        f"({scal[0]} events, overflow {bool(scal[1])}, {scal[2]} "
        f"iterations)")
    return kernel, plain, err, bool(scal[1]), counts


def _sx_dispatch(dev, length):
    """The 8 x ``length`` subject-index run's first segmented dispatch: 56
    lanes x K cold segments in the driver's lane bucket, its
    first chunk cap and event buffer; kernel == plain, both timed, the
    plain run's counts and the complete byte bound printed.  Returns
    (kernel ms, plain ms, max_abs_err, bound ms)."""
    from andix_torch.chain import segmented

    index, lanes, cache_k, ecap, k = _sx_walk_setup(dev, 8, length, 2026)
    label = f"8x{length // 1_000_000}Mbp first dispatch"
    kernel, plain, err, _, counts = _compare_sx(
        f"{label} (K={k})", index, lanes, segmented.CHUNK_ITERS,
        segmented.BIG, cache_k, ecap)
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
    nbytes, bound_ms = sx_bound(counts, lanes["row"].shape[0])
    probes = max(counts["probes"], 1)
    say(f"chain_walk_flat_sx {label}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    say(f"  counts {json.dumps(counts)}; {counts['bis_steps'] / probes:.4f} "
        f"bisection steps and {counts['words'] / probes:.4f} compared words "
        f"a probe; {nbytes} B to move -> bound {bound_ms:.6f} ms "
        f"({100 * bound_ms / ms:.3f}% of the kernel)")
    del index, lanes
    torch.cuda.empty_cache()
    return ms, plain_ms, err, bound_ms


def phase_walk_sx(dev):
    big = 1 << 28
    index, lanes, cache_k, _, _ = _sx_walk_setup(dev, 3, 20_000, 5)
    for iters, maxev, ecap in ((big, big, 1 << 16), (13, 1, 1 << 16),
                               (big, big, 8), (big, big, 50)):
        ovf = _compare_sx("3x20kbp", index, lanes, iters, maxev, cache_k,
                          ecap)[3]
        if ovf != (ecap < 64):
            raise AssertionError(f"walk_sx 3x20kbp ecap={ecap}: overflow "
                                 f"{ovf}")
    del index, lanes
    timing = _sx_dispatch(dev, 1_000_000)
    _sx_dispatch(dev, 5_000_000)
    return timing


def sx_bound(counts, lanes: int) -> tuple[int, float]:
    """Bytes a search-walk dispatch must move, from the plain run's counts
    (each index entry counted once over the dispatch), and their time at
    the card's memory rate: 4 B per suffix array, LCP and cache entry
    read, 8 B per subject and query word read, 16 B per event written, and
    per lane 36 B of entry fields read and 17 B of exit state written."""
    nbytes = (4 * (counts["sa"] + counts["lcp"] + counts["cache"])
              + 8 * (counts["sw"] + counts["qw"]) + 16 * counts["events"]
              + 53 * lanes)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _joint_text(dev, fam, max_levels=None):
    """A family's joint text as the CLI's one block holds it (every genome
    a subject), padded, on the card; its SA and level rows as
    ``prepare_block`` builds them (every row the text needs, or at most
    ``max_levels``); the base width."""
    from andix_torch.esa import doubling, joint
    from andix_torch.esa.backend import bucket, pad_symbols
    from andix_torch.sequence import Seq, subject_init

    subjects = [subject_init(Seq(d, name), 0.025) for name, d in fam]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    padded = bucket(layout.n)
    sym = torch.from_numpy(pad_symbols(layout.sym, padded)).to(dev)
    base = doubling.wide_base_width(len(layout.genome_ids), True)
    L = doubling.plan_levels(padded, True, base, max_levels, True,
                             "hybrid")[0]
    sa, levels, lev_count, ovf = doubling.sa_loop(sym, True, L, base)
    return sym, sa, levels, lev_count, ovf, base, layout.n


def clonal(fam):
    """The family with g1 replaced by a copy of g0."""
    fam = list(fam)
    fam[1] = ("g1", fam[0][1].copy())
    return fam


def sa_kernel_bytes(trace) -> tuple[int, int]:
    """Bytes the doubling loop's two kernels must move over one loop's
    rounds (``doubling.Kernels``' trace), each input read once and each
    output written once, 4 B an int32 and 8 B an int64 entry.  sa_keys:
    the text or the rank read (4 B a position), the key and the suffix
    written (12 B) in the initial and full rounds; in a tail round the
    tied suffixes and their two rank entries read (12 B) and the key and
    suffix written (12 B).  sa_rerank: the sorted key and suffix read (12
    B), SA and the rank written (8 B); in a tail round also the slots
    read (4 B) and the still-tied slots and suffixes written (8 B each);
    the extract pass reads SA and the rank (8 B a position) and writes
    the tied slots and suffixes.  Returns (sa_keys bytes, sa_rerank
    bytes)."""
    kb = rb = 0
    for r in trace:
        m, tied = r["entries"], r["tied"]
        if r["kind"] in ("initial", "full"):
            kb += 16 * m
            rb += 20 * m
        elif r["kind"] == "tail":
            kb += 24 * m
            rb += 24 * m + 8 * tied
        else:  # extract
            rb += 8 * m + 8 * tied
    return kb, rb


def _sa_rounds(label, sym, base, L):
    """One traced run of the doubling loop's kernels (each round's kind,
    entries, tied count after it, and the ms of its key build, sort,
    rerank and pair scatter from CUDA events) after an untraced one (the
    allocator's warm-up), then the loop timed untraced.  Returns a dict of
    the sums (``rerank_ms``: the rerank function, its pair scatter
    included), the loop's ms and the kernels' byte bounds."""
    from andix_torch.esa import doubling

    doubling.sa_loop(sym, True, L, base)
    trace = []
    sa, levels, cnt, _ = doubling.sa_loop(sym, True, L, base,
                                          doubling.Kernels(trace=trace))
    del sa, levels
    for i, r in enumerate(trace):
        say(f"  {label} round {i}: {r['kind']}, {r['entries']} entries, "
            f"{r['tied']} tied after; sa_keys {r['keys_ms']:.4f} ms, sort "
            f"{r['sort_ms']:.4f} ms, sa_rerank {r['rerank_ms']:.4f} ms, "
            f"sa_pair_scatter {r['scatter_ms']:.4f} ms")
    ms = cuda_ms(lambda: doubling.sa_loop(sym, True, L, base), 3,
                 warm=False)
    kb, rb = sa_kernel_bytes(trace)
    out = {"loop_ms": ms, "rounds": len(trace), "levels": cnt}
    for key in ("sort_ms", "keys_ms", "rerank_ms", "scatter_ms"):
        out[key] = sum(r[key] for r in trace)
    out["rerank_ms"] += out["scatter_ms"]
    out["keys_bound_ms"] = kb / HBM_BYTES_PER_S * 1e3
    out["rerank_bound_ms"] = rb / HBM_BYTES_PER_S * 1e3
    kernels_ms = out["keys_ms"] + out["rerank_ms"]
    loop_bytes, loop_bound = sa_bound(sym.shape[0], cnt)
    say(f"  {label} loop: {ms:.4f} ms untraced ({len(trace)} rounds, {cnt} "
        f"levels); traced: sorts {out['sort_ms']:.4f} ms, sa_keys "
        f"{out['keys_ms']:.4f} ms (bound {out['keys_bound_ms']:.4f} ms, {kb} "
        f"B), sa_rerank {out['rerank_ms']:.4f} ms with its pair scatter "
        f"{out['scatter_ms']:.4f} ms (bound {out['rerank_bound_ms']:.4f} "
        f"ms, {rb} B): kernels "
        f"{100 * (out['keys_bound_ms'] + out['rerank_bound_ms']) / kernels_ms:.2f}"
        f"% of their bound; sa_bound {loop_bound:.4f} ms ({loop_bytes} B) = "
        f"{100 * loop_bound / ms:.3f}% of the loop")
    return out


def _sort_yardstick(label, sym, base):
    """The loop's library sort against ``torch.sort`` on one full round's
    keys (the round after the initial ranks): CUB's pairs sort of (key,
    int32 suffix) over the key's bits, which the loop calls, and
    ``torch.sort`` of the keys, which the plain loop calls.  Both give the
    same sorted keys and the suffixes in an order that those keys
    follow.  CUB sorts in place, so each of its timed calls first copies
    the keys and suffixes back; the copies are timed alone and taken
    off.  Then that round's rank scatter: the rerank pass with the
    partitioned scatter (binning the pairs into the sort's dead key
    buffer) and with the direct one, and sa_pair_scatter over the binned
    pairs against its plain version, ``index_put_`` of the same pairs
    (the library call too), held equal.  Returns (CUB ms, torch.sort ms,
    the pair scatter's dict)."""
    from andix_torch.esa import doubling

    route = doubling.Kernels()
    n = sym.shape[0]
    rank, _, _ = doubling._initial_ranks(sym, True, base)
    key, vals = route.keys(doubling._KEY_FULL, rank, None, n, base)
    end_bit = doubling._round_end_bit(n)
    kc, vc = key.clone(), vals.clone()
    got_k, got_v, _ = route.sort(kc, vc, end_bit)
    ref_k, _ = torch.sort(key)
    if not torch.equal(got_k, ref_k) or not torch.equal(
            key[got_v.long()], ref_k):
        raise AssertionError(f"sa_sort {label}: != torch.sort")
    del got_k, got_v, ref_k

    def copies():
        kc.copy_(key)
        vc.copy_(vals)

    copy_ms = cuda_ms(copies, 5)
    cub_ms = cuda_ms(lambda: (copies(), route.sort(kc, vc, end_bit)),
                     5) - copy_ms
    torch_ms = cuda_ms(lambda: torch.sort(key), 5)
    say(f"  {label} sort of one full round's keys ({end_bit} bits): CUB "
        f"pairs (int64 key, int32 suffix) {cub_ms:.4f} ms, torch.sort "
        f"{torch_ms:.4f} ms; same sorted keys")
    del kc, vc
    # that round's rank scatter, partitioned by the rule, and direct
    sk, sv, dead = route.sort(key, vals, end_bit)
    plan = route.plan(n, n, False)
    sa = torch.empty_like(rank)
    route.rerank(doubling._RR_FULL, n, sk, sv, rank=rank, sa=sa, pairs=dead,
                 plan=plan)
    got = torch.zeros_like(rank)
    route.scatter(dead, n, got)
    pairs = dead.view(torch.int32)[: 2 * n].view(n, 2)
    dest, head = pairs[:, 0].long(), pairs[:, 1].contiguous()
    ref = torch.zeros_like(rank)
    ref.index_put_((dest,), head)
    torch.cuda.synchronize()
    err = max_abs_err([got], [ref])
    if err:
        raise AssertionError(f"sa_pair_scatter {label}: max_abs_err {err}")
    bin_ms = cuda_ms(lambda: route.rerank(
        doubling._RR_FULL, n, sk, sv, rank=rank, sa=sa, pairs=dead,
        plan=plan), 5)
    direct = doubling.Kernels(parts=0)
    direct_ms = cuda_ms(lambda: direct.rerank(
        doubling._RR_FULL, n, sk, sv, rank=got, sa=sa), 5)
    scatter_ms = cuda_ms(lambda: route.scatter(dead, n, got), 5)
    plain_ms = cuda_ms(lambda: ref.index_put_((dest,), head), 5)
    nbytes = 12 * n
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"  {label} one full round's rank scatter, {plan[1]} parts of "
        f"2^{plan[0]}: rerank binning {bin_ms:.4f} ms + sa_pair_scatter "
        f"{scatter_ms:.4f} ms = {bin_ms + scatter_ms:.4f} ms against the "
        f"direct rerank {direct_ms:.4f} ms; sa_pair_scatter == index_put_ "
        f"of the same pairs ({plain_ms:.4f} ms); its bound {bound_ms:.4f} "
        f"ms ({nbytes} B) = {100 * bound_ms / scatter_ms:.2f}%")
    return cub_ms, torch_ms, {"ms": scatter_ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "err": err}


def _hold_sa(label, sym, base, cap, got):
    """The doubling loop's kernels (``got``: sa_loop's result on the card)
    against its plain version on the card, exactly: SA, every level row
    kept, the level count and the overflow flag; then each round and the
    loop timed (``_sa_rounds``), the plain loop timed once, and the
    loop's sort against torch.sort (``_sort_yardstick``).  Returns
    ``_sa_rounds``' dict with the plain ms, the error and both sorts'
    ms."""
    from andix_torch.esa import doubling

    t0 = time.time()
    n = sym.shape[0]
    L = doubling.plan_levels(n, True, base, cap, True, "hybrid")[0]
    ref = doubling.sa_loop_plain(sym, True, L, base)
    torch.cuda.synchronize()
    sa, levels, cnt, ovf = got
    if (cnt, ovf, len(levels)) != (ref[2], ref[3], len(ref[1])):
        raise AssertionError(f"sa_loop {label}: levels {cnt}, overflow {ovf}"
                             f", rows {len(levels)} != plain {ref[2:]}, "
                             f"{len(ref[1])}")
    err = max_abs_err([sa] + levels, [ref[0]] + ref[1])
    if err:
        raise AssertionError(f"sa_loop {label}: max_abs_err {err}")
    del ref
    say(f"sa_loop {label} (n={n}, base {base}, {cnt} levels, {len(levels)} "
        f"rows, overflow {ovf}): kernels == plain (SA, every row, count, "
        f"flag)")
    out = _sa_rounds(label, sym, base, L)
    out["plain_ms"] = cuda_ms(lambda: doubling.sa_loop_plain(sym, True, L,
                                                             base), 1,
                              warm=False)
    out["err"] = err
    out["cub_sort_ms"], out["torch_sort_ms"], out["scatter"] = \
        _sort_yardstick(label, sym, base)
    say(f"  {label}: plain loop {out['plain_ms']:.4f} ms, kernels' loop "
        f"{out['loop_ms']:.4f} ms; this check {time.time() - t0:.1f} s")
    return out


def phase_plcp(dev):
    """The sampled-PLCP kernels against their plain version, exactly (LCP
    and overflow flag), on the padded joint texts of 8 x 1 Mbp, 8 x 5 Mbp
    and the 8 x 1 Mbp clonal family with every level row it needs, whose
    LCP must also equal the host Φ LCP; then on the clonal family cut to
    andix's 14 rows, where entries stay open and the flag rises; timed on
    each.  Before it, on each text, the doubling loop's kernels against
    its plain version (``_hold_sa``).  Returns (kernel ms, plain ms,
    max_abs_err, bound ms) at 8 x 1 Mbp, the kernel's LCPs of the 8 x 1
    and 8 x 5 Mbp texts, and ``_hold_sa``'s dict at 8 x 1 Mbp."""
    from andix_torch import native
    from andix_torch.esa import plcp

    timing = sa_timing = None
    lcps = {}
    for label, fam, cap in (
            ("8x1Mbp", make_family(8, 1_000_000), None),
            ("8x5Mbp", make_family(8, 5_000_000), None),
            ("8x1Mbp clonal", clonal(make_family(8, 1_000_000)), None),
            (f"8x1Mbp clonal, {ANDIX_ROWS} rows",
             clonal(make_family(8, 1_000_000)), ANDIX_ROWS)):
        sym, sa, levels, cnt, ovf_sa, base, n_real = _joint_text(dev, fam,
                                                                 cap)
        sa_t = _hold_sa(label, sym, base, cap, (sa, levels, cnt, ovf_sa))
        if label == "8x1Mbp":
            sa_timing = sa_t
        args = (sym, sa, levels, cnt, base)
        got = plcp.plcp_lcp_hybrid(*args)
        ref = plcp.plcp_lcp_hybrid_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err:
            raise AssertionError(f"plcp {label}: max_abs_err {err}")
        if bool(got[1]) != (cap is not None):
            raise AssertionError(f"plcp {label}: overflow flag {got[1]}")
        n = sym.shape[0]
        ms = cuda_ms(lambda: plcp.plcp_lcp_hybrid(*args), 5)
        plain_ms = cuda_ms(lambda: plcp.plcp_lcp_hybrid_plain(*args), 1,
                           warm=False)
        nbytes = 12 * n + 8 * (n // 16) * len(levels)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"plcp_lcp_hybrid {label} (n={n}, base {base}, {cnt} levels, "
            f"{len(levels)} rows, SA-loop overflow {ovf_sa}): kernel == "
            f"plain, overflow flag {bool(got[1])}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B) "
            f"= {100 * bound_ms / ms:.2f}% of the kernel")
        if label == "8x1Mbp":
            timing = (ms, plain_ms, err, bound_ms)
        if cap is None and "clonal" not in label:
            lcps[label] = got[0]
        if label == "8x1Mbp clonal":
            host = native.lcp_from_sa(sym.cpu().numpy(), sa.cpu().numpy(),
                                      os.cpu_count() or 1)
            lcp = got[0].cpu().numpy()
            if (lcp[1:n_real] != host[1:n_real]).any():
                raise AssertionError("plcp 8x1Mbp clonal: kernel LCP != "
                                     "host Φ LCP")
            say(f"  {label}: kernel LCP == host Φ LCP over the {n_real} "
                f"real positions (longest {int(lcp.max())})")
        del sym, sa, levels, got, ref, args
        torch.cuda.empty_cache()
    return timing, lcps, sa_timing


def rmq_bound(rm) -> tuple[int, float]:
    """Bytes the range-min build must move: the Np values read, and
    pref8, suff8 (Np each), t8 (7 nf), prefg, suffg (nf each) and tg
    written, 4 B an entry; and their time at the card's memory rate."""
    nbytes = 4 * (rm.values.numel() + rm.pref8.numel() + rm.suff8.numel()
                  + rm.t8.numel() + rm.prefg.numel() + rm.suffg.numel()
                  + rm.tg.numel())
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def phase_rmq(lcps):
    """The range-min kernel against its plain build over the 8 x 1 and
    8 x 5 Mbp joint LCPs (``phase_plcp``'s), every array exactly; both
    timed, the bound printed.  Returns (kernel ms, plain ms, max_abs_err,
    bound ms) at 8 x 1 Mbp."""
    from andix_torch.esa import rmq

    timing = None
    for label, lcp in lcps.items():
        got = rmq.build(lcp)
        ref = rmq.build_plain(lcp)
        torch.cuda.synchronize()
        names = ("values", "pref8", "suff8", "t8", "prefg", "suffg", "tg")
        err = max_abs_err([getattr(got, k) for k in names],
                          [getattr(ref, k) for k in names])
        if err:
            raise AssertionError(f"range_min_build {label}: max_abs_err "
                                 f"{err}")
        ms = cuda_ms(lambda: rmq.build(lcp), 20)
        plain_ms = cuda_ms(lambda: rmq.build_plain(lcp), 3)
        nbytes, bound_ms = rmq_bound(got)
        say(f"range_min_build {label} (Np={got.values.numel()}, tg "
            f"{tuple(got.tg.shape)}): kernel == plain, every array; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes} B) = {100 * bound_ms / ms:.2f}% of the kernel")
        if label == "8x1Mbp":
            timing = (ms, plain_ms, err, bound_ms)
        del got, ref
        torch.cuda.empty_cache()
    return timing


def _peak_since(fn):
    """(result, seconds, peak device bytes above what was allocated when
    ``fn`` started)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated() - base


def phase_index_build(dev):
    """One subject's index built on the card and on the CPU, equal; the
    build's levels and peak bytes per padded index symbol on the card;
    then a self-repeating subject's group build on the card with every
    level row (the kernel's LCP) and cut to 14 rows (the host LCP), and on
    the CPU, all equal."""
    from andix_torch import kernels, pipeline
    from andix_torch import subject_pipeline as sp
    from andix_torch.esa import backend, doubling, joint, subject_index
    from andix_torch.esa.backend import pad_symbols
    from andix_torch.sequence import Seq, subject_init

    cache_k = 12  # the schedule's depth at 1 and 5 Mbp
    peaks = []
    for length in (1_000_000, 5_000_000):
        name, data = make_family(1, length)[0]
        subject = subject_init(Seq(data, name), 0.025)
        layout = joint.build_block({0: subject.rs}, {})
        lp = sp.index_length(subject)
        sym = torch.from_numpy(pad_symbols(layout.sym, lp))
        max_levels = max(1, backend.level_budget(
            lp, pipeline.memory_budget(dev)))
        torch.cuda.empty_cache()
        levels = []

        def sa_lcp():
            return doubling.sa_lcp_device(
                sym_d, packed=True, max_levels=max_levels,
                lcp_mode="hybrid", base_width=doubling.wide_base_width(
                    1, True), on_sa=lambda c, L: levels.append((c, L)))

        def codes_words_cache():
            codes = subject_index.device_order_codes(sym_d)
            return (subject_index._pack_codes(codes),
                    subject_index.build_cache(codes, layout.n, cache_k))

        (sym_d,), t_up, p_up = _peak_since(lambda: (sym.to(dev),))
        (sa, lcp, ovf, _), t_sa, p_sa = _peak_since(sa_lcp)
        (words, cache), t_c, p_c = _peak_since(codes_words_cache)
        if bool(ovf):
            raise AssertionError(f"subject {length} bp: level overflow")
        # the build holds the text throughout, and SA + LCP while it packs
        peak = p_up + max(p_sa, 8 * lp + p_c)
        say(f"subject index build {length} bp on the card: Lp={lp}, "
            f"{levels[0][0]} rank levels (at most {levels[0][1]} rows); upload "
            f"{t_up:.4f} s, SA+LCP {t_sa:.4f} s (peak {p_sa} B = "
            f"{p_sa / lp:.2f} B/sym), codes+words+cache k={cache_k} "
            f"{t_c:.4f} s (peak {p_c} B = {p_c / lp:.2f} B/sym); with the "
            f"text: {peak / lp:.2f} B per padded index symbol")
        peaks.append(peak / lp)
        got = subject_index.build_subject_index(sym_d, layout.n, cache_k,
                                                True, max_levels)
        for a, b in zip(got, (sa, lcp, ovf, words, cache)):
            if max_abs_err([a], [b]):
                raise AssertionError("subject index: build_subject_index "
                                     "!= its steps")
        if length == 1_000_000:
            ref = subject_index.build_subject_index(sym, layout.n, cache_k,
                                                    True, max_levels)
            n = layout.n
            pairs = [(sa.cpu(), ref[0]), (lcp[:n].cpu(), ref[1][:n]),
                     (ovf.cpu(), ref[2]), (words.cpu(), ref[3]),
                     (cache.cpu(), ref[4])]
            if max_abs_err(*zip(*pairs)):
                raise AssertionError("subject index: card != CPU")
            say(f"subject index build {length} bp: card == CPU (SA over "
                f"Lp={lp}, LCP over n_real={n}, words, cache k={cache_k})")
        del got, sym, sym_d, sa, lcp, words, cache
        torch.cuda.empty_cache()

    # one 500 kbp block twice over: the subject's own index needs 17 level
    # rows; with them its LCP comes from the kernel, and with the level
    # budget cut to andix's 14 rows the group build takes the host LCP
    name, block = make_family(1, 500_000, seed=5)[0]
    subject = subject_init(Seq(np.concatenate([block, block]), "rep"), 0.025)
    builds = {}
    cut = f"card, {ANDIX_ROWS} rows"
    for label, device, rows in (("card", dev, None), (cut, dev, ANDIX_ROWS),
                                ("CPU", torch.device("cpu"), None)):
        level_budget = backend.level_budget
        if rows is not None:
            backend.level_budget = lambda lp, budget: rows
        kernels.reset_launches()
        try:
            t0 = time.time()
            out = sp._build_group_index([0], [subject], cache_k, device,
                                        pipeline.memory_budget(device), 0)
            if device.type == "cuda":
                torch.cuda.synchronize()
        finally:
            backend.level_budget = level_budget
        builds[label] = (out, time.time() - t0,
                         kernels.launches["plcp_lcp_hybrid"])
    expect = {"card": (0, 1), cut: (1, 0), "CPU": (0, 0)}
    for label, (out, _, launched) in builds.items():
        if (out[4], launched) != expect[label]:
            raise AssertionError(
                f"self-repeating subject, {label}: {out[4]} host LCP round "
                f"trips and {launched} PLCP launches, {expect[label]} "
                f"expected")
        if max_abs_err([x.cpu() for x in out[:4]],
                       [x.cpu() for x in builds["CPU"][0][:4]]):
            raise AssertionError(f"self-repeating subject: {label} != CPU")
    say(f"subject index build, 1 Mbp of one 500 kbp block twice over: every "
        f"level row on the card, LCP from the kernel "
        f"({builds['card'][1]:.3f} s); cut to {ANDIX_ROWS} rows, level "
        f"overflow and the host LCP round trip on the card "
        f"({builds[cut][1]:.3f} s); every row on the CPU "
        f"({builds['CPU'][1]:.3f} s); SA, LCP, words, cache all equal")
    del builds, out
    torch.cuda.empty_cache()
    return peaks


def phase_cli_parity(tmp):
    fam = make_family(3, 30_000, seed=11)
    fam.append(("dup", fam[0][1].copy()))
    fam[2] = ("unrel", NUCL[np.random.default_rng(3).integers(0, 4, 30_000)])
    paths = write_fasta(tmp, fam)
    args = ["--progress=never"] + paths
    code_c, out_c = run_cli(["--backend", "cuda"] + args)
    code_p, out_p = run_cli(["--backend", "cpu"] + args)
    if (code_c, out_c) != (code_p, out_p):
        raise AssertionError(f"cuda and cpu PHYLIP differ:\n{out_c}\n{out_p}")
    say(f"cli 4x30kbp (duplicate + unrelated): --backend cuda == "
        f"--backend cpu, {len(out_c)} bytes, exit {code_c}")

    # a --block-size that splits the joint plan into one block per subject:
    # ANDIX_INDEX=auto takes the subject index
    from andix_torch import kernels

    split = ["--block-size", "150000"] + args
    kernels.reset_launches()
    code_c, out_c = run_cli(["--backend", "cuda"] + split)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    code_p, out_p = run_cli(["--backend", "cpu"] + split)
    if (code_c, out_c) != (code_p, out_p):
        raise AssertionError(f"auto-routed cuda and cpu PHYLIP differ:\n"
                             f"{out_c}\n{out_p}")
    if launches["chain_walk_flat_sx"] <= 0 or launches["chain_walk_flat"]:
        raise AssertionError(f"auto did not route to the subject index: "
                             f"{launches}")
    say(f"cli 4x30kbp --block-size 150000 (ANDIX_INDEX=auto -> subject "
        f"index, launches {launches}): --backend cuda == --backend cpu, "
        f"{len(out_c)} bytes, exit {code_c}")


def _cli_run(paths, index, tmp, label, env=None):
    """One CLI run of ``-m JC`` on the card under ``ANDIX_INDEX=index``
    (and the variables in ``env``), launch counts set to 0 just before
    and read just after; prints the wall, per-phase seconds, peak memory
    and launches."""
    from andix_torch import kernels

    prof_path = os.path.join(tmp, f"prof_{label}.txt")
    env = dict(env or {}, ANDIX_PROF_FILE=prof_path, ANDIX_INDEX=index)
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        code, out = run_cli(["--backend", "cuda", "--progress=never", "-m",
                             "JC"] + paths)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.launches)
    finally:
        for name in env:
            del os.environ[name]
    peak = torch.cuda.max_memory_allocated()
    with open(prof_path) as f:
        phases = [line.strip() for line in f if line.strip()]
    say(f"{label} (ANDIX_INDEX={index}): wall {wall:.3f} s (phase syncs "
        f"on), exit {code}")
    for p in phases:
        say(f"  phase {p}")
    say(f"  peak device memory {peak} B")
    say(f"  kernel launches {launches}")
    sa_lines = [p for p in phases if "SA doubling (" in p]
    h2d = [p for p in phases if "H2D text (" in p]
    if sa_lines and h2d:
        rows = int(sa_lines[0].split("SA doubling (")[1].split(" levels")[0])
        padded = int(h2d[0].split("H2D text (")[1].split(" padded")[0])
        seconds = float(sa_lines[0].rsplit(": ", 1)[1].rstrip("s"))
        nbytes, bound_ms = sa_bound(padded, rows)
        say(f"  SA loop bound ({padded} positions, {rows} rows): {nbytes} B "
            f"-> {bound_ms:.4f} ms = {bound_ms / 10 / seconds:.3f}% of the "
            f"SA doubling phase (a sort's passes not counted)")
    if code != 0:
        raise AssertionError(f"{label}: exit code {code}")
    return out, launches, peak, wall, phases


def sa_bound(padded: int, rows: int) -> tuple[int, float]:
    """Bytes the doubling loop must move, and their time at the card's
    memory rate: the text read once and the SA and each level row written
    once, 4 B a position each.  The passes of its sorts are not counted:
    their number is the sort's choice."""
    nbytes = (8 + 4 * rows) * padded
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _check_matrix(out, n_genomes, rates=None):
    lines = out.strip().split("\n")
    n = int(lines[0])
    names = [ln[:10].strip() for ln in lines[1:]]
    vals = np.array([[float(x) for x in ln[10:].split()]
                     for ln in lines[1:]])
    if vals.shape != (n, n) or n != n_genomes or not np.isfinite(vals).all():
        raise AssertionError(f"bad matrix shape/values:\n{out}")
    if not np.allclose(vals, vals.T, atol=1e-4):
        raise AssertionError("matrix not symmetric")
    for k in range(1, n):
        rate = RATES[(k - 1) % len(RATES)] if rates is None else rates[k - 1]
        d = vals[names.index("g0"), names.index(f"g{k}")]
        if abs(d - rate) > 0.15 * rate:
            raise AssertionError(f"g0-g{k}: {d} vs simulated {rate}")
    say(f"  matrix: {n}x{n}, finite, symmetric, g0->gk within 15% of the "
        "simulated rates " + " ".join(
            f"{vals[0, k]:.4f}" for k in range(1, n)))


def phase_main_path(tmp, card):
    from andix_torch.esa.backend import bucket

    fam = make_family(8, 1_000_000)
    paths = write_fasta(tmp, fam)
    padded = bucket(sum(2 * len(d) + 2 for _, d in fam))
    out, launches, peak, wall, phases = _cli_run(
        paths, "auto", tmp, f"8x1Mbp main path on {card}")
    say(f"  {peak / padded:.2f} B per padded symbol ({padded} padded "
        f"symbols)")
    if min(launches["flag_scan"], launches["chain_walk_flat"],
           launches["plcp_lcp_hybrid"], launches["range_min_build"],
           launches["sa_keys"], launches["sa_rerank"],
           launches["sa_pair_scatter"]) <= 0 \
            or launches["chain_walk_flat_sx"]:
        raise AssertionError(f"the joint path's kernels did not launch: "
                             f"{launches}")
    _check_matrix(out, 8)

    out_sx, sx_launches, _, _, _ = _cli_run(
        paths, "subject", tmp, f"8x1Mbp subject index on {card}")
    if out_sx != out:
        raise AssertionError(f"8x1Mbp subject-index PHYLIP != joint:\n"
                             f"{out_sx}\n{out}")
    if min(sx_launches["chain_walk_flat_sx"],
           sx_launches["plcp_lcp_hybrid"], sx_launches["sa_keys"],
           sx_launches["sa_rerank"]) <= 0 or sx_launches["chain_walk_flat"]:
        raise AssertionError(f"8x1Mbp subject run launches {sx_launches}")
    say("  8x1Mbp: ANDIX_INDEX=subject PHYLIP == joint schedule PHYLIP, "
        f"{len(out)} bytes")
    return launches, out, paths, (wall, phases)


def phase_full_size(tmp, card):
    """The slice's full-size path: 8 x 5 Mbp under both schedules."""
    fam = make_family(8, 5_000_000)
    paths = write_fasta(tmp, fam)
    out_sx, sx_launches, _, _, _ = _cli_run(
        paths, "subject", tmp, f"8x5Mbp subject index on {card}")
    out_j, launches_j, _, wall_j, phases_j = _cli_run(
        paths, "joint", tmp, f"8x5Mbp joint schedule on {card}")
    if out_sx != out_j:
        raise AssertionError(f"8x5Mbp subject-index PHYLIP != joint:\n"
                             f"{out_sx}\n{out_j}")
    if sx_launches["chain_walk_flat_sx"] <= 0 or \
            sx_launches["chain_walk_flat"]:
        raise AssertionError(f"8x5Mbp subject run launches {sx_launches}: "
                             f"rows fell back to the joint walk")
    if min(sx_launches["sa_keys"], sx_launches["sa_rerank"],
           sx_launches["sa_pair_scatter"], launches_j["sa_keys"],
           launches_j["sa_rerank"], launches_j["sa_pair_scatter"]) <= 0:
        raise AssertionError(f"8x5Mbp: the doubling kernels did not launch: "
                             f"subject {sx_launches}, joint {launches_j}")
    say(f"  8x5Mbp: ANDIX_INDEX=subject PHYLIP == ANDIX_INDEX=joint PHYLIP, "
        f"{len(out_sx)} bytes")
    _check_matrix(out_sx, 8)
    return sx_launches, out_j, paths, (wall_j, phases_j)


def _replay_block(dev, fam):
    """A family's joint block on the card (every genome a subject), its
    [Sg, QB] subject tables and the count-in-loop replay's lanes."""
    from andix_torch.chain import replay_device as rd
    from andix_torch.esa import joint
    from andix_torch.esa.backend import TorchBackend
    from andix_torch.sequence import Seq, subject_init

    subjects = [subject_init(Seq(d, name), 0.025) for name, d in fam]
    be = TorchBackend(dev)
    ctx = be.prepare_block(joint.build_block(
        {i: s.rs for i, s in enumerate(subjects)}, {}))
    genomes = list(range(len(fam)))
    segs, starts, rs_lens, thr, q_len2d = be._group_tables(
        ctx, genomes, dict(enumerate(subjects)))
    mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                       segs, starts)
    lanes = rd.replay_lanes(starts, rs_lens, thr, ctx.q_base_h,
                            ctx.q_start_h, q_len2d, dev)
    return be, ctx, subjects, mlun, ps, lanes


def replay_bound(lanes, tally, counts=None) -> tuple[int, float]:
    """Bytes a count-in-loop replay launch must move, and their time at
    the card's memory rate.  Per lane: its query length read, 64 B of
    counts and 12 B of tallies written; per subject row 12 B and per
    query 8 B of lane fields read; 2 B a gap site and 1 B an exact-mode
    equal site (``tally``, the kernel's or the plain version's).  The
    walk's reads: with the plain run's ``counts`` as ``walk_bound``
    counts them (4 B per mlun entry read, 4 B of ps per table anchor, the
    lucky checks' bytes); without them (no plain run, at 8 x 5 Mbp) 4 B
    a probe step, a floor: every step reads at least one table entry not
    read before, or takes a lucky check."""
    sg, g = lanes["q_len"].shape
    t = tally.long().sum(dim=(0, 1)).tolist()
    nbytes = 12 * sg + 8 * g + 80 * sg * g + 2 * t[1] + t[2]
    if counts is None:
        nbytes += 4 * t[0]
    else:
        nbytes += (4 * (counts["hops"] + counts["table_probes"]
                        + counts["table_anchors"]) + counts["lucky_bytes"])
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _timed(fn):
    """fn's result and its milliseconds on the card (CUDA events, once,
    cold)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def device_split(fn, reps: int = 1) -> dict[str, float]:
    """{kernel name: mean device ms a call} over ``reps`` calls of ``fn``
    under torch.profiler (after a warm call).  Now and then a profiler
    session records no device activity at all, with no error; such a
    session is run again, three times at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].strip().split(
                    "::")[-1]
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def replay_passes(args, reps, segments=None):
    """The replay call ``rd.replay_rows(*args, segments=segments)`` timed
    (after a warm call): mean ms a call over ``reps`` calls (CUDA
    events), the mean device ms of each pass over ``reps`` more
    (torch.profiler), and the splice counters of one more call."""
    from andix_torch.chain import replay_device as rd

    def call():
        return rd.replay_rows(*args, segments=segments)

    ms = cuda_ms(call, reps)
    split = device_split(call, reps)
    p1, p2 = (sum(v for k, v in split.items() if k.startswith(name))
              for name in ("replay_cold", "replay_splice"))
    if not p1 or not p2:
        raise AssertionError(f"the profiler saw no replay pass: {split}")
    splice = {}
    rd.replay_rows(*args, segments=segments, splice=splice)
    return ms, p1, p2, splice


def _splice_text(ms, p1, p2, splice) -> str:
    merges, fallbacks, steps = splice["lanes"].long().sum(dim=(0, 1)).tolist()
    return (f"K={splice['segments']} M={splice['trail']}: kernel {ms:.4f} ms "
            f"(pass 1 {p1:.4f} ms, pass 2 {p2:.4f} ms); {merges} merges, "
            f"{fallbacks} fallbacks, {steps} repair steps")


def _phase_seconds(phases, key) -> float:
    return sum(float(p.rsplit(": ", 1)[1].rstrip("s"))
               for p in phases if key in p)


def phase_replay(dev, tmp, card, events_runs):
    """The count-in-loop replay (``ANDIX_REPLAY=loop``, and the fallback
    of an event overflow).

    The kernel against the plain version, exactly (counts and per-lane
    tallies), over every lane of the 8 x 50 kbp family and of 8 x 1 Mbp
    in both modes (JC's split equal counts, LogDet's exact ones) and of
    the small family's clonal copy (g1 = g0) in LogDet's.  The plain walk
    does not depend on the mode, so each block is walked once
    (``replay_walk_plain``) and counted once a mode
    (``replay_count_plain``); the plain time is the two together.  Timed
    there (kernel: mean of 5 calls, and of each of its two passes over 5
    more; plain: once) with the byte bound from the plain run's counts,
    and printed with the call's segments K and its splice counters
    (merges, fallbacks, repair steps; ``replay_passes``).  At 8 x 50 kbp
    the rule takes K = 1, at 8 x 1 Mbp it segments.  At 8 x 1 and 8 x 5
    Mbp the block's counts through the loop path (the kernel) against the
    events path's (the flat walk and the host count), JC and LogDet, and
    in JC the kernel at K = 1 (the unsegmented schedule), 8, 16 and 32,
    each equal to the default K's counts and tallies and timed; at 8 x 5
    Mbp the kernel timed with the floor bound from its own tallies (the
    plain version is not run there: its longest lane takes 196,582
    lock-step steps).  Then the CLI at 8 x 1 and 8 x 5 Mbp under
    ``ANDIX_REPLAY=loop``: the bytes of the default (events) runs
    ``events_runs`` (label, paths, PHYLIP, (wall, phases)), the replay
    launched once and the walk never, the loop phase beside the events
    run's walk and host count; and 8 x 1 Mbp with ``ANDIX_EVENT_CAP=64``,
    which overflows and must take the kernel.  Returns (kernel ms, plain
    ms and bound ms at 8 x 1 Mbp JC, max_abs_err, replay launches of the
    8 x 1 Mbp loop run)."""
    from andix_torch import kernels
    from andix_torch.chain import replay_device as rd
    from andix_torch.esa.backend import CHASE
    from andix_torch.runtime import Model

    diag_win = kernels.cuda_lib().andix_walk_diag_win()
    err = 0
    row = None
    small = make_family(8, 50_000)

    def against_events(label, be, ctx, subjects, mlun, ps, lanes):
        genomes = list(range(8))
        for model in (Model.JC, Model.LOGDET):
            rows = {mode: be.subject_group_counts(
                ctx, genomes, dict(enumerate(subjects)), model, replay=mode)
                for mode in ("events", "loop")}
            a, b = ([torch.from_numpy(np.stack([r[i][j].counts
                                                 for i in genomes
                                                 for j in r[i]]))]
                    for r in (rows["events"], rows["loop"]))
            e = max_abs_err(a, b)
            if e:
                raise AssertionError(f"replay {label} {model.value}: loop "
                                     f"counts != events counts ({e})")
            args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                    model == Model.LOGDET, CHASE)
            want = rd.replay_rows(*args)
            timed = replay_passes(args, 5)
            nbytes, bound_ms = replay_bound(lanes, want[1])
            t = want[1].long()
            say(f"replay {label} {model.value}: loop counts == events counts "
                f"({len(a[0])} pairs); {_splice_text(*timed)}; probe steps: "
                f"longest lane {int(t[..., 0].max())}, all "
                f"{int(t[..., 0].sum())}; gap sites {int(t[..., 1].sum())}, "
                f"exact equal sites {int(t[..., 2].sum())}; floor bound "
                f"{nbytes} B -> {bound_ms:.6f} ms "
                f"({100 * bound_ms / timed[0]:.3f}% of the kernel)")
            if model != Model.JC:
                continue
            # the segments: the result must not move; K = 1 is the
            # unsegmented schedule of PR 9's kernel through the two passes
            for k in (1, 8, 16, 32):
                got = rd.replay_rows(*args, segments=k)
                e = max_abs_err(got, want)
                if e:
                    raise AssertionError(f"replay {label} K={k}: counts or "
                                         f"tallies moved ({e})")
                timed_k = replay_passes(args, 5, k)
                say(f"  {label} JC at {_splice_text(*timed_k)} "
                    f"(the bound {100 * bound_ms / timed_k[0]:.3f}% of it); "
                    "== the default K's counts and tallies")

    for label, fam, modes in (
            ("8x50kbp", small, (False, True)),
            ("8x50kbp clonal", clonal(small), (True,)),
            ("8x1Mbp", make_family(8, 1_000_000), (False, True)),
            ("8x5Mbp", make_family(8, 5_000_000), ())):
        be, ctx, subjects, mlun, ps, lanes = _replay_block(dev, fam)
        args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes)
        counts = {}
        walk = None
        if modes:
            walk, w_ms = _timed(lambda: rd.replay_walk_plain(
                ctx.isa, ctx.rm, mlun, ps, lanes, CHASE, counts, diag_win))
        for exact in modes:
            ref, c_ms = _timed(lambda: rd.replay_count_plain(
                walk, ctx.text, exact, counts))
            p_ms = w_ms + c_ms
            got = rd.replay_rows(*args, exact, CHASE)
            e = max_abs_err(got, ref)
            err = max(err, e)
            if e:
                raise AssertionError(f"replay {label} exact={exact}: kernel "
                                     f"!= plain, max_abs_err {e}")
            timed = replay_passes(args + (exact, CHASE), 5)
            ms = timed[0]
            nbytes, bound_ms = replay_bound(lanes, ref[1], counts)
            floor = replay_bound(lanes, ref[1])[0]
            say(f"replay {label} {'exact (LogDet)' if exact else 'fast (JC)'}"
                f": kernel == plain (counts and tallies), "
                f"{_splice_text(*timed)}, plain {p_ms:.1f} ms (walk "
                f"{w_ms:.1f} ms, count {c_ms:.1f} ms); "
                f"{int(ref[1][..., 0].max())} probe steps in the longest "
                "lane")
            say(f"  counts {json.dumps(counts)}; {nbytes} B to move -> bound "
                f"{bound_ms:.6f} ms ({100 * bound_ms / ms:.3f}% of the "
                f"kernel); the 4-B-a-probe floor {floor} B")
            if label == "8x1Mbp" and not exact:
                row = (ms, p_ms, bound_ms)
        if label.startswith(("8x1Mbp", "8x5Mbp")):
            against_events(label, be, ctx, subjects, mlun, ps, lanes)
        # the loop runs below report their own peaks: hold no block here
        del be, ctx, subjects, mlun, ps, lanes, args, walk
        torch.cuda.empty_cache()

    loop_launches = None
    for label, paths, out_ev, (wall_ev, ph_ev) in events_runs:
        out, launches, _, wall, ph = _cli_run(
            paths, "joint", tmp, f"{label} ANDIX_REPLAY=loop on {card}",
            env={"ANDIX_REPLAY": "loop"})
        if out != out_ev:
            raise AssertionError(f"{label} ANDIX_REPLAY=loop PHYLIP != the "
                                 f"events run's:\n{out}\n{out_ev}")
        # one replay call (its two passes) for the one subject group
        if launches["replay"] != 1 or launches["chain_walk_flat"] or min(
                launches["flag_scan"], launches["plcp_lcp_hybrid"],
                launches["range_min_build"]) <= 0:
            raise AssertionError(f"{label} loop run launches {launches}")
        loop_s = _phase_seconds(ph, "count-in-loop replay")
        walk_s = _phase_seconds(ph_ev, "segmented walk")
        count_s = _phase_seconds(ph_ev, "host count")
        say(f"  {label}: ANDIX_REPLAY=loop PHYLIP == events PHYLIP; loop "
            f"phase {loop_s:.6f} s against the events run's walk "
            f"{walk_s:.6f} s + host count {count_s:.6f} s = "
            f"{walk_s + count_s:.6f} s; walls loop {wall:.3f} s, events "
            f"{wall_ev:.3f} s")
        if loop_launches is None:
            loop_launches = launches["replay"]

    label, paths, out_ev, _ = events_runs[0]
    out, launches, _, _, ph = _cli_run(
        paths, "joint", tmp, f"{label} ANDIX_EVENT_CAP=64 on {card}",
        env={"ANDIX_EVENT_CAP": "64"})
    if out != out_ev or launches["replay"] != 1 or \
            launches["chain_walk_flat"] < 1 or \
            not any("overflowed" in p for p in ph):
        raise AssertionError(f"{label} forced overflow: launches {launches},"
                             f" bytes equal {out == out_ev}")
    say(f"  {label} ANDIX_EVENT_CAP=64: the event buffer overflowed, the "
        "count-in-loop kernel counted, PHYLIP == the default run's")
    return (*row, err, loop_launches)


def _anchors_walk(dev, label, fam, plain: bool):
    """``chain_anchors_device`` over a family's joint block (every pair
    whole, the backend's default cap): the kernel's ms (CUDA events, 3
    calls) and, with ``plain``, the plain walk's ms, each lane's stream
    held to it and the byte bound from its counts (``walk_bound``);
    without, the floor of the events written and the lanes' fields.
    Returns (ms, plain ms or None, bound ms)."""
    from andix_torch import kernels
    from andix_torch.chain import replay_device as rd

    _, ctx, _, mlun, ps, lanes = _replay_block(dev, fam)
    fields = [lanes[n] for n in ("ss", "rl", "thr", "q_base", "q_start",
                                 "q_len")]
    ecap = max(1 << 16, ctx.tq.shape[0] // 2)

    def kernel():
        return rd.chain_anchors_device(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                       *fields, ecap)

    got = kernel()
    cnt, ovf, iters = (int(x) for x in got[4:])
    if ovf:
        raise AssertionError(f"unsegmented walk {label}: {cnt} events "
                             f"overflow {ecap}")
    ms = cuda_ms(kernel, 3)
    lb = lanes["q_len"].numel()
    p_ms = None
    if plain:
        counts = {}
        walk_lanes = rd.anchor_lanes(*fields, dev)
        ref, p_ms = _timed(lambda: rd.chain_walk_flat_plain(
            ctx.isa, ctx.rm, ctx.text, mlun, ps, walk_lanes, rd.UNCAPPED,
            rd.UNCAPPED, ecap, 4, 4, counts,
            kernels.cuda_lib().andix_walk_diag_win()))
        if int(ref[4]) != cnt or any(
                a.shape != b.shape or (a != b).any()
                for a, b in zip(_per_lane(got, lb), _per_lane(ref, lb))):
            raise AssertionError(f"unsegmented walk {label}: kernel != plain")
        nbytes, bound_ms = walk_bound(counts, lb)
        what = f"bound {bound_ms:.6f} ms ({nbytes} B, counts " \
               f"{json.dumps(counts)})"
    else:
        nbytes = 16 * cnt + 61 * lb
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        what = f"floor bound {bound_ms:.6f} ms ({nbytes} B: the events " \
               "written, the lanes' fields)"
    say(f"chain_anchors_device {label}: {lb} lanes, {cnt} events in one "
        f"buffer of {ecap}, {iters} iterations; kernel {ms:.4f} ms"
        + (f", plain {p_ms:.1f} ms, kernel == plain" if plain else "")
        + f"; {what}, {100 * bound_ms / ms:.3f}% of the kernel")
    return ms, p_ms, bound_ms


def phase_unsegmented(dev, tmp, card, paths, out_default):
    """``andix``'s unsegmented events walk (``chain_anchors_device``, the
    flat walk kernel over whole pairs): timed over the 8 x 50 kbp joint
    block against its plain version and over the 8 x 5 Mbp block; then at
    full width the 8 x 5 Mbp CLI under ``ANDIX_CHAIN_SEGMENTS=1`` (one
    walk launch for the group, every event into one buffer of the default
    cap) prints the default run's bytes, with no replay.  Returns the
    run's averaged count matrices (the 28 pairs), read from its
    ``calculate_matrix``."""
    from andix_torch import pipeline
    from andix_torch.model import model_average

    _anchors_walk(dev, "8x50kbp", make_family(8, 50_000), True)
    _anchors_walk(dev, "8x5Mbp", make_family(8, 5_000_000), False)
    torch.cuda.empty_cache()
    grids = []
    orig = pipeline.calculate_matrix

    def keep(*a, **kw):
        grids.append(orig(*a, **kw))
        return grids[-1]

    pipeline.calculate_matrix = keep
    try:
        out, launches, _, _, ph = _cli_run(
            paths, "joint", tmp, f"8x5Mbp ANDIX_CHAIN_SEGMENTS=1 on {card}",
            env={"ANDIX_CHAIN_SEGMENTS": "1"})
    finally:
        pipeline.calculate_matrix = orig
    walks = [p for p in ph if "anchor chain dispatch" in p]
    if out != out_default or launches["chain_walk_flat"] != 1 or \
            launches["replay"] or len(walks) != 1 or \
            any("segmented walk" in p for p in ph):
        raise AssertionError(f"8x5Mbp ANDIX_CHAIN_SEGMENTS=1: launches "
                             f"{launches}, walks {walks}, bytes equal "
                             f"{out == out_default}")
    say("  8x5Mbp ANDIX_CHAIN_SEGMENTS=1: one unsegmented walk launch, "
        "no overflow, PHYLIP == the default run's")
    M = grids[0]
    n = len(M)
    return [model_average(M[i][j], M[j][i])
            for i in range(n) for j in range(i + 1, n)]


def evpack_bound(cnt: int, k: int, lanes: int) -> tuple[int, float]:
    """Bytes the packed encode must move, and their time at the card's
    memory rate: 16 B a live event read (lane, q, s, len) and the
    encoding written once (``evpack.encoded_size``: 6 B a slot of k, the
    escape list, the lane counts)."""
    from andix_torch.chain import evpack

    nbytes = 16 * cnt + 4 * evpack.encoded_size(k, lanes)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _fetch_dispatches(label, dispatches):
    """Per dispatch of a subject run (its buffers, cnt, lanes, cap): the
    encode (sort + kernel) against its plain version on the card, exactly;
    events, bytes moved by each fetch, the encode's ms (CUDA events, 5
    calls) and its device split, the plain ms, the copies' ms and the host
    decode's ms (host clock).  Returns (max_abs_err, the largest
    dispatch's (ms, plain ms, bound ms))."""
    from andix_torch import subject_pipeline as sp
    from andix_torch.chain import evpack

    err, row = 0, None
    for d, (ev4, cnt, lb, ecap) in enumerate(dispatches):
        k = min(sp.bucket(max(cnt, 1), 4096), ecap)

        def kernel():
            return evpack.encode_events_flat(*ev4, cnt, k, lb)

        def plain():
            return evpack.encode_events_plain(*ev4, cnt, k, lb)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        e = max_abs_err([got], [ref])
        if e:
            raise AssertionError(f"evpack {label} dispatch {d}: kernel != "
                                 f"plain, max_abs_err {e}")
        err = max(err, e)
        ms = cuda_ms(kernel, 5)
        split = device_split(kernel, 5)
        own = sum(v for n, v in split.items()
                  if n.startswith(("fields_kernel", "scan_kernel",
                                   "escapes_kernel")))
        plain_ms = cuda_ms(plain, 1)
        t0 = time.perf_counter()
        flat = got.cpu().numpy()
        packed_copy = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        parts = evpack.split_encoded(flat, k, lb)
        esc_ovf = bool(parts[4])
        if not esc_ovf:
            dec = evpack.decode_events(*parts[:3], int(parts[3]), cnt)
        decode_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = torch.stack([x[:cnt] for x in ev4]).cpu().numpy()
        raw_copy = (time.perf_counter() - t0) * 1e3
        order = np.argsort(raw[0], kind="stable")
        if not esc_ovf and any((a != b).any()
                               for a, b in zip(dec, raw[:, order])):
            bad = [int(np.argmax(a != b)) if (a != b).any() else None
                   for a, b in zip(dec, raw[:, order])]
            raise AssertionError(f"evpack {label} dispatch {d}: the decode "
                                 f"is not the lane-major stream (first "
                                 f"mismatch per field {bad}, {cnt} events, "
                                 f"{int(parts[3])} escapes)")
        nbytes, bound_ms = evpack_bound(cnt, k, lb)
        say(f"  evpack {label} dispatch {d}: {cnt} events, k {k}, {lb} "
            f"lanes, {int(parts[3])} escapes of {evpack.esc_capacity(lb)}"
            + (" (escape overflow: the fetch takes the raw buffers)"
               if esc_ovf else "") + f"; raw fetch {16 * cnt} B, "
            f"packed fetch {4 * evpack.encoded_size(k, lb)} B; encode "
            f"{ms:.4f} ms (its kernels {own:.4f} ms, the sort and the rest "
            f"{ms - own:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({nbytes} B, {100 * bound_ms / ms:.2f}% of "
            f"the encode); copies raw {raw_copy:.3f} ms, packed "
            f"{packed_copy:.3f} ms; host decode {decode_ms:.3f} ms; kernel "
            f"== plain")
        if row is None or cnt > row[0]:
            row = (cnt, ms, plain_ms, bound_ms)
    return err, row[1:]


def phase_evpack(tmp, card, runs, sx_launches_5m):
    """The packed event fetch (``ANDIX_EVPACK``) on the subject-index
    schedule at 8 x 1 and 8 x 5 Mbp (``runs``: label, paths, the joint
    PHYLIP).  First a packed run whose every dispatch's raw buffers are
    kept (``_fetch_dispatches`` holds the kernel to the plain version on
    each and times both fetches' parts); then three runs of each fetch in
    turns (packed, raw, ...), each printing the joint bytes, with the
    "sx: segmented walk" phase of each, their means and spreads.  The
    port keeps andix's default (packed) unless raw is faster at 8 x 5
    Mbp by more than the spread of the three runs; the line says which.
    Returns (kernel ms, plain ms, bound ms of the largest 8 x 5 Mbp
    dispatch, max_abs_err, the 8 x 5 Mbp main run's encode launches)."""
    from andix_torch import subject_pipeline as sp

    if sx_launches_5m["evpack_encode"] <= 0:
        raise AssertionError(f"the 8x5Mbp subject run did not launch the "
                             f"encode: {sx_launches_5m}")
    err, row = 0, None
    for label, paths, out_joint in runs:
        kept = []
        orig = sp._fetch_events

        def keeping(ev4, cnt, lb, ecap):
            k = min(sp.bucket(max(cnt, 1), 4096), ecap)
            kept.append(([x[:k].clone() for x in ev4], cnt, lb, ecap))
            return orig(ev4, cnt, lb, ecap)

        sp._fetch_events = keeping
        try:
            out, _, _, _, _ = _cli_run(paths, "subject", tmp,
                                       f"{label} subject, dispatches kept")
        finally:
            sp._fetch_events = orig
        if out != out_joint:
            raise AssertionError(f"{label} subject (kept) PHYLIP != joint")
        e, r = _fetch_dispatches(label, kept)
        err = max(err, e)
        if label.startswith("8x5"):
            row = r
        del kept
        torch.cuda.empty_cache()
        walk = {"1": [], "0": []}
        for rep in range(3):
            for mode in ("1", "0"):
                out, launches, _, wall, ph = _cli_run(
                    paths, "subject", tmp,
                    f"{label} subject ANDIX_EVPACK={mode} run {rep + 1} on "
                    f"{card}", env={"ANDIX_EVPACK": mode})
                if out != out_joint or (launches["evpack_encode"] > 0) != (
                        mode == "1"):
                    raise AssertionError(
                        f"{label} ANDIX_EVPACK={mode}: launches {launches},"
                        f" bytes equal to the joint run's {out == out_joint}")
                walk[mode].append(_phase_seconds(ph, "sx: segmented walk"))
        stats = {m: (float(np.mean(v)), max(v) - min(v))
                 for m, v in walk.items()}
        say(f"  evpack {label}: PHYLIP == joint under ANDIX_EVPACK=0 and 1; "
            f"sx segmented walk packed {walk['1']} s (mean "
            f"{stats['1'][0]:.6f}, spread {stats['1'][1]:.6f}), raw "
            f"{walk['0']} s (mean {stats['0'][0]:.6f}, spread "
            f"{stats['0'][1]:.6f})")
        if label.startswith("8x5"):
            gain = stats["1"][0] - stats["0"][0]
            spread = max(stats["1"][1], stats["0"][1])
            say(f"  evpack default rule at 8x5Mbp: raw faster by "
                f"{gain:.6f} s, spread {spread:.6f} s -> "
                + ("raw wins" if gain > spread else "keep packed"))
    return (*row, err, sx_launches_5m["evpack_encode"])


BOOT_PAIRS = 406  # 29 genomes: the eco29 grid's pairs
BOOT_ROUNDS = 1000
FP64_OPS_PER_S = 34e12  # H100 SXM, FP64 outside the tensor cores (data sheet)


def boot_bound(pairs: int, rounds: int, tally) -> tuple[int, float, float]:
    """The resampler's bytes (the counts read once, 128 B a pair; the
    output written once, 128 B a (round, pair)) and float64 operations
    from the plain run's tally of the sampler's work (6 an inversion step:
    a compare, a subtraction, three multiplications and a division; 2 an
    inversion attempt: the uniform; 100 a BTRS attempt: its four logs at
    about 20 each and some 20 more), each over the card's rate.  Returns
    (bytes, bytes ms, operations ms)."""
    nbytes = 128 * pairs + 128 * pairs * rounds
    ops = (6 * tally["inv_steps"] + 2 * tally["inv_attempts"]
           + 100 * tally["btrs_attempts"])
    return (nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            ops / FP64_OPS_PER_S * 1e3)


def phase_bootstrap(averaged):
    """The device bootstrap resampler at 406 pairs (the 8 x 5 Mbp
    family's 28 averaged count matrices tiled, one all-zero pair) x 1000
    rounds: ``device_bootstrap_rounds`` on the card (counts set to 0 just
    before and read just after: one launch), its properties (totals kept,
    the zero pair zero, rounds that differ, a rerun equal, another seed
    different), the kernel against its host twin and its plain version on
    the card, exactly; the kernel's ms (5 calls), the plain ms (once) and
    the bound.  Returns (ms, plain ms, bound ms, bound_by, max_abs_err,
    launches)."""
    from andix_torch import bootstrap, kernels
    from andix_torch.model import CountMatrix

    pairs = [averaged[i % len(averaged)] for i in range(BOOT_PAIRS - 1)]
    pairs.append(CountMatrix.zero(10))
    seed = 2026
    kernels.reset_launches()
    out = bootstrap.device_bootstrap_rounds(pairs, BOOT_ROUNDS, seed)
    launches = kernels.launches["bootstrap_resample"]
    counts = np.stack([p.counts for p in pairs]).astype(np.int64)
    if out.shape != (BOOT_ROUNDS, BOOT_PAIRS, 16) or launches != 1 or \
            (out.sum(axis=2) != counts.sum(axis=1)[None]).any() or \
            (out[:, -1] != 0).any() or (out[0] == out[1]).all() or \
            (out != bootstrap.device_bootstrap_rounds(
                pairs, BOOT_ROUNDS, seed)).any() or \
            (out == bootstrap.device_bootstrap_rounds(
                pairs, BOOT_ROUNDS, seed + 1)).all():
        raise AssertionError(f"bootstrap 406x1000: properties fail "
                             f"(launches {launches})")
    ct = torch.from_numpy(counts).to("cuda")
    ms = cuda_ms(lambda: bootstrap.resample(ct, BOOT_ROUNDS, seed), 5)
    t0 = time.perf_counter()
    twin = bootstrap.resample_cpu_twin(ct.cpu(), BOOT_ROUNDS, seed)
    twin_s = time.perf_counter() - t0
    tally = {}
    plain, plain_ms = _timed(lambda: bootstrap.resample_plain(
        ct, BOOT_ROUNDS, seed, tally))
    got = torch.from_numpy(out)
    err = max_abs_err([got], [plain.cpu()])
    if not torch.equal(got, twin) or err:
        raise AssertionError(f"bootstrap 406x1000: kernel != twin "
                             f"({int((got != twin).sum())} cells) or plain "
                             f"(max_abs_err {err})")
    nbytes, bytes_ms, ops_ms = boot_bound(BOOT_PAIRS, BOOT_ROUNDS, tally)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    say(f"bootstrap_resample {BOOT_PAIRS} pairs x {BOOT_ROUNDS} rounds: "
        f"kernel == twin == plain; totals kept, the zero pair zero, rerun "
        f"equal, seed {seed + 1} differs; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, twin {twin_s:.3f} s on the host; sampler work "
        f"{json.dumps(tally)}; bound {bound_ms:.6f} ms by {bound_by} "
        f"({nbytes} B -> {bytes_ms:.6f} ms, float64 operations -> "
        f"{ops_ms:.6f} ms at {FP64_OPS_PER_S:.3g}/s)")
    return ms, plain_ms, bound_ms, bound_by, err, launches


def _stalls(prof_path) -> int:
    with open(prof_path) as f:
        return sum("walk stalled" in line for line in f)


def phase_repeat(tmp, card):
    """The repeat family (g1 = g0) on both schedules.

    8 x 50 kbp on the card and on the CPU under ``ANDIX_GROUP_SUBJECTS=4``:
    all four outputs equal, and on each subject run exactly one group (g0
    to g3: the clonal pair's exact matches are longer than a search-walk
    probe can finish under the chunk cap) goes to the joint schedule
    while the other walks on the subject index.

    8 x 5 Mbp on the card: the joint block keeps every level row it needs
    and takes its LCP from the kernel; the subject schedule under
    ``ANDIX_GROUP_SUBJECTS=1`` sends exactly the groups of g0 and g1 to
    the joint schedule and walks the other six on the subject index; both
    print the same bytes.  Then the block alone (``prepare_block``): its
    SA and LCP from the kernel equal those of a backend whose budget
    holds andix's 14 rows, which overflows and retreats to the host Φ LCP
    (its phase lines show it), and those of the CPU backend (the plain
    versions); then the doubling loop's kernels on the block's text held
    to the plain loop and timed round by round (``_hold_sa``).  The whole
    CLI on the CPU at this size would spend most of the script's time
    limit in the plain flag scans, so the CLI's bytes are held to the
    CPU's on the 8 x 50 kbp copy."""
    from andix_torch import kernels
    from andix_torch import subject_pipeline as sp
    from andix_torch.esa import backend, doubling, joint
    from andix_torch.esa.backend import bucket, pad_symbols
    from andix_torch.sequence import Seq, subject_init

    small = clonal(make_family(8, 50_000))
    small_dir = os.path.join(tmp, "small")
    os.makedirs(small_dir)
    paths = write_fasta(small_dir, small)
    outs = {}
    os.environ["ANDIX_GROUP_SUBJECTS"] = "4"
    try:
        for index in ("joint", "subject"):
            for be in ("cuda", "cpu"):
                prof_path = os.path.join(small_dir, f"prof_{index}_{be}")
                os.environ.update(ANDIX_INDEX=index,
                                  ANDIX_PROF_FILE=prof_path)
                t0 = time.time()
                outs[index, be] = run_cli(["--backend", be,
                                           "--progress=never"] + paths)
                stalls = _stalls(prof_path)
                say(f"repeat family 8x50kbp ANDIX_INDEX={index} --backend "
                    f"{be}: exit {outs[index, be][0]}, {stalls} stalled "
                    f"group walk(s), {time.time() - t0:.3f} s")
                if stalls != (index == "subject"):
                    raise AssertionError(f"repeat family 8x50kbp {index} "
                                         f"{be}: {stalls} stalled groups")
    finally:
        for name in ("ANDIX_GROUP_SUBJECTS", "ANDIX_INDEX",
                     "ANDIX_PROF_FILE"):
            os.environ.pop(name, None)
    if len(set(outs.values())) != 1 or outs["joint", "cuda"][0] != 0:
        raise AssertionError(f"repeat family 8x50kbp outputs differ: {outs}")
    say("  8x50kbp repeat family: cuda == cpu on both schedules, and joint "
        f"== subject, {len(outs['joint', 'cuda'][1])} bytes")

    fam = clonal(make_family(8, 5_000_000))
    paths = write_fasta(tmp, fam)
    padded = bucket(sum(2 * len(d) + 2 for _, d in fam))
    out_j, launches_j, peak_j, wall_j, ph_j = _cli_run(
        paths, "joint", tmp, f"8x5Mbp repeat family joint on {card}")
    if any("overflow" in p or "host LCP" in p for p in ph_j) or \
            launches_j["plcp_lcp_hybrid"] < 1:
        raise AssertionError("8x5Mbp repeat family: the joint block did not "
                             "take the kernel's LCP")
    levels = [p for p in ph_j if "SA doubling" in p][0].split("] ")[-1]
    os.environ["ANDIX_GROUP_SUBJECTS"] = "1"
    try:
        out_s, _, peak_s, wall_s, ph_s = _cli_run(
            paths, "subject", tmp, f"8x5Mbp repeat family subject on {card}")
    finally:
        del os.environ["ANDIX_GROUP_SUBJECTS"]
    for line in sp.LAST_BALANCE:
        say(f"  {line}")
    stalled = [p for p in ph_s if "walk stalled" in p]
    walked = [p for p in ph_s if "sx: segmented walk" in p]
    if len(stalled) != 2 or len(walked) != 6:
        raise AssertionError(f"8x5Mbp repeat family subject: {len(stalled)} "
                             f"groups stalled, {len(walked)} walked (2 and "
                             f"6 expected)")
    if out_j != out_s:
        raise AssertionError(f"8x5Mbp repeat family: subject PHYLIP != "
                             f"joint:\n{out_s}\n{out_j}")
    say(f"  8x5Mbp repeat family: joint == subject PHYLIP; joint "
        f"{levels}, LCP from the kernel; subject: the groups of g0 and g1 "
        f"stalled and went to the joint schedule, the other six walked on "
        f"the subject index; walls joint {wall_j:.3f} s, subject "
        f"{wall_s:.3f} s; joint peak {peak_j} B = {peak_j / padded:.2f} B "
        f"per padded symbol ({padded}); subject peak {peak_s} B")
    _check_matrix(out_j, 8, rates=[0.0] + RATES[1:7])

    # the block's SA and LCP: the kernel's, the host's after an overflow
    # of andix's 14 rows, and the CPU backend's
    subjects = [subject_init(Seq(d, name), 0.025) for name, d in fam]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    n = layout.n
    cut = (backend.LEVEL_RESERVE_BYTES_PER_SYM + 4 * ANDIX_ROWS) * bucket(n)
    ctxs, phases = [], []
    for device, budget in ((torch.device("cuda", 0), None),
                           (torch.device("cuda", 0), cut),
                           (torch.device("cpu"), None)):
        prof_path = os.path.join(tmp, f"prof_block_{len(ctxs)}")
        os.environ["ANDIX_PROF_FILE"] = prof_path
        kernels.reset_launches()
        t0 = time.time()
        try:
            ctx = backend.TorchBackend(device, budget=budget).prepare_block(
                layout)
        finally:
            del os.environ["ANDIX_PROF_FILE"]
        with open(prof_path) as f:
            phases.append([line.strip() for line in f])
        ctxs.append((ctx.sa[:n].cpu(), ctx.lcp[:n].cpu(),
                     kernels.launches["plcp_lcp_hybrid"], time.time() - t0))
        del ctx
        torch.cuda.empty_cache()
    (sa_k, lcp_k, launched_k, _), (sa_h, lcp_h, launched_h, _), \
        (sa_c, lcp_c, _, t_c) = ctxs
    retreat = [p for p in phases[1] if "overflow" in p or "host LCP" in p]
    if launched_k != 1 or any("host LCP" in p for p in phases[0] + phases[2]) \
            or len(retreat) != 2 or launched_h != 0:
        raise AssertionError(f"8x5Mbp repeat block: phases {phases}")
    if max_abs_err([sa_k, lcp_k, sa_k, lcp_k], [sa_h, lcp_h, sa_c, lcp_c]):
        raise AssertionError("8x5Mbp repeat block: the kernel's SA and LCP "
                             "!= the host Φ LCP's or the CPU's")
    say(f"  8x5Mbp repeat block ({n} real of {bucket(n)} padded symbols): "
        f"SA and LCP from the kernel == after the {ANDIX_ROWS}-row budget's "
        f"retreat ({'; '.join(p.split('] ')[-1] for p in retreat)}) == the "
        f"CPU backend's ({t_c:.1f} s; "
        f"{'; '.join(p.split('] ')[-1] for p in phases[2][1:3])}); longest "
        f"adjacent LCP {int(lcp_k.max())}")
    del ctxs, sa_k, lcp_k, sa_h, lcp_h, sa_c, lcp_c
    torch.cuda.empty_cache()

    # the doubling loop on the block's text held to the plain loop (SA,
    # all 20 level rows, count, flag), then its rounds timed
    padded = bucket(n)
    sym = torch.from_numpy(pad_symbols(layout.sym, padded)).to(
        torch.device("cuda", 0))
    base = doubling.wide_base_width(len(layout.genome_ids), True)
    t0 = time.time()
    got = doubling.sa_loop(sym, True, doubling.plan_levels(
        padded, True, base, None, True, "hybrid")[0], base)
    _hold_sa("8x5Mbp repeat block", sym, base, None, got)
    del got
    say(f"  8x5Mbp repeat block loop: {time.time() - t0:.1f} s")
    del sym


def _run_grid(paths, devices, env):
    """One -m JC run of the pair grid over ``devices`` under ``env``: the
    CLI when ``devices`` are all of two or more visible cards (it takes
    them all), else ``pipeline.calculate_matrix(devices=...)`` and the
    CLI's printing.  Launch counts are set to 0 just before and read just
    after.  Returns (PHYLIP, launches by card, wall s, peak bytes by
    card)."""
    from andix_torch import fasta, kernels, output, pipeline
    from andix_torch.runtime import Context

    cards = sorted({d.index for d in devices})
    os.environ.update(env)
    try:
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(c)
        kernels.reset_launches()
        t0 = time.time()
        every_card = [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
        if len(every_card) >= 2 and devices == every_card:
            code, out = run_cli(["--backend", "cuda", "--progress=never",
                                 "-m", "JC"] + paths)
        else:
            ctx = Context()
            seqs = [s for p in paths for s in fasta.read_fasta(p, ctx)]
            M = pipeline.calculate_matrix(seqs, ctx, devices,
                                          block_syms=ctx.block_syms)
            buf = io.StringIO()
            output.print_distances(M, seqs, len(seqs), True, ctx, out=buf)
            code, out = ctx.exit_code, buf.getvalue()
        for c in cards:
            torch.cuda.synchronize(c)
        wall = time.time() - t0
        launches = {c: dict(kernels.launches_by_card.get(c, {}))
                    for c in cards}
    finally:
        for k in env:
            del os.environ[k]
    peaks = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    if code != 0:
        raise AssertionError(f"multi-card run {env}: exit code {code}")
    return out, launches, wall, peaks


def _two_processes(paths):
    """``python -m andix_torch.cli --backend cuda -m JC`` as ranks 0 and 1
    of a gloo group on loopback (torchrun's variables); each rank takes
    card LOCAL_RANK % device_count.  Returns ([(exit, stdout, stderr)],
    seconds from the launch until both exited)."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.time()
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("ANDIX_")}
        env.update(PYTHONPATH=root, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "andix_torch.cli", "--backend", "cuda",
             "--progress=never", "-m", "JC"] + paths,
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    res = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            res.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res, time.time() - t0


def phase_multi_card(paths_5m, joint_5m, paths_1m, joint_1m):
    """Phase 8: the pair grid over several workers.  With two or more
    cards the workers are the cards; with one, two workers share cuda:0.
    The 8 x 5 Mbp joint grid (sharded) and subject-index schedule (two
    groups) must print phase 7's bytes, every worker's card must launch the
    schedule's kernels; two processes at 8 x 1 Mbp must print phase 6's
    bytes from rank 0 and nothing from rank 1."""
    from andix_torch import parallel, pipeline, subject_pipeline

    count = torch.cuda.device_count()
    if count >= 2:
        devices = [torch.device("cuda", i) for i in range(count)]
        layout = (f"{count} cards, one worker each; the CLI runs with every "
                  "card visible")
    else:
        devices = [torch.device("cuda", 0)] * 2
        layout = ("1 card: two workers share cuda:0 through "
                  "calculate_matrix(devices=...); peer placement was not "
                  "exercised")
    say(f"multi-card: torch.cuda.device_count() = {count}; {layout}")

    shares = parallel.round_robin_blocks(len(paths_5m), len(devices))
    runs = [
        ("joint", {"ANDIX_INDEX": "joint"}, pipeline.LAST_BALANCE,
         ("flag_scan", "chain_walk_flat"),
         [d for d, b in zip(devices, shares) if b]),
        ("subject", {"ANDIX_INDEX": "subject", "ANDIX_GROUP_SUBJECTS": "4"},
         subject_pipeline.LAST_BALANCE, ("chain_walk_flat_sx",),
         devices[:2]),
    ]
    for label, env, balance, kernels_used, workers in runs:
        # one worker, all workers, all workers, one worker: in turns
        for turn, group in enumerate((devices[:1], devices, devices,
                                      devices[:1])):
            out, launches, wall, peaks = _run_grid(paths_5m, group, env)
            if out != joint_5m:
                raise AssertionError(f"8x5Mbp {label} over {group}: PHYLIP "
                                     f"!= the one-card joint PHYLIP:\n{out}"
                                     f"\n{joint_5m}")
            if len(group) == 1:
                say(f"multi-card 8x5Mbp {label}, run {turn + 1} of 4: one "
                    f"worker on {group[0]} (this call's baseline), wall "
                    f"{wall:.3f} s")
                continue
            say(f"multi-card 8x5Mbp {label}, run {turn + 1} of 4: "
                f"{len(workers)} workers ({', '.join(map(str, workers))}), "
                f"wall {wall:.3f} s")
            for line in balance:
                say(f"  {line}")
            for c in sorted(launches):
                say(f"  cuda:{c}: launches {launches[c]}, peak device memory "
                    f"{peaks[c]} B")
            for d in workers:
                got = launches.get(d.index, {})
                if min(got.get(k, 0) for k in kernels_used) <= 0:
                    raise AssertionError(f"{label}: {d} did not launch "
                                         f"{kernels_used}: {got}")
            if label == "subject" and any(v.get("chain_walk_flat", 0)
                                          for v in launches.values()):
                raise AssertionError(f"subject run fell back to the joint "
                                     f"walk: {launches}")
        say(f"  8x5Mbp {label}: every run's PHYLIP == the one-card joint "
            f"PHYLIP, {len(joint_5m)} bytes")

    res, wall = _two_processes(paths_1m)
    say(f"multi-process 8x1Mbp, two ranks: {wall:.3f} s from the launch "
        f"until both exited (process start and kernel load included)")
    for rank, (code, out, err) in enumerate(res):
        say(f"  rank {rank} on cuda:{rank % count}: exit {code}, {len(out)} "
            f"stdout bytes")
        if code != 0:
            raise AssertionError(f"rank {rank} failed:\n{err[-3000:]}")
    if res[0][1] != joint_1m or res[1][1]:
        raise AssertionError(f"two processes: rank 0 stdout != phase 6's, or "
                             f"rank 1 printed:\n{res[0][1]}\n{res[1][1]}")
    say("  8x1Mbp two processes: rank 0 PHYLIP == the one-process PHYLIP, "
        "rank 1 printed nothing")


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from andix_torch import kernels  # fails outside a checkout of the repo

    smi_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    smi = smi_lines[0]
    say(smi)
    for i, line in enumerate(smi_lines[1:], 1):
        say(f"card {i}: {line}")
    dev = torch.device("cuda", 0)
    t0 = time.time()
    kernels.cuda_lib()
    say(f"kernel build (nvcc sm_90a, {', '.join(kernels.CUDA_SOURCES)}): "
        f"{time.time() - t0:.2f} s")

    fs_t = phase_flag_scan(dev)
    walk_t = phase_walk(dev)
    sx_t = phase_walk_sx(dev)
    plcp_t, lcps, sa_t = phase_plcp(dev)
    rmq_t = phase_rmq(lcps)
    del lcps
    torch.cuda.empty_cache()
    phase_index_build(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_parity(tmp)
    with tempfile.TemporaryDirectory() as tmp1, \
            tempfile.TemporaryDirectory() as tmp5:
        launches, out_1m, paths_1m, events_1m = phase_main_path(tmp1, smi)
        sx_launches, out_5m, paths_5m, events_5m = phase_full_size(tmp5,
                                                                   smi)
        replay_t = phase_replay(dev, tmp1, smi, [
            ("8x1Mbp", paths_1m, out_1m, events_1m),
            ("8x5Mbp", paths_5m, out_5m, events_5m)])
        averaged = phase_unsegmented(dev, tmp5, smi, paths_5m, out_5m)
        evpack_t = phase_evpack(tmp5, smi, [("8x1Mbp", paths_1m, out_1m),
                                            ("8x5Mbp", paths_5m, out_5m)],
                                sx_launches)
        boot_t = phase_bootstrap(averaged)
        with tempfile.TemporaryDirectory() as tmp_rep:
            phase_repeat(tmp_rep, smi)
        phase_multi_card(paths_5m, out_5m, paths_1m, out_1m)

    table = {"kernels": [
        {"name": "flag_scan", "route": "cuda",
         "source": "andix_torch/csrc/flag_scan.cu",
         "replaces": "andix/esa/scans.py:221",
         "launches": launches["flag_scan"], "max_abs_err": fs_t[2],
         "ms": fs_t[0], "plain_ms": fs_t[1], "bound_ms": fs_t[3],
         "bound_by": "bytes", "library_ms": None},
        {"name": "chain_walk_flat", "route": "cuda",
         "source": "andix_torch/csrc/chain_walk.cu",
         "replaces": "andix/chain/replay_device.py:406",
         "launches": launches["chain_walk_flat"], "max_abs_err": walk_t[2],
         "ms": walk_t[0], "plain_ms": walk_t[1], "bound_ms": walk_t[3],
         "bound_by": "bytes", "library_ms": None},
        {"name": "chain_walk_flat_sx", "route": "cuda",
         "source": "andix_torch/csrc/walk_sx.cu",
         "replaces": "andix/chain/walk_sx.py:75",
         "launches": sx_launches["chain_walk_flat_sx"],
         "max_abs_err": sx_t[2], "ms": sx_t[0], "plain_ms": sx_t[1],
         "bound_ms": sx_t[3], "bound_by": "bytes", "library_ms": None},
        {"name": "plcp_lcp_hybrid", "route": "cuda",
         "source": "andix_torch/csrc/plcp.cu",
         "replaces": "andix/esa/plcp.py:267",
         "launches": launches["plcp_lcp_hybrid"], "max_abs_err": plcp_t[2],
         "ms": plcp_t[0], "plain_ms": plcp_t[1], "bound_ms": plcp_t[3],
         "bound_by": "bytes", "library_ms": None},
        {"name": "range_min_build", "route": "cuda",
         "source": "andix_torch/csrc/rmq.cu",
         "replaces": "andix/esa/rmq.py:67",
         "launches": launches["range_min_build"], "max_abs_err": rmq_t[2],
         "ms": rmq_t[0], "plain_ms": rmq_t[1], "bound_ms": rmq_t[3],
         "bound_by": "bytes", "library_ms": None},
        {"name": "replay", "route": "cuda",
         "source": "andix_torch/csrc/replay.cu",
         "replaces": "andix/chain/replay_device.py:603",
         "launches": replay_t[4], "max_abs_err": replay_t[3],
         "ms": replay_t[0], "plain_ms": replay_t[1], "bound_ms": replay_t[2],
         "bound_by": "bytes", "library_ms": None},
        {"name": "evpack_encode", "route": "cuda",
         "source": "andix_torch/csrc/evpack.cu",
         "replaces": "andix/chain/evpack.py:42",
         "launches": evpack_t[4], "max_abs_err": evpack_t[3],
         "ms": evpack_t[0], "plain_ms": evpack_t[1], "bound_ms": evpack_t[2],
         "bound_by": "bytes", "library_ms": None},
        {"name": "bootstrap_resample", "route": "cuda",
         "source": "andix_torch/csrc/bootstrap.cu",
         "replaces": "andix/bootstrap.py:39",
         "launches": boot_t[5], "max_abs_err": boot_t[4], "ms": boot_t[0],
         "plain_ms": boot_t[1], "bound_ms": boot_t[2], "bound_by": boot_t[3],
         "library_ms": None},
        {"name": "sa_keys", "route": "cuda",
         "source": "andix_torch/csrc/doubling.cu",
         "replaces": "andix/esa/doubling.py:520",
         "launches": launches["sa_keys"], "max_abs_err": sa_t["err"],
         "ms": sa_t["keys_ms"], "plain_ms": sa_t["plain_ms"],
         "bound_ms": sa_t["keys_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "sa_rerank", "route": "cuda",
         "source": "andix_torch/csrc/doubling.cu",
         "replaces": "andix/esa/doubling.py:520",
         "launches": launches["sa_rerank"], "max_abs_err": sa_t["err"],
         "ms": sa_t["rerank_ms"], "plain_ms": sa_t["plain_ms"],
         "bound_ms": sa_t["rerank_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "sa_pair_scatter", "route": "cuda",
         "source": "andix_torch/csrc/doubling.cu",
         "replaces": "andix/esa/doubling.py:191",
         "launches": launches["sa_pair_scatter"],
         "max_abs_err": sa_t["scatter"]["err"],
         "ms": sa_t["scatter"]["ms"], "plain_ms": sa_t["scatter"]["plain_ms"],
         "bound_ms": sa_t["scatter"]["bound_ms"], "bound_by": "bytes",
         "library_ms": sa_t["scatter"]["plain_ms"]},
    ]}
    say(f"chip_smoke: {time.time() - t_start:.1f} s")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
