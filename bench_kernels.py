"""Time the flag scan, the search walk, the sampled-PLCP LCP, the
range-min build, the count-in-loop replay and the suffix-array doubling
loop at the main paths' shapes on one CUDA card, with CUDA events, for
this checkout or another one.

Run from the repository root, on a machine with a card:

    python3 bench_kernels.py [--tree DIR] [--reps 20]
                             [--what all | a list of
                                     scan,walk,plcp,rmq,replay,sa,evpack,
                                     boot,cli]
                             [--segments 1,8,16,32]
                             [--windows 19,20,21,22,23,24]

``--tree DIR`` imports ``andix_torch`` from DIR, a checkout of another
commit (for example one unpacked with ``git archive``), so two commits
can be timed in one call on one card, in turns.  The inputs are those of
``chip_smoke.py``: the flag scan over 10%-flagged random data at n = 2^24
(the 8 x 1 Mbp joint block) and at the 8 x 5 Mbp joint block's padded
length, forward; the search walk over the first segmented dispatch of
the 8 x 1 and 8 x 5 Mbp subject-index runs; ``plcp_lcp_hybrid`` over
the padded joint texts of 8 x 1 and 8 x 5 Mbp and of the 8 x 1 Mbp
clonal family, with every level row and cut to 14 rows; ``rmq.build``
over the 8 x 1 and 8 x 5 Mbp joint LCPs (in a tree from before the
range-min kernel, that is the torch build); the count-in-loop replay
(``replay_rows``, with its default segments where the tree has them)
over every lane of the 8 x 1 and 8 x 5 Mbp joint blocks, JC and LogDet,
and with ``--segments`` (a tree with segmented replay lanes) again at
each K listed: its counts and tallies held to the default K's, the
call's ms, each pass's device ms and the splice counters
(``chip_smoke.replay_passes``); the doubling loop (``doubling.sa_loop``,
every level row the text needs) over the padded joint texts of 8 x 1
Mbp (2^24) and 8 x 5 Mbp (100,663,296) and of both clonal families, one
call cold (the allocator's cache emptied) and then warm, with the
device bytes one call allocates at its peak above what it was given (in
a tree from before the doubling kernels, that is the torch loop); with
``--windows`` (a tree with the partitioned rank scatter) the warm loop
again with the scatter forced into windows of 2^s suffixes for each s
listed and forced direct, each with one traced run's full-round and
tail-round rerank and pair-scatter ms and each tail round's entries and
ms, so the window and the tail rule can be read off.  ``--what evpack``
runs the 8 x 1 and 8 x 5 Mbp families on the subject-index schedule,
keeps every walk dispatch's event buffers, holds the encode to its plain
version on each and times it (``chip_smoke.encode_split``: the call, its
device time in the hand kernels, the library sort and the rest, and
``torch.sort(stable=True)`` of the same keys).  ``--what boot`` times the
resampler at ``chip_smoke.phase_bootstrap``'s 406 pairs x 1000 rounds and
again with each pair repeated 32 times in a row over 32 rounds, where a
warp of a thread-a-(round, pair) kernel holds 32 copies of one pair: the
two times show what pairs that differ inside a warp cost.  ``--what cli``
(not in ``all``) runs the CLI on the 8 x 5 Mbp family under
``ANDIX_INDEX=subject`` and ``joint``, three times each in turns, and
prints each run's wall with its "sx: index build" or "SA doubling"
phase (``ANDIX_PROF_FILE``, timed by CUDA events; the block's loop is a
cold call there).  Each kernel is run once before its timed launches.
``--split`` also prints the device time of each launch of one PLCP
call, from torch.profiler.  Prints the card's name and power limit
first, one line per measurement, and one JSON object last; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever andix_torch is imported
    (it imports the package only inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="also trace one PLCP call with torch.profiler and "
                    "print each of its launches' device time")
    ap.add_argument("--segments", default="",
                    help="comma-separated query segments K at which to "
                    "time the replay too")
    ap.add_argument("--windows", default="",
                    help="comma-separated log2 window sizes at which to "
                    "time the doubling loop's partitioned scatter too")
    ap.add_argument("--what", default="all",
                    help="all, or a comma-separated list of scan, walk, "
                    "plcp, rmq, replay, sa, evpack, boot, cli")
    args = ap.parse_args(argv)
    what = set(args.what.split(","))
    if not what <= {"all", "scan", "walk", "plcp", "rmq", "replay", "sa",
                    "evpack", "boot", "cli"}:
        ap.error(f"--what {args.what}")
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import andix_torch
    from andix_torch import kernels
    from andix_torch.esa import scans
    from andix_torch.esa.backend import bucket

    if not os.path.abspath(andix_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"andix_torch came from {andix_torch.__file__}")
    cs = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kernels.cuda_lib()
    out = {"tree": tree, "card": smi}

    rng = np.random.default_rng(7)
    scan_sizes = (("2^24", 1 << 24),
                  ("8x5Mbp joint", bucket(8 * (2 * 5_000_000 + 2))))
    def wants(name):
        return bool(what & {"all", name})

    for label, n in scan_sizes if wants("scan") else ():
        v = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)).to(dev)
        f = torch.from_numpy(rng.random(n) < 0.1).to(dev)
        p = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(dev)
        ms = cs.cuda_ms(lambda: scans.flag_scan(v, f, p), args.reps)
        bound = 25 * n / cs.HBM_BYTES_PER_S * 1e3
        print(f"flag_scan n={n} ({label}): {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%)", flush=True)
        out[f"flag_scan_ms n={n}"] = ms
        del v, f, p
        torch.cuda.empty_cache()

    for length in (1_000_000, 5_000_000) if wants("walk") else ():
        index, lanes, cache_k, ecap, k = cs._sx_walk_setup(dev, 8, length,
                                                           2026)
        from andix_torch.chain import walk_sx

        ms = cs.cuda_ms(lambda: walk_sx.chain_walk_flat_sx(
            *index, lanes, cs.WALK_FIRST_ITERS, cs.WALK_BIG, cache_k,
            ecap), max(1, args.reps // 4))
        label = f"8x{length // 1_000_000}Mbp subject first dispatch"
        print(f"chain_walk_flat_sx {label} (K={k}, "
              f"{lanes['row'].shape[0]} lanes): {ms:.4f} ms", flush=True)
        out[f"chain_walk_flat_sx_ms {label}"] = ms
        del index, lanes
        torch.cuda.empty_cache()

    if wants("plcp") or wants("rmq"):
        out.update(_plcp_rmq(cs, dev, args.reps, wants("plcp"),
                             wants("rmq"), args.split))
    if wants("replay"):
        segments = [int(k) for k in args.segments.split(",") if k]
        out.update(_replay(cs, dev, max(1, args.reps // 4), segments))
    if wants("sa"):
        windows = [int(w) for w in args.windows.split(",") if w]
        out.update(_sa(cs, dev, max(1, args.reps // 4), windows))
    if wants("evpack"):
        out.update(_evpack(cs, max(1, args.reps // 4)))
    if wants("boot"):
        out.update(_boot(cs, max(1, args.reps // 4)))
    if "cli" in what:
        out.update(_cli(cs))
    print(json.dumps(out), flush=True)
    return 0


def _plcp_rmq(cs, dev, reps, do_plcp, do_rmq, split=False):
    """The sampled-PLCP LCP and the range-min build, timed over the joint
    texts of ``chip_smoke.phase_plcp``; with ``split``, the PLCP call's
    device time by launch."""
    from andix_torch.esa import plcp, rmq

    out = {}
    for label, fam, cap in (
            ("8x1Mbp", cs.make_family(8, 1_000_000), None),
            ("8x5Mbp", cs.make_family(8, 5_000_000), None),
            ("8x1Mbp clonal", cs.clonal(cs.make_family(8, 1_000_000)), None),
            ("8x1Mbp clonal, 14 rows",
             cs.clonal(cs.make_family(8, 1_000_000)), 14)):
        if cap is not None and not do_plcp:
            continue
        sym, sa, levels, cnt, _, base, _ = cs._joint_text(dev, fam, cap)
        args = (sym, sa, levels, cnt, base)
        lcp = plcp.plcp_lcp_hybrid(*args)[0]
        if do_plcp:
            ms = cs.cuda_ms(lambda: plcp.plcp_lcp_hybrid(*args), reps // 4
                            or 1)
            print(f"plcp_lcp_hybrid {label} (n={sym.shape[0]}, "
                  f"{len(levels)} rows): {ms:.4f} ms", flush=True)
            out[f"plcp_lcp_hybrid_ms {label}"] = ms
            if split:
                parts = cs.device_split(lambda: plcp.plcp_lcp_hybrid(*args))
                print(f"  device ms by launch: {json.dumps(parts)}",
                      flush=True)
        if do_rmq and "clonal" not in label:
            ms = cs.cuda_ms(lambda: rmq.build(lcp), reps)
            print(f"rmq.build {label} (n={lcp.shape[0]}): {ms:.4f} ms",
                  flush=True)
            out[f"rmq_build_ms {label}"] = ms
        del sym, sa, levels, args, lcp
        torch.cuda.empty_cache()
    return out


def _sa(cs, dev, reps, windows=()):
    """The doubling loop over ``chip_smoke``'s padded joint texts (and the
    repeat family's): one cold call (the allocator's cache emptied first,
    as the CLI's block build meets it; host clock to a synchronize), the
    warm call's ms and its peak device bytes above its inputs; then at
    each window of ``windows`` and with the direct scatter
    (``_sa_windows``)."""
    from andix_torch.esa import doubling

    out = {}
    for label, fam in (("8x1Mbp", cs.make_family(8, 1_000_000)),
                       ("8x5Mbp", cs.make_family(8, 5_000_000)),
                       ("8x1Mbp clonal",
                        cs.clonal(cs.make_family(8, 1_000_000))),
                       ("8x5Mbp clonal",
                        cs.clonal(cs.make_family(8, 5_000_000)))):
        sym, sa, levels, cnt, _, base, _ = cs._joint_text(dev, fam)
        del sa, levels
        n = sym.shape[0]
        L = doubling.plan_levels(n, True, base, None, True, "hybrid")[0]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doubling.sa_loop(sym, True, L, base)
        torch.cuda.synchronize()
        cold = 1e3 * (time.perf_counter() - t0)
        ms = cs.cuda_ms(lambda: doubling.sa_loop(sym, True, L, base), reps)
        _, _, peak = cs._peak_since(lambda: doubling.sa_loop(sym, True, L,
                                                             base))
        print(f"sa_loop {label} (n={n}, {cnt} levels): cold {cold:.4f} ms, "
              f"warm {ms:.4f} ms, peak {peak} B above the text = "
              f"{peak / n:.2f} B a position", flush=True)
        out[f"sa_loop_cold_ms {label}"] = cold
        out[f"sa_loop_ms {label}"] = ms
        out[f"sa_loop_peak_bytes {label}"] = peak
        if windows:
            out.update(_sa_windows(cs, label, sym, L, base, reps, windows))
        del sym
        torch.cuda.empty_cache()
    return out


def _sa_windows(cs, label, sym, L, base, reps, windows):
    """The warm loop with the rank scatter forced into windows of 2^s
    suffixes (every full and tail round), and forced direct (window
    "direct"); for each, one traced run's rerank and pair-scatter ms
    summed over the full rounds and over the tail rounds, and each tail
    round's entries with its rerank + scatter ms."""
    from andix_torch.esa import doubling

    n = sym.shape[0]
    out = {}
    for w in [None] + list(windows):
        parts = 0 if w is None else -(-n >> w)
        if parts > doubling._MAX_PARTS:
            continue
        name = "direct" if w is None else f"2^{w} ({parts} parts)"
        ms = cs.cuda_ms(lambda: doubling.sa_loop(
            sym, True, L, base, doubling.Kernels(parts=parts)), reps)
        trace = []
        doubling.sa_loop(sym, True, L, base,
                         doubling.Kernels(parts=parts, trace=trace))
        sums = {}
        tails = []
        for r in trace:
            kind = "tail" if r["kind"] == "tail" else "full"
            for key in ("keys_ms", "rerank_ms", "scatter_ms"):
                sums[f"{kind} {key}"] = sums.get(f"{kind} {key}", 0.0) + r[key]
            if kind == "tail":
                tails.append(f"{r['entries']}:"
                             f"{r['rerank_ms'] + r['scatter_ms']:.4f}")
        print(f"  sa_loop {label} window {name}: warm {ms:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + f"; tail rounds (entries:ms) {' '.join(tails)}", flush=True)
        out[f"sa_loop_ms {label} window {name}"] = ms
    return out


def _evpack(cs, reps):
    """The packed encode on every walk dispatch of the 8 x 1 and 8 x 5 Mbp
    subject-index runs: held to the plain version, then timed and split
    (``chip_smoke.encode_split``)."""
    import tempfile

    from andix_torch import subject_pipeline as sp
    from andix_torch.chain import evpack

    out = {}
    for length in (1_000_000, 5_000_000):
        label = f"8x{length // 1_000_000}Mbp"
        with tempfile.TemporaryDirectory() as tmp:
            paths = cs.write_fasta(tmp, cs.make_family(8, length))
            _, kept = cs.keep_dispatches(paths, tmp, label)
        for d, (ev4, cnt, lb, ecap) in enumerate(kept):
            k = min(sp.bucket(max(cnt, 1), 4096), ecap)
            if cs.max_abs_err(
                    [evpack.encode_events_flat(*ev4, cnt, k, lb)],
                    [evpack.encode_events_plain(*ev4, cnt, k, lb)]):
                raise AssertionError(f"evpack {label} dispatch {d}: kernel "
                                     "!= plain")
            split = cs.encode_split(ev4, cnt, k, lb, reps)
            print(f"evpack {label} dispatch {d} ({cnt} events, k {k}, {lb} "
                  f"lanes): {cs.split_text(split)}; == plain", flush=True)
            out[f"evpack_ms {label} dispatch {d}"] = split["ms"]
        del kept
        torch.cuda.empty_cache()
    return out


def _boot(cs, reps):
    """The resampler at chip_smoke's 406 pairs (the 8 x 5 Mbp family's
    averaged count matrices) x 1000 rounds, and with each pair repeated
    32 times in a row over 32 rounds (the same draws' work, about)."""
    from andix_torch import bootstrap, pipeline
    from andix_torch.runtime import Context
    from andix_torch.sequence import Seq

    grid = pipeline.calculate_matrix(
        [Seq(d, nm) for nm, d in cs.make_family(8, 5_000_000)], Context(),
        [torch.device("cuda", 0)])
    pairs = cs.boot_pairs(cs.averaged_pairs(grid))
    counts = torch.from_numpy(np.stack([p.counts for p in pairs]).astype(
        np.int64)).to("cuda")
    out = {}
    for label, ct, rounds in (
            (f"{counts.shape[0]} pairs x {cs.BOOT_ROUNDS} rounds", counts,
             cs.BOOT_ROUNDS),
            (f"{counts.shape[0]} pairs each 32 times x 32 rounds",
             counts.repeat_interleave(32, dim=0), 32)):
        ms = cs.cuda_ms(lambda: bootstrap.resample(ct, rounds, cs.BOOT_SEED),
                        reps)
        print(f"bootstrap_resample {label}: {ms:.4f} ms", flush=True)
        out[f"bootstrap_ms {label}"] = ms
    return out


def _cli(cs, runs=3):
    """The CLI over the 8 x 5 Mbp family (``chip_smoke``'s) under each
    schedule, ``runs`` times in turns after one untraced run: each run's
    wall and its index-build or SA-doubling phase seconds."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = cs.write_fasta(tmp, cs.make_family(8, 5_000_000))
        cs.run_cli(["--backend", "cuda", "--progress=never", "-m", "JC"]
                   + paths)
        for run in range(runs):
            for index in ("subject", "joint"):
                _, _, _, wall, phases = cs._cli_run(
                    paths, index, tmp, f"8x5Mbp {index} run {run + 1}")
                picked = [p.split("] ", 1)[-1] for p in phases
                          if "SA doubling" in p or "index build" in p]
                print(f"cli 8x5Mbp ANDIX_INDEX={index} run {run + 1}: wall "
                      f"{wall:.3f} s; {'; '.join(picked)}", flush=True)
                out[f"cli_wall_s 8x5Mbp {index} run {run + 1}"] = wall
    return out


def _replay(cs, dev, reps, segments):
    """The count-in-loop replay over every lane of chip_smoke's 8 x 1 and
    8 x 5 Mbp joint blocks, JC and LogDet, with its counts' sum; then at
    each K of ``segments``, held to the default call's counts and
    tallies."""
    from andix_torch.chain import replay_device as rd
    from andix_torch.esa.backend import CHASE

    out = {}
    for length in (1_000_000, 5_000_000):
        be, ctx, subjects, mlun, ps, lanes = cs._replay_block(
            dev, cs.make_family(8, length))
        label = f"8x{length // 1_000_000}Mbp"
        for exact in (False, True):
            args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, exact, CHASE)
            counts, tally = rd.replay_rows(*args)
            ms = cs.cuda_ms(lambda: rd.replay_rows(*args), reps)
            mode = "LogDet" if exact else "JC"
            print(f"replay {label} {mode}: {ms:.4f} ms; counts sum "
                  f"{int(counts.long().sum())}, longest lane "
                  f"{int(tally[..., 0].max())} probe steps", flush=True)
            out[f"replay_ms {label} {mode}"] = ms
            for k in segments:
                got = rd.replay_rows(*args, segments=k)
                if cs.max_abs_err(got, (counts, tally)):
                    raise AssertionError(f"replay {label} {mode} K={k}: "
                                         "counts or tallies moved")
                timed = cs.replay_passes(args, reps, k)
                print(f"  {label} {mode} at {cs._splice_text(*timed)}; == "
                      "the default K's counts and tallies", flush=True)
                out[f"replay_ms {label} {mode} K={k}"] = timed[0]
        del be, ctx, subjects, mlun, ps, lanes, args
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
