"""Trace one CLI run of ``andix_torch`` on a CUDA card with torch.profiler.

Run from the repository root, on a machine with a card:

    python3 trace_torch.py [--genomes 8] [--length 5000000]
                           [--index joint|subject|auto] [--runs 2]
                           [--replay events|loop] [--tree DIR]

``--replay loop`` traces the count-in-loop path (``ANDIX_REPLAY=loop``);
``--sa-cold`` runs no CLI and asks why a cold doubling loop is slower
than a warm one (``_sa_cold``);
``--tree DIR`` imports ``andix_torch`` from DIR, a checkout of another
commit (for example one unpacked with ``git archive``), so two commits
can be traced in one call on one card.

After the CLI runs it traces one call of the suffix-array doubling loop
(``doubling.sa_loop``) over the family's padded joint text, as the joint
block builds it, and prints its device busy time and its ten largest
device items.

It writes the synthetic family of ``chip_smoke.make_family`` to a
temporary directory, runs ``andix_torch.cli.main --backend cuda -m JC``
once untraced (kernel build and warm-up), then ``--runs`` times under
``torch.profiler`` (CPU and CUDA activities).  For each traced run it
prints the wall (host clock, from the CLI call to the matrix, ending in a
synchronize), the device busy time (the sum of the device time of every
kernel, copy and fill, which run on one stream) and its share of the
wall, the hand-written kernels' device time and launches, and the ten
largest device items.  It prints the card's name and power limit first,
and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke

OURS = ("chain_walk_flat_kernel", "walk_sx", "flag_scan", "finals_kernel",
        "prefix_kernel", "seeded_kernel", "pack_kernel", "samples_kernel",
        "settle_kernel", "fill_kernel", "fine_kernel", "t8_kernel",
        "tg_kernel", "replay_rows_kernel", "replay_cold_kernel",
        "replay_splice_kernel", "initial_key_kernel", "round_key_kernel",
        "full_key_kernel", "tail_key_kernel", "rerank_kernel",
        "pair_scatter_kernel", "evpack_key_kernel", "evpack_encode_kernel")


def _device_items(prof):
    """{name: (device microseconds, count)} for every device-side event
    (kernels, copies, fills; the host ops that launched them are left
    out, so nothing counts twice)."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        t, c = out.get(e.key, (0.0, 0))
        out[e.key] = (t + us, c + e.count)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--length", type=int, default=5_000_000)
    ap.add_argument("--index", default="joint")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--replay", default="events", choices=("events", "loop"))
    ap.add_argument("--tree", default=None)
    ap.add_argument("--sa-cold", action="store_true",
                    help="only time and trace cold and warm doubling loops")
    args = ap.parse_args(argv)
    if args.tree:
        tree = os.path.abspath(args.tree)
        sys.path.insert(0, tree)
        import andix_torch

        if not os.path.abspath(andix_torch.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"andix_torch came from {andix_torch.__file__}")
    if not torch.cuda.is_available():
        print("trace_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from torch.profiler import ProfilerActivity, profile

    label = (f"{args.genomes}x{args.length} ANDIX_INDEX={args.index} "
             f"ANDIX_REPLAY={args.replay}"
             + (f" tree {args.tree}" if args.tree else ""))
    if args.sa_cold:
        _sa_cold(label, chip_smoke.make_family(args.genomes, args.length),
                 args.runs)
        return 0
    os.environ["ANDIX_INDEX"] = args.index
    os.environ["ANDIX_REPLAY"] = args.replay
    with tempfile.TemporaryDirectory() as tmp:
        paths = chip_smoke.write_fasta(
            tmp, chip_smoke.make_family(args.genomes, args.length))
        cli = ["--backend", "cuda", "--progress=never", "-m", "JC"] + paths
        chip_smoke.run_cli(cli)  # build and warm
        for run in range(args.runs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                code, _ = chip_smoke.run_cli(cli)
                torch.cuda.synchronize()
                wall = time.time() - t0
            items = _device_items(prof)
            busy = sum(t for t, _ in items.values()) / 1e6
            ours = {k: v for k, v in items.items()
                    if any(o in k for o in OURS)}
            top = sorted(items.items(), key=lambda kv: -kv[1][0])[:10]
            print(f"trace {label} run {run + 1}: exit {code}, wall "
                  f"{wall:.6f} s, device busy {busy:.6f} s "
                  f"({100 * busy / wall:.2f}%)", flush=True)
            for k, (us, c) in sorted(ours.items()):
                print(f"  kernel {k[:60]}: {us / 1e3:.4f} ms, {c} launches")
            for k, (us, c) in top:
                print(f"  top {k[:60]}: {us / 1e3:.4f} ms, {c} calls")
            print(json.dumps({"run": run + 1, "label": label, "wall_s": wall,
                              "busy_s": busy, "kernels_ms": {
                                  k: v[0] / 1e3 for k, v in ours.items()}}),
                  flush=True)
            if code != 0:
                return 1
    _trace_sa(label, chip_smoke.make_family(args.genomes, args.length))
    return 0


def _trace_sa(label, fam):
    """torch.profiler over one doubling loop on the family's joint text
    (after one untraced call)."""
    from torch.profiler import ProfilerActivity, profile

    from andix_torch.esa import doubling

    dev = torch.device("cuda", 0)
    sym, _, _, cnt, _, base, _ = chip_smoke._joint_text(dev, fam)
    n = sym.shape[0]
    L = doubling.plan_levels(n, True, base, None, True, "hybrid")[0]
    doubling.sa_loop(sym, True, L, base)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        doubling.sa_loop(sym, True, L, base)
        torch.cuda.synchronize()
        wall = time.time() - t0
    items = _device_items(prof)
    busy = sum(t for t, _ in items.values()) / 1e6
    print(f"trace {label} sa_loop (n={n}, {cnt} levels): wall {wall:.6f} s, "
          f"device busy {busy:.6f} s ({100 * busy / wall:.2f}%)", flush=True)
    for k, (us, c) in sorted(items.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  top {k[:60]}: {us / 1e3:.4f} ms, {c} calls", flush=True)


def _sa_cold(label, fam, runs):
    """Why a cold doubling loop is slower than a warm one.  The loop over
    the family's padded joint text, on the host clock to a synchronize,
    after each of four preludes in turns (each after a warm call): none
    (warm), 2 s of sleep with the allocator's cache kept (idle),
    ``torch.cuda.empty_cache()`` (emptied, as ``bench_kernels.py``'s cold
    call and the CLI's first block meet it) and both; ``runs`` rounds.
    Then each prelude once more under torch.profiler: the wall, the
    device busy time, the hand kernels' device ms, and the host's CUDA
    runtime calls (cudaMalloc, cudaFree, module loads, ...) by total
    ms."""
    from torch.profiler import ProfilerActivity, profile

    from andix_torch.esa import doubling

    dev = torch.device("cuda", 0)
    sym, _, _, cnt, _, base, _ = chip_smoke._joint_text(dev, fam)
    n = sym.shape[0]
    L = doubling.plan_levels(n, True, base, None, True, "hybrid")[0]

    def call():
        doubling.sa_loop(sym, True, L, base)

    def idle():
        time.sleep(2)

    def both():
        torch.cuda.empty_cache()
        idle()

    preludes = {"warm": lambda: None, "idle": idle,
                "emptied": torch.cuda.empty_cache, "emptied+idle": both}
    times = {k: [] for k in preludes}
    for _ in range(runs):
        for name, prelude in preludes.items():
            call()
            torch.cuda.synchronize()
            prelude()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    for name, ms in times.items():
        print(f"sa_cold {label} (n={n}, {cnt} levels) {name}: "
              + ", ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
    for name, prelude in preludes.items():
        call()
        torch.cuda.synchronize()
        prelude()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        items = _device_items(prof)
        busy = sum(t for t, _ in items.values()) / 1e3
        host = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CPU and \
                    e.key.startswith("cu"):
                us, c = host.get(e.key, (0, 0))
                host[e.key] = (us + e.self_cpu_time_total, c + e.count)
        print(f"sa_cold {label} traced {name}: wall {1e3 * wall:.4f} ms, "
              f"device busy {busy:.4f} ms", flush=True)
        for k, (us, c) in sorted(items.items(), key=lambda kv: -kv[1][0]):
            if any(o in k for o in OURS) or us > 1000:
                print(f"  device {k[:60]}: {us / 1e3:.4f} ms, {c} calls")
        for k, (us, c) in sorted(host.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"  host {k[:60]}: {us / 1e3:.4f} ms, {c} calls")


if __name__ == "__main__":
    sys.exit(main())
