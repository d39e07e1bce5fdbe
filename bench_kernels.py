"""Time the flag scan and the search walk at the main paths' shapes on one
CUDA card, with CUDA events, for this checkout or another one.

Run from the repository root, on a machine with a card:

    python3 bench_kernels.py [--tree DIR] [--reps 20] [--what all|scan|walk]

``--tree DIR`` imports ``andix_torch`` from DIR, a checkout of another
commit (for example one unpacked with ``git archive``), so two commits
can be timed in one call on one card, in turns.  The inputs are those of
``chip_smoke.py``: the flag scan over 10%-flagged random data at n = 2^24
(the 8 x 1 Mbp joint block) and at the 8 x 5 Mbp joint block's padded
length, forward; the search walk over the first segmented dispatch of
the 8 x 1 and 8 x 5 Mbp subject-index runs.  Each kernel is run once
before its timed launches.  Prints the card's name and power limit
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
    ap.add_argument("--what", choices=("all", "scan", "walk"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import andix_torch
    from andix_torch import kernels
    from andix_torch.chain import segmented
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
    for label, n in scan_sizes if args.what != "walk" else ():
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

    for length in (1_000_000, 5_000_000) if args.what != "scan" else ():
        index, lanes, cache_k, ecap, k = cs._sx_walk_setup(dev, 8, length,
                                                           2026)
        from andix_torch.chain import walk_sx

        ms = cs.cuda_ms(lambda: walk_sx.chain_walk_flat_sx(
            *index, lanes, segmented.CHUNK_ITERS, segmented.BIG, cache_k,
            ecap), max(1, args.reps // 4))
        label = f"8x{length // 1_000_000}Mbp subject first dispatch"
        print(f"chain_walk_flat_sx {label} (K={k}, "
              f"{lanes['row'].shape[0]} lanes): {ms:.4f} ms", flush=True)
        out[f"chain_walk_flat_sx_ms {label}"] = ms
        del index, lanes
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
