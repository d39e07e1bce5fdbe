"""The readings that set the limits of ``correct``: the control's, on a card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed, the cell's family as a run makes it, read as a run's
reference reads it (in join mode, the files as andi joins them); the
plain reference computes its counts, distances and matrix, and the
comparison of ``run.compare`` reads each of these in the program's place:

* ``float32``: the control, the reference's estimate in float32, the
  precision below the float64 the configuration states.  It has to fail
  ``distance_gap``;
* ``forward_strand``: the reference searching the subject's forward
  strand only, which breaks the configuration's guarantee that anchors
  come from both strands (a change that halves the index);
* ``half_pairs``: half the ordered pairs left out, each cell from the
  other half's counts (the matrix taken as symmetric).

One JSON line a seed; the benchmark's runs never run this.  The program
takes no part: its readings are those of the runs themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import family, run  # noqa: E402
from portbench.reference import andi  # noqa: E402


def readings(cell_name: str, seed: int, device: str, root: str = ROOT) -> dict:
    bench = run.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = run.load_json(os.path.join(root, entry["file"]))
    traffic = run.load_json(os.path.join(root, "portbench", "traffic",
                                         cell["traffic"] + ".json"))
    seqs = family.make_family(config["genomes"], config["length"],
                              traffic["rates"], seed)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        paths = (run.write_files(config, seqs, seed, tmp)
                 if config.get("join") else [])
        names, genomes = run.reference_input(config, seqs, paths)
    t0 = time.perf_counter()
    ref = andi.Reference(genomes, config["p_value"], device)
    counts, seq_len = ref.counts()
    ref_s = time.perf_counter() - t0
    dist = andi.distances(counts)
    text, code = andi.phylip(names, counts, seq_len)
    fwd, _ = ref.counts(forward_only=True)
    half = counts.copy()
    for i in range(len(names)):
        for j in range(i):
            half[i, j] = counts[j, i]
    out = {"cell": cell_name, "seed": seed, "reference_s": ref_s}
    for label, c, dtype in (("float32", counts, np.float32),
                            ("forward_strand", fwd, np.float64),
                            ("half_pairs", half, np.float64)):
        t, k = andi.phylip(names, c, seq_len, dtype)
        mat = run.Matrix(0.0, k, t, c, seq_len, andi.distances(c, dtype), {})
        out[label] = run.compare([mat], counts, seq_len, dist, text, code)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(seed), args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
