"""Run one cell of the benchmark of ``andix_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The cell is read from ``BENCHMARK.json``; its
configuration from its ``file``, its traffic mix from
``portbench/traffic/<traffic>.json`` and each metric from
``portbench/metrics/<name>.py`` (a ``read(record)`` that returns a number,
or None where it finds nothing to read).  A new configuration, mix or
metric is a new file and a new entry, and no edit here.

A run: the family the mix describes is generated from ``--seed`` and
written as FASTA under ``TMPDIR``; the port's kernel and host libraries
are built (first run in a checkout) and loaded; one matrix runs cold.
Then the window: whole matrices back to back, one client in a closed
loop, none started after ``--seconds``.  Each is one call of the CLI,
``andix_torch.cli.main(["--backend", "cuda", "--progress=never", "-m",
"JC", *fasta])``, from the call to the printed matrix and a synchronize.
With ``--trace 1`` the window's first half runs under ``torch.profiler``
and its second with the program's phase file on.  After the window the
program's state is freed and the plain reference (``portbench/reference``)
computes the matrix from the same genomes; ``correct`` holds when every
matrix's counts and printed lines are the reference's, its unrounded
distances lie within ``distance_gap``'s limit of the reference's float64
ones, and each matrix took the configuration's schedule.  The numbers compared are printed,
each with its limit, as the last lines on standard error and under the
result's last key.  The last line on standard output is the result.

Two keys of a configuration change the files and the call; without them
a run is as described.  ``"assembly": {"contigs", "min_contig",
"reverse_share", "order": "longest_first"}`` writes each genome as a
draft assembly (``family.write_assembly``): its contigs, some
reverse-complemented, longest first, in the genome's one file.
``"join": true`` adds ``-j``, andi's join mode: the argv is
``["--backend", "cuda", "--progress=never", "-m", "JC", "-j", *fasta]``,
and the reference reads each file as andi does (``andi.read_join``: the
records joined in file order with '!', the genome named after the file).
A run refuses, before anything is timed, with a message and no result, a
configuration it cannot check: a ``model`` other than ``JC`` (the
reference estimates JC alone), and ``assembly`` without ``join`` (each
contig would be a taxon of its own).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import family, phases, trace  # noqa: E402
from portbench.reference import andi  # noqa: E402

PROGRAM = "andix_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "andix")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# the kernel each schedule's walk launches, and the one it must not
SCHEDULE_WALKS = {"joint": ("chain_walk_flat", "chain_walk_flat_sx"),
                  "subject": ("chain_walk_flat_sx", "chain_walk_flat")}
# each number compared and its limit: the counts, lines, exit codes and
# schedules are exact; ``distance_gap``, the largest gap of an unrounded
# distance from the reference's float64 one, as a share of it, is set
# between the sound runs' readings and the float32 control's (PERF.md)
LIMITS = {"count_cells_off": 0, "distance_gap": 1e-9,
          "matrix_lines_off": 0, "exit_code_off": 0,
          "window_matrices_off": 0, "schedule_off": 0}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(root: str, name: str):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace_on: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    def reports(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    if not trace_on:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if m["moves"] in names and reports(m)]


class Matrix(NamedTuple):
    """One CLI call: its wall, exit code, printed matrix, the counts it
    printed from, the distances it printed unrounded, and the kernel
    launches it made."""

    seconds: float
    code: int
    out: str
    counts: np.ndarray  # [n, n, 16]
    seq_len: np.ndarray  # [n, n]
    dist: np.ndarray  # [n, n] float64, nan where none was estimated
    launches: dict


def refusal(config: dict) -> str | None:
    """Why a run cannot check this configuration, or None."""
    if config["model"] != "JC":
        return (f"model {config['model']!r}: the reference estimates JC "
                "alone")
    if "assembly" in config and not config.get("join"):
        return ("assembly without join: each contig would be a taxon of "
                "its own")
    return None


def cli_options(config: dict) -> list[str]:
    """What a matrix call passes between ``--progress=never`` and the
    files."""
    return ["-m", config["model"]] + (["-j"] if config.get("join") else [])


def write_files(config: dict, seqs, seed: int, directory: str) -> list[str]:
    """The family's files: one record a genome, or each genome's draft
    assembly where the configuration has one."""
    if "assembly" in config:
        return family.write_assembly(directory, seqs, config["assembly"],
                                     seed)
    return family.write_fasta(directory, seqs)


def reference_input(config: dict, seqs, paths: list[str]):
    """The names and genomes the reference takes: the family's, or in join
    mode each file as andi reads it."""
    if config.get("join"):
        seqs = [andi.read_join(p) for p in paths]
    return [n for n, _ in seqs], [d for _, d in seqs]


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


class Program:
    """The port, imported from this checkout, its matrix call and what
    each call leaves: exit code, printed matrix, counts, distances and
    launches."""

    def __init__(self, root: str, backend: str):
        for var in [v for v in os.environ if v.startswith("ANDIX_")]:
            del os.environ[var]  # the program runs as it ships
        import andix_torch
        from andix_torch import cli, kernels, model, native, pipeline

        where = os.path.dirname(os.path.abspath(andix_torch.__file__))
        if os.path.realpath(where) != os.path.realpath(
                os.path.join(root, PROGRAM)):
            raise RuntimeError(f"{PROGRAM} came from {where}, not {root}")
        self.dir = where
        self.cli, self.kernels, self.pipeline = cli, kernels, pipeline
        self.model = model
        self.backend = backend
        self.cuda = backend == "cuda"
        if self.cuda:
            kernels.cuda_lib()  # nvcc at the first run of a checkout
        if not native.available():
            raise RuntimeError("the port's host library did not load")
        self._calc = pipeline.calculate_matrix
        self._estimate = model.estimate
        self.last_grid = None
        self.estimates: list[float] = []

    def _recording(self, *args, **kwargs):
        grid = self._calc(*args, **kwargs)
        self.last_grid = grid
        return grid

    def _estimating(self, *args, **kwargs):
        d = self._estimate(*args, **kwargs)
        self.estimates.append(d)
        return d

    def matrix(self, paths: list[str], options: list[str]) -> Matrix:
        self.kernels.reset_launches()
        self.pipeline.calculate_matrix = self._recording
        self.model.estimate = self._estimating
        self.estimates = []
        buf = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                code = self.cli.main(["--backend", self.backend,
                                      "--progress=never", *options, *paths])
            if self.cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            self.pipeline.calculate_matrix = self._calc
            self.model.estimate = self._estimate
        grid, self.last_grid = self.last_grid, None
        n = len(paths)
        counts = np.zeros((n, n, 16), dtype=np.int64)
        seq_len = np.zeros((n, n), dtype=np.int64)
        if grid is not None:
            for i in range(n):
                for j in range(n):
                    counts[i, j] = grid[i][j].counts
                    seq_len[i, j] = grid[i][j].seq_len
        # the printer estimates each pair i != j once, row by row
        dist = np.full((n, n), np.nan)
        if len(self.estimates) == n * (n - 1):
            np.fill_diagonal(dist, 0.0)
            dist[~np.eye(n, dtype=bool)] = self.estimates
        return Matrix(seconds, code, buf.getvalue(), counts, seq_len, dist,
                      dict(self.kernels.launches))


def distance_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest gap of a distance from the reference's, as a share of
    the reference's (absolute where that is 0); a nan on one side only,
    or a distance missing, is a gap of 1, the whole distance."""
    both_nan = np.isnan(got) & np.isnan(want)
    with np.errstate(invalid="ignore"):
        gap = np.abs(got - want) / np.where(want > 0, want, 1.0)
    gap = np.where(both_nan, 0.0, gap)
    return float(np.nan_to_num(gap, nan=1.0, posinf=1.0).max())


def compare(matrices: list[Matrix], counts, seq_len, dist, text: str,
            code: int) -> dict:
    """The numbers that set each matrix against the reference's: count
    cells (16 a pair, and each pair's sequence length) that differ, the
    distances' gap, printed lines that differ, and a differing exit code,
    each the most over the matrices."""
    want = text.splitlines()

    def lines_off(out: str) -> int:
        got = out.splitlines()
        return (sum(a != b for a, b in zip(got, want))
                + abs(len(got) - len(want)))

    return {
        "count_cells_off": max(int((m.counts != counts).sum())
                               + int((m.seq_len != seq_len).sum())
                               for m in matrices),
        "distance_gap": max(distance_gap(m.dist, dist) for m in matrices),
        "matrix_lines_off": max(lines_off(m.out) for m in matrices),
        "exit_code_off": max(int(m.code != code) for m in matrices),
    }


def schedule_ok(schedule: str, launches: dict, cuda: bool) -> bool:
    """Whether a matrix took its configuration's schedule, by the walk
    kernels it launched (the plain versions on the CPU count none)."""
    if not cuda:
        return True
    walk, other = SCHEDULE_WALKS[schedule]
    return launches[walk] > 0 and launches[other] == 0


def card_peaks(by_card: list[int]) -> dict:
    """The window's peak allocated bytes: each card's, and the fullest
    card's (0 without a card)."""
    return {"peak_bytes_by_card": by_card,
            "peak_bytes": max(by_card, default=0)}


def card_info() -> dict:
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout
        info["power_limit_w"] = float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run(cell_name: str, seed: int, seconds: float, trace_on: bool,
        root: str = ROOT, backend: str = "cuda", out=None) -> int:
    """The run after the look for a card; ``backend="cpu"`` drives the
    port's plain versions (the tests)."""
    out = out if out is not None else sys.stdout
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    why_not = refusal(config)
    if why_not:
        print(f"portbench: {cell_name} cannot be checked: {why_not}",
              file=sys.stderr)
        return 2
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     cell["traffic"] + ".json"))
    metrics = [(m, load_metric(root, m["name"]))
               for m in cell_metrics(bench, cell_name, trace_on)]
    cuda = backend == "cuda"
    tmp = tempfile.mkdtemp(prefix="portbench-")
    marks = [("imports", time.time() - T_START)]
    try:
        seqs = family.make_family(config["genomes"], config["length"],
                                  traffic["rates"], seed)
        marks.append(("family", time.time() - T_START))
        paths = write_files(config, seqs, seed, tmp)
        marks.append(("fasta", time.time() - T_START))
        prog = Program(root, backend)
        marks.append(("program and libraries", time.time() - T_START))
        options = cli_options(config)
        record = {"cell": cell, "config": config, "traffic": traffic,
                  "hbm_bytes_per_s": HBM_BYTES_PER_S,
                  "card": card_info() if cuda else None}
        cold = prog.matrix(paths, options)
        record["cold_matrix_s"] = cold.seconds
        cards = torch.cuda.device_count() if cuda else 0
        for d in range(cards):
            torch.cuda.reset_peak_memory_stats(d)
        t_window = time.perf_counter()
        record["setup_s"] = time.time() - T_START
        marks.append(("cold matrix", record["setup_s"]))
        end = t_window + seconds
        window = []
        busy_s = window_s = None
        if not trace_on:
            while not window or time.perf_counter() < end:
                window.append(prog.matrix(paths, options))
            record["window"] = {"seconds": time.perf_counter() - t_window,
                                "completed": len(window)}
        else:
            half = t_window + seconds / 2
            from torch.profiler import ProfilerActivity, profile
            sampler = trace.HostSampler(threading.get_ident(), prog.dir)
            starts = []
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            sampler.start()
            try:
                with profile(activities=acts) as prof:
                    while not starts or time.perf_counter() < half:
                        starts.append(time.perf_counter() * 1e6)
                        with torch.profiler.record_function(trace.MARK):
                            window.append(prog.matrix(paths, options))
            finally:
                sampler.stop()
            record["profile"] = trace.read_profile(prof, starts,
                                                   sampler.samples, cards)
            del prof
            # the device's busy seconds averaged over the cards; the
            # profile's ``busy_s`` stays their union
            by_card = record["profile"]["busy_s_by_card"]
            busy_s = (sum(by_card[d] for d in range(cards)) / cards if cards
                      else record["profile"]["busy_s"])
            window_s = record["profile"]["wall_s"]
            prof_file = os.path.join(tmp, "phases.txt")
            record["phase_matrices"] = []
            while not record["phase_matrices"] or time.perf_counter() < end:
                open(prof_file, "w").close()
                os.environ["ANDIX_PROF_FILE"] = prof_file
                try:
                    mat = prog.matrix(paths, options)
                finally:
                    del os.environ["ANDIX_PROF_FILE"]
                with open(prof_file) as f:
                    record["phase_matrices"].append(
                        {"wall_s": mat.seconds,
                         "phases": phases.parse(f.read())})
                window.append(mat)
        record.update(card_peaks([torch.cuda.max_memory_allocated(d)
                                  for d in range(cards)]))
        peak = record["peak_bytes"]
        record["window_walls"] = [m.seconds for m in window]
        attempted = len(window)
        failed = sum(1 for m in window if m.code != 0 or m.out != cold.out)
        kept = [cold] + window
        schedule_off = sum(
            1 for m in kept
            if not schedule_ok(config["schedule"], m.launches, cuda))
        del prog, window
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        values = {}
        for m, read in metrics:
            v = read(record)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}

        for d in range(cards):
            torch.cuda.reset_peak_memory_stats(d)
        t_ref = time.perf_counter()
        names, genomes = reference_input(config, seqs, paths)
        ref = andi.Reference(genomes, config["p_value"],
                             "cuda" if cuda else "cpu")
        counts, seq_len = ref.counts()
        dist = andi.distances(counts)
        text, code = andi.phylip(names, counts, seq_len)
        del ref, genomes
        ref_s = time.perf_counter() - t_ref
        ref_peak = max((torch.cuda.max_memory_allocated(d)
                        for d in range(cards)), default=0)
        checks = compare(kept, counts, seq_len, dist, text, code)
        checks.update({
            "window_matrices_off": failed,
            "schedule_off": schedule_off,
        })
        correct = attempted > 0 and all(
            checks[k] <= LIMITS[k] for k in LIMITS)
        found = forbidden_modules()
        if found:
            print(f"portbench: modules of the JAX package or JAX are loaded: "
                  f"{', '.join(found)}", file=sys.stderr)
            return 3
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": record["card"]["name"] if cuda else "cpu",
                  "count": cards,
                  "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct), "attempted": attempted,
                  "failed": failed, "metrics": values, "device": device}
        if trace_on:
            device["busy_s"] = busy_s
            device["window_s"] = window_s
            prof_rec = record["profile"]
            ops = sorted(prof_rec["kernels"].items(),
                         key=lambda kv: -kv[1][0])[:10]
            idle = sorted(prof_rec["idle_by_host"].items(),
                          key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {
                "device_ops": [[name[:200], s] for name, (s, _) in ops],
                "idle_gaps": [[label[:200], s] for label, s in idle]}
        print("set-up, seconds from process start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks), file=sys.stderr)
        print(f"reference: {ref_s:.3f} s, peak {ref_peak} B on the "
              f"fullest card; window: {attempted} matrices of "
              + ", ".join(f"{w:.4f}" for w in record["window_walls"])
              + " s", file=sys.stderr)
        if cuda and record["card"].get("power_limit_w") is not None:
            print(f"card: {record['card']['name']}, power limit "
                  f"{record['card']['power_limit_w']} W", file=sys.stderr)
        result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                            for k in LIMITS}
        for k in LIMITS:
            print(f"check {k}: {checks[k]} (limit {LIMITS[k]})",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), file=out, flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s), found {have}", file=sys.stderr)
        return 2
    return run(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
