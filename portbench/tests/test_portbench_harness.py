"""The harness as data: cells, configurations, mixes and metrics found by
name in files of their own; a whole run on the CPU; and the faults it
must not pass."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench_tiny import (CELL, ROOT, card, make_tiny_root,  # noqa: F401
                            run_cell, tiny_root)

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def test_benchmark_json_keeps_the_contract():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for cfg in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, cfg["file"]))
        assert json.load(open(os.path.join(ROOT, cfg["file"])))["name"] \
            == cfg["name"]
    for cell in bench["workloads"]:
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", cell["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_a_new_config_mix_and_metric_are_files(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as new files and entries; no file of the harness is edited."""
    root = make_tiny_root(str(tmp_path))
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "bact8x5m.json")))
    cfg.update(name="bact3x10k", genomes=3, length=10_000)
    json.dump(cfg, open(os.path.join(pb, "configs", "bact3x10k.json"), "w"))
    json.dump({"name": "outbreak", "rates": [0.0, 0.0002, 0.002]},
              open(os.path.join(pb, "traffic", "outbreak.json"), "w"))
    with open(os.path.join(pb, "metrics", "pairs_done.py"), "w") as f:
        f.write("def read(record):\n"
                "    n = record['config']['genomes']\n"
                "    return n * (n - 1) * len(record['phase_matrices'])\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "bact3x10k", "source": "test",
                             "file": "portbench/configs/bact3x10k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "bact3x10k.outbreak",
                               "config": "bact3x10k", "traffic": "outbreak",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "pairs_done", "unit": "pairs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "matrix_s",
                               "workloads": ["bact3x10k.outbreak"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    result, _ = run_cell(root, "bact3x10k.outbreak", seconds=0.5,
                         trace_on=True)
    assert result["correct"] is True
    assert result["metrics"]["pairs_done"]["value"] >= 6
    assert "flag_scan_roofline" not in result["metrics"]


def test_a_whole_run_on_the_cpu(tiny_root):
    result, err = run_cell(tiny_root)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"matrix_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def _grid_faults():
    """Each fault, planted in the grid the port computes."""
    from andix_torch.model import CountMatrix

    def unchanged(grid):  # the grid as it starts: no pair computed
        n = len(grid)
        for i in range(n):
            for j in range(n):
                if i != j:
                    grid[i][j] = CountMatrix.zero(grid[i][j].seq_len)

    def half(grid):  # half the pairs left out, the other half stands in
        n = len(grid)
        for i in range(n):
            for j in range(i):
                grid[i][j] = grid[j][i].copy()

    def altered(grid):  # one pair's answer altered where it is made
        grid[0][1].counts[0] -= 1
        grid[0][1].counts[1] += 1

    return {"unchanged": unchanged, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, fault):
    from andix_torch import pipeline

    plant = _grid_faults()[fault]
    real = pipeline.calculate_matrix

    def broken(*args, **kwargs):
        grid = real(*args, **kwargs)
        plant(grid)
        return grid

    monkeypatch.setattr(pipeline, "calculate_matrix", broken)
    result, _ = run_cell(tiny_root)
    assert result["correct"] is False
    assert result["checks"]["count_cells_off"]["value"] > 0


def test_a_float32_estimate_is_not_correct(tiny_root, monkeypatch):
    """The port's estimate rounded to float32, as a program computing it
    in the precision below the stated float64 would: the counts and the
    printed lines may all agree, and ``distance_gap`` still fails."""
    from andix_torch import model

    real = model.estimate
    monkeypatch.setattr(model, "estimate",
                        lambda m, kind: float(np.float32(real(m, kind))))
    result, _ = run_cell(tiny_root)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["distance_gap"]["value"] > checks["distance_gap"]["limit"]
    assert checks["count_cells_off"]["value"] == 0


def test_run_and_readers_load_no_jax(tiny_root):
    """A whole run leaves no module whose top-level name is jax, jaxlib,
    flax or andix (andix_torch is another name); the harness checks this
    itself before it prints a result."""
    code = (
        "import sys, json, io, contextlib\n"
        f"sys.path.insert(0, {tiny_root!r})\n"
        "from portbench import run\n"
        "err = io.StringIO()\n"
        "with contextlib.redirect_stderr(err):\n"
        f"    run.run({CELL!r}, 5, 0.1, True, root={tiny_root!r},"
        " backend='cpu')\n"
        "bench = json.load(open(run.os.path.join(run.ROOT,"
        " 'BENCHMARK.json')))\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    run.load_metric(run.ROOT, m['name'])\n"
        "tops = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(tops)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert "andix_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "andix"}


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import portbench.reference.andi\n"
            "print(json.dumps(sorted({m.split('.', 1)[0]"
            " for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"andix_torch", "andix", "jax", "jaxlib", "flax"}


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    a run fails and prints no result."""
    root = make_tiny_root(str(tmp_path))
    os.unlink(os.path.join(root, "andix_torch"))
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "from portbench import run\n"
            f"sys.exit(run.run({CELL!r}, 1, 0.1, False, root={root!r},"
            " backend='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(card, name):
    """On a card: each cell for two seconds, correct, with its schedule;
    a cell that asks for more cards than the machine has is skipped."""
    import torch

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    if cell["chips"] > torch.cuda.device_count():
        pytest.skip(f"{name} needs {cell['chips']} CUDA cards, the machine "
                    f"has {torch.cuda.device_count()}")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell["name"],
         "--seed", str(2**31 + 17), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["matrix_s"]["value"])


@pytest.mark.parametrize("schedule,flat,sx,ok", [
    ("joint", 3, 0, True), ("joint", 0, 0, False), ("joint", 3, 1, False),
    ("subject", 0, 6, True), ("subject", 0, 0, False),
    ("subject", 1, 6, False)])
def test_a_matrix_off_its_schedule_fails(schedule, flat, sx, ok):
    """The joint cell must launch chain_walk_flat and never
    chain_walk_flat_sx, the subject cell the mirror; each matrix that
    does not counts in ``schedule_off``."""
    from portbench import run

    launches = {"chain_walk_flat": flat, "chain_walk_flat_sx": sx}
    assert run.schedule_ok(schedule, launches, cuda=True) is ok
