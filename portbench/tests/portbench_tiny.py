"""Helpers and fixtures of the benchmark's CPU tests: a checkout cut to
test size, and the look for a card.  Each test module imports this first:
it puts the repository's root on the path."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every configuration at a size the CPU runs in seconds
TINY = {"genomes": 4, "length": 20000}
CELL = "bact8x5m.divergent"
# a draft assembly as SPAdes writes one for a 5 Mbp bacterial genome
DRAFT = {"contigs": 150, "min_contig": 500, "reverse_share": 0.5,
         "order": "longest_first"}


def cut_config(cfg: dict, size: dict = TINY) -> dict:
    """``cfg`` at ``size``; a draft assembly keeps as many contigs as the
    cut length holds at its least contig length."""
    cfg.update(size)
    if "assembly" in cfg:
        asm = cfg["assembly"]
        cfg["assembly"] = dict(asm, contigs=min(
            asm["contigs"], cfg["length"] // asm["min_contig"]))
    return cfg


def make_tiny_root(path: str, size: dict = TINY) -> str:
    """BENCHMARK.json and portbench/ copied to ``path`` with each
    configuration cut to ``size`` (``cut_config``), beside a link to the
    port."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "andix_torch"),
               os.path.join(path, "andix_torch"))
    bench = json.load(open(os.path.join(path, "BENCHMARK.json")))
    for entry in bench["configs"]:
        cfg_path = os.path.join(path, entry["file"])
        cfg = json.load(open(cfg_path))
        json.dump(cut_config(cfg, size), open(cfg_path, "w"))
    return path


def run_cell(root, cell=CELL, seed=2**31 + 3, seconds=0.1, trace_on=False):
    """The run after its look for a card, on the CPU; returns the result
    line as a dict (stdout) and the run's standard error."""
    sys.path.insert(0, root)
    try:
        from portbench import run
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = run.run(cell, seed, seconds, trace_on, root=root,
                         backend="cpu", out=out)
    finally:
        sys.path.remove(root)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
