"""Helpers and fixtures of the benchmark's CPU tests: a checkout cut to
test size, and the look for a card.  Each test module imports this first:
it puts the repository's root on the path."""

from __future__ import annotations

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


def make_tiny_root(path: str, size: dict = TINY) -> str:
    """BENCHMARK.json and portbench/ copied to ``path`` with each
    configuration cut to ``size``, beside a link to the port."""
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
        cfg.update(size)
        json.dump(cfg, open(cfg_path, "w"))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
