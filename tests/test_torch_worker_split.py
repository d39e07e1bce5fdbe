"""The subject schedule's plan over several workers, on the CPU: a plan
with fewer groups than workers is split into one group a worker
(``subject_pipeline.plan_worker_groups``), as eco29's 29 subjects over
four cards, and the segment count counts every worker's lanes; an
eco29-shaped family on four CPU workers against one
worker, ``andix``'s grid and the benchmark's plain reference; and the
plan's span and the workers' CPU time under ``ANDIX_PROF_FILE``."""

import collections
import contextlib
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from andix import pipeline as jpipeline
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context as JContext
from andix.sequence import Seq as JSeq
from andix_torch import cli, parallel, pipeline, spans, subject_pipeline
from andix_torch.esa.backend import bucket
from andix_torch.runtime import Context, Model
from andix_torch.sequence import Seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import family  # noqa: E402
from portbench.reference import andi  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
CACHE_K = 1


def _subjects(lengths):
    """Stand-ins with the one field the plan reads, ``len``."""
    return [types.SimpleNamespace(len=n) for n in lengths]


def _plan(subjects, workers, budget=1 << 40, low_memory=False):
    return subject_pipeline.plan_worker_groups(
        subjects, list(range(len(subjects))), low_memory, CACHE_K, budget,
        0, workers)


def _need(count, lp):
    """``plan_groups``' bytes for ``count`` subjects at padded length
    ``lp``."""
    cache = ((1 << (2 * CACHE_K)) + 1) * 4
    return (-(-count // 8) * 8 * (lp * subject_pipeline.IDX_BYTES_PER_SYM
                                  + cache)
            + lp * subject_pipeline.BUILD_BYTES_PER_PADDED_SYM + 4 * cache)


def test_eco29_on_four_workers_is_8_7_7_7(monkeypatch):
    """29 subjects under the default cap of 16 plan as 16 + 13; on four
    workers they are dealt in plan order into 8, 7, 7 and 7."""
    monkeypatch.delenv("ANDIX_GROUP_SUBJECTS", raising=False)
    subjects = _subjects([5_000_000] * 29)
    assert subject_pipeline.plan_groups(
        subjects, list(range(29)), False, CACHE_K, 1 << 40, 0) == [
            list(range(16)), list(range(16, 29))]
    groups, split = _plan(subjects, 4)
    assert split
    assert [len(g) for g in groups] == [8, 7, 7, 7]
    assert [i for g in groups for i in g] == list(range(29))


@pytest.mark.parametrize("n, cap, workers", [
    (29, 16, 4), (5, 0, 2), (5, 0, 3), (10, 16, 4), (17, 16, 4),
    (33, 16, 8), (7, 3, 4), (2, 0, 4), (1, 0, 4), (3, 0, 3)])
def test_a_split_plan_is_even_and_in_order(monkeypatch, n, cap, workers):
    """Fewer groups than workers: ``min(workers, n)`` groups, none empty,
    sizes that differ by at most one, every subject once in plan order,
    none larger than the cap."""
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", str(cap))
    subjects = _subjects([1000] * n)
    planned = subject_pipeline.plan_groups(subjects, list(range(n)), False,
                                           CACHE_K, 1 << 40, 0)
    assert len(planned) < workers
    groups, split = _plan(subjects, workers)
    sizes = [len(g) for g in groups]
    assert len(groups) == min(workers, n) and min(sizes) >= 1
    assert max(sizes) - min(sizes) <= 1
    assert [i for g in groups for i in g] == list(range(n))
    assert not cap or max(sizes) <= cap
    assert split == (len(groups) > len(planned))


@pytest.mark.parametrize("n, cap, workers", [
    (29, 16, 2), (29, 16, 1), (5, 1, 4), (5, 2, 3), (8, 4, 2), (9, 1, 9)])
def test_a_plan_with_enough_groups_is_kept(monkeypatch, n, cap, workers):
    """At least as many groups as workers: the plan comes back as it
    is."""
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", str(cap))
    subjects = _subjects([1000] * n)
    planned = subject_pipeline.plan_groups(subjects, list(range(n)), False,
                                           CACHE_K, 1 << 40, 0)
    assert len(planned) >= workers
    assert _plan(subjects, workers) == (planned, False)


def test_low_memory_and_single_subjects_are_not_split(monkeypatch):
    """One subject a group already (low memory, or a plan of single
    subjects): nothing to split, and no group is empty."""
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "1")
    subjects = _subjects([1000] * 3)
    assert _plan(subjects, 4) == ([[0], [1], [2]], False)
    monkeypatch.delenv("ANDIX_GROUP_SUBJECTS")
    assert _plan(subjects, 4, low_memory=True) == ([[0], [1], [2]], False)


def test_the_memory_budget_still_splits_further(monkeypatch):
    """Eight long subjects fill the budget, 24 short ones fit beside each
    other: planned as 8 + 24.  Dealt to three workers the first group
    would take three short subjects beside the eight long ones, over the
    budget; planned again it splits, so four groups, each in budget."""
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "0")
    subjects = _subjects([40_000] * 8 + [10_000] * 24)
    lp_long = subject_pipeline.index_length(subjects[0])
    lp_short = subject_pipeline.index_length(subjects[8])
    assert lp_long == bucket(40_001) and lp_short < lp_long
    budget = _need(8, lp_long)
    assert _need(24, lp_short) <= budget < _need(16, lp_long)
    todo = list(range(32))
    assert subject_pipeline.plan_groups(subjects, todo, False, CACHE_K,
                                        budget, 0) == [todo[:8], todo[8:]]
    groups, split = _plan(subjects, 3, budget)
    assert split
    assert groups == [todo[:8], todo[8:11], todo[11:22], todo[22:]]
    for g in groups:
        assert subject_pipeline.plan_groups(subjects, g, False, CACHE_K,
                                            budget, 0) == [g]


@pytest.mark.parametrize("queries, group, workers, want", [
    (28, 16, 1, 16), (28, 13, 1, 16), (28, 16, 2, 8), (28, 8, 4, 8),
    (28, 7, 4, 8), (28, 8, 1, 32), (9, 10, 1, 64)])
def test_segments_count_every_workers_lanes(monkeypatch, queries, group,
                                            workers, want):
    """At 5 Mbp the segment count fills the lanes of all workers toward
    the lane target: eco29's 16 + 13 on one worker take 16 segments, its
    8, 7, 7, 7 over four workers 8, where one worker's 8 alone would take
    32; bact10x5m's one group of 10 on one worker keeps its 64."""
    monkeypatch.delenv("ANDIX_CHAIN_SEGMENTS", raising=False)
    assert subject_pipeline._chain_segments(
        5_000_000, group * queries * workers) == want


# --- an eco29-shaped family on four workers -------------------------------

def _eco29_family():
    """9 genomes x 3 kbp at the benchmark's ``divergent`` rates."""
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "divergent.json")) as f:
        rates = json.load(f)["rates"]
    return family.make_family(9, 3000, rates, seed=2**31 + 29)


@pytest.fixture(scope="module")
def eco29_small():
    """(family, andix's subject grid, the reference's counts, lengths and
    PHYLIP text)."""
    fam = _eco29_family()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANDIX_INDEX", "subject")
        grid = jpipeline.calculate_matrix([JSeq(d, nm) for nm, d in fam],
                                          JContext(), JaxBackend())
    jcounts = np.array([[grid[i][j].counts for j in range(9)]
                        for i in range(9)])
    ref = andi.Reference([d for _, d in fam], 0.025, "cpu")
    counts, seq_len = ref.counts()
    text, _ = andi.phylip([nm for nm, _ in fam], counts, seq_len)
    return fam, jcounts, counts, seq_len, text


def _grid(fam, devices):
    ctx = Context()
    ctx.model = Model.JC
    grid = pipeline.calculate_matrix([Seq(d, nm) for nm, d in fam], ctx,
                                     devices)
    n = len(fam)
    return (np.array([[grid[i][j].counts for j in range(n)]
                      for i in range(n)]),
            np.array([[grid[i][j].seq_len for j in range(n)]
                      for i in range(n)]))


def _cli_text(paths, workers, monkeypatch):
    monkeypatch.setattr(cli, "resolve_devices", lambda backend: [CPU]
                        * workers)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = cli.main(["--backend", "cpu", "--progress=never", "-m",
                         "JC"] + paths)
    assert code == 0
    return out.getvalue()


def test_eco29_shaped_family_on_four_workers(eco29_small, monkeypatch,
                                             tmp_path):
    """Nine subjects in one planned group, four CPU workers: one group on
    each worker, and the counts, lengths and printed matrix of one worker,
    of ``andix`` and of the plain reference."""
    fam, jcounts, ref_counts, ref_len, ref_text = eco29_small
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.delenv("ANDIX_GROUP_SUBJECTS", raising=False)
    lanes = []
    rule = subject_pipeline._chain_segments
    monkeypatch.setattr(subject_pipeline, "_chain_segments",
                        lambda qlen, base: lanes.append(base)
                        or rule(qlen, base))
    one_counts, one_len = _grid(fam, [CPU])
    assert subject_pipeline.LAST_BALANCE[0].startswith(
        "worker 0 on cpu group[0..8]")
    assert lanes == [9 * 8]
    four_counts, four_len = _grid(fam, [CPU] * 4)
    # each group's lanes times the four workers
    assert sorted(lanes[1:]) == [2 * 8 * 4] * 3 + [3 * 8 * 4]
    lines = subject_pipeline.LAST_BALANCE
    groups = [ln for ln in lines if " group[" in ln]
    assert sorted(ln.split(" group")[0] for ln in groups) == [
        f"worker {w} on cpu" for w in range(4)]
    assert sorted(ln.split("group")[1].split(":")[0] for ln in groups) == [
        "[0..2]", "[3..4]", "[5..6]", "[7..8]"]
    assert sum(ln.split(":")[0].endswith(" on cpu") for ln in lines) == 4
    for counts, seq_len in ((four_counts, four_len), (jcounts, None),
                            (ref_counts, ref_len)):
        assert np.array_equal(counts, one_counts)
        assert seq_len is None or np.array_equal(seq_len, one_len)
    paths = family.write_fasta(str(tmp_path), fam)
    one_text = _cli_text(paths, 1, monkeypatch)
    four_text = _cli_text(paths, 4, monkeypatch)
    assert len([ln for ln in subject_pipeline.LAST_BALANCE
                if " group[" in ln]) == 4
    assert four_text == one_text == ref_text


# --- the plan's span and the workers' CPU time -----------------------------

def test_plan_span_and_worker_cpu_time(monkeypatch, tmp_path):
    """Under ``ANDIX_PROF_FILE`` the plan's span holds its groups,
    workers, largest group and split, and every ``worker`` span counts
    its thread's CPU nanoseconds, at most its wall; unset, no request is
    kept and no thread's CPU time is read."""
    fam = family.make_family(5, 1500, [0.01, 0.02], seed=7)
    paths = family.write_fasta(str(tmp_path), fam)
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "4")
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    _cli_text(paths, 3, monkeypatch)
    req = spans.REQUESTS[-1]
    plans = [s for s in req["spans"] if s["name"] == "sx.plan"]
    assert len(plans) == 1 and plans[0]["device"] is None
    assert plans[0]["attrs"] == {"groups": 3, "workers": 3,
                                 "largest_group": 2, "split": 1}
    workers = [s for s in req["spans"] if s["name"] == "worker"]
    assert len(workers) == 3
    for w in workers:
        assert 0 < w["counts"]["cpu_ns"] <= w["t1"] - w["t0"]
    walks = [s for s in req["spans"] if s["name"] == "sx.walk"]
    assert [s["attrs"]["segments"] for s in walks] == [1] * 3

    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "2")
    _cli_text(paths, 2, monkeypatch)
    plans = [s for s in spans.REQUESTS[-1]["spans"]
             if s["name"] == "sx.plan"]
    assert plans[0]["attrs"] == {"groups": 3, "workers": 2,
                                 "largest_group": 2, "split": 0}

    monkeypatch.delenv("ANDIX_PROF_FILE")
    kept = len(spans.REQUESTS)

    def refuse():
        raise AssertionError("the thread's CPU time read while tracing "
                             "is off")

    monkeypatch.setattr(parallel.time, "thread_time_ns", refuse)
    _cli_text(paths, 3, monkeypatch)
    assert len(spans.REQUESTS) == kept
