"""The port's CLI on draft assemblies under ``-j``, and on genomes past the
species line, held to the benchmark's plain reference
(``portbench/reference/andi.py``) on both schedules, on the CPU.

Each family is 4 genomes of 20-40 kbp from the benchmark's generator
(``portbench.family``); a draft is written by ``family.write_assembly``
(contigs of at least 300 bp, longest first, some reverse-complemented,
one file a genome) and read by the reference as andi's join mode reads it
(``andi.read_join``).  Compared: every ordered pair's 16 counts and
sequence length, the unrounded distances (the benchmark's
``distance_gap`` and its limit), the PHYLIP text and the exit code; the
drafts also with the card's read path (its plain version), which joins
each file on the ingest's RS pass."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

import torch

from andix_torch import cli, ingest, model, pipeline, subject_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import family, run  # noqa: E402
from portbench.reference import andi  # noqa: E402

DIVERGENT = [0.002, 0.004, 0.007, 0.01, 0.015, 0.02, 0.025]
# genomes past the species line, up to andi's tested accuracy edge
HIGHDIV = [0.08, 0.095, 0.11, 0.125, 0.14, 0.155, 0.17]

# (length, rates, contigs a genome (None: one record, no -j), the share
# of contigs reversed, whether g1 takes g0's breakpoints and strands)
FAMILIES = {
    "unequal_contigs": (30_000, DIVERGENT, [3, 11, 26, 40], 0.5, False),
    "all_reversed": (24_000, DIVERGENT, [7, 7, 15, 19], 1.0, False),
    # g1 = g0 cut at the same places: '!' meets '!' in the joint text
    "joiner_meets_joiner": (20_000, [0.0, 0.001, 0.01], [12, 12, 12, 20],
                            0.5, True),
    "one_contig_file": (20_000, DIVERGENT, [1, 9, 1, 14], 0.5, False),
    "highdiv": (40_000, HIGHDIV, [None] * 4, 0.0, False),
}
SEED = 2**31 + 4099


def write_family(directory, key):
    """The family's names, its files, and whether it runs under ``-j``."""
    length, rates, contigs, share, same = FAMILIES[key]
    seqs = family.make_family(len(contigs), length, rates, SEED)
    if contigs[0] is None:
        return seqs, family.write_fasta(directory, seqs), False
    paths = []
    for k, (seq, c) in enumerate(zip(seqs, contigs)):
        asm = {"contigs": c, "min_contig": 300, "reverse_share": share,
               "order": "longest_first"}
        paths += family.write_assembly(directory, [seq], asm,
                                       SEED if same and k == 1 else SEED + k)
    return seqs, paths, True


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Each family's files, options and the reference's counts, sequence
    lengths, float64 distances, PHYLIP text and exit code."""
    out = {}
    for key in FAMILIES:
        seqs, paths, join = write_family(
            str(tmp_path_factory.mktemp(key)), key)
        config = {"join": join}
        names, genomes = run.reference_input(config, seqs, paths)
        counts, seq_len = andi.Reference(genomes, 0.025, "cpu").counts()
        text, code = andi.phylip(names, counts, seq_len)
        out[key] = (paths, ["-m", "JC"] + (["-j"] if join else []),
                    genomes, counts, seq_len, andi.distances(counts), text,
                    code)
    return out


def port_matrix(paths, options, monkeypatch):
    """The CLI's exit code, stdout, counts, sequence lengths and unrounded
    distances, and whether the subject index ran."""
    grids, estimates, indexed = [], [], []
    calc, estimate = pipeline.calculate_matrix, model.estimate
    index = subject_pipeline.process_subject_index
    monkeypatch.setattr(pipeline, "calculate_matrix",
                        lambda *a, **k: grids.append(calc(*a, **k))
                        or grids[-1])
    monkeypatch.setattr(model, "estimate",
                        lambda *a, **k: estimates.append(estimate(*a, **k))
                        or estimates[-1])
    monkeypatch.setattr(subject_pipeline, "process_subject_index",
                        lambda *a, **k: indexed.append(1) or index(*a, **k))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        code = cli.main(["--backend", "cpu", "--progress=never", *options,
                         *paths])
    n = len(paths)
    (grid,) = grids
    counts = np.array([[grid[i][j].counts for j in range(n)]
                       for i in range(n)])
    seq_len = np.array([[grid[i][j].seq_len for j in range(n)]
                        for i in range(n)])
    dist = np.full((n, n), np.nan)
    if len(estimates) == n * (n - 1):
        np.fill_diagonal(dist, 0.0)
        dist[~np.eye(n, dtype=bool)] = estimates
    return code, buf.getvalue(), counts, seq_len, dist, bool(indexed)


@pytest.mark.parametrize("schedule", ["joint", "subject"])
@pytest.mark.parametrize("key", list(FAMILIES))
def test_port_equals_the_reference(families, key, schedule, monkeypatch):
    """The port's matrix on the schedule ``ANDIX_INDEX`` picks is the
    reference's: counts, lengths, distances within ``distance_gap``'s
    limit, PHYLIP text and exit code."""
    paths, options, genomes, counts, seq_len, dist, text, code = \
        families[key]
    contigs = FAMILIES[key][2]
    if "-j" in options:
        joiners = [int(np.count_nonzero(g == ord("!"))) for g in genomes]
        assert joiners == [c - 1 for c in contigs]
    monkeypatch.setenv("ANDIX_INDEX", schedule)
    got_code, out, got_counts, got_len, got_dist, indexed = port_matrix(
        paths, options, monkeypatch)
    assert indexed == (schedule == "subject")
    assert np.array_equal(got_counts, counts)
    assert np.array_equal(got_len, seq_len)
    assert run.distance_gap(got_dist, dist) <= run.LIMITS["distance_gap"]
    assert (got_code, out) == (code, text)


@pytest.mark.parametrize("schedule", ["joint", "subject"])
@pytest.mark.parametrize("key", [k for k, f in FAMILIES.items()
                                 if f[2][0] is not None])
def test_port_with_the_card_read_equals_the_reference(families, key,
                                                      schedule, monkeypatch):
    """``test_port_equals_the_reference`` on the drafts with the files read
    on the card's route (``ingest.card`` on the CPU: the plain version
    joins each file's records); every file is taken there."""
    taken, read = [], ingest.read_records
    monkeypatch.setattr(ingest, "card", lambda ctx: torch.device("cpu"))
    monkeypatch.setattr(ingest, "read_records",
                        lambda *a: taken.append(read(*a)) or taken[-1])
    test_port_equals_the_reference(families, key, schedule, monkeypatch)
    (got,) = taken
    assert sorted(got) == list(range(len(families[key][0])))
    assert all(len(recs) == 1 for recs in got.values())
