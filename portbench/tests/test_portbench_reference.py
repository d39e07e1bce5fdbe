"""The plain reference against the port's CPU route, count for count and
byte for byte, and the control's readings at a test size."""

import contextlib
import io

import numpy as np
import pytest
import torch
from portbench_tiny import TINY, make_tiny_root  # (the root on the path)

from portbench import family
from portbench.reference import andi

FAMILIES = [
    # (genomes, length, rates, seed, segment): segments of 16-4096 sites
    # make the reference splice its segment walks many times
    (4, 20_000, [0.005, 0.05, 0.12], 1, 64),
    (5, 30_000, [0.02, 0.2, 0.3, 0.0], 2, 128),  # g4 == g0, a pair at 0.5
    (4, 50_000, [0.005, 0.01, 0.12], 3, 4096),
    (3, 5_000, [0.3, 0.25], 4, 16),
    (4, 20_000, [0.0, 0.0005, 0.002], 5, 64),  # near-clonal, g1 == g0
]


def port_grid(seqs):
    from andix_torch import pipeline
    from andix_torch.runtime import Context, Model
    from andix_torch.sequence import Seq

    ctx = Context()
    ctx.model = Model.JC
    grid = pipeline.calculate_matrix([Seq(d, n) for n, d in seqs], ctx,
                                     [torch.device("cpu")])
    n = len(seqs)
    counts = np.array([[grid[i][j].counts for j in range(n)]
                       for i in range(n)])
    seq_len = np.array([[grid[i][j].seq_len for j in range(n)]
                        for i in range(n)])
    return counts, seq_len


@pytest.mark.parametrize("n,length,rates,seed,segment", FAMILIES)
def test_reference_counts_are_the_ports(n, length, rates, seed, segment):
    seqs = family.make_family(n, length, rates, seed)
    ref = andi.Reference([d for _, d in seqs], 0.025, "cpu", segment)
    counts, seq_len = ref.counts()
    want_counts, want_len = port_grid(seqs)
    assert np.array_equal(counts, want_counts)
    assert np.array_equal(seq_len, want_len)


@pytest.mark.parametrize("family_index", [1, 4])
def test_reference_counts_do_not_depend_on_the_block(family_index):
    """A block of one subject and all subjects in one block give the same
    counts, on both strands and on the forward strand alone."""
    n, length, rates, seed, segment = FAMILIES[family_index]
    genomes = [d for _, d in family.make_family(n, length, rates, seed)]
    one = andi.Reference(genomes, 0.025, "cpu", segment, block=1)
    every = andi.Reference(genomes, 0.025, "cpu", segment, block=n)
    assert one.block == 1 and every.block == n
    for forward_only in (False, True):
        c1, l1 = one.counts(forward_only)
        cn, ln = every.counts(forward_only)
        assert np.array_equal(c1, cn) and np.array_equal(l1, ln)


def test_reference_phylip_is_the_cli_output(tmp_path):
    from andix_torch import cli

    seqs = family.make_family(5, 30_000, [0.005, 0.03, 0.12], 9)
    paths = family.write_fasta(str(tmp_path), seqs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(["--backend", "cpu", "--progress=never", "-m", "JC"]
                        + paths)
    ref = andi.Reference([d for _, d in seqs], 0.025, "cpu", 256)
    text, want_code = andi.phylip([n for n, _ in seqs], *ref.counts())
    assert buf.getvalue() == text
    assert code == want_code == 0


# the outbreak mix's SNPs need more genomes and sites than TINY holds
CONTROL_SIZES = {"bact8x5m.outbreak": {"genomes": 8, "length": 50_000}}


@pytest.mark.parametrize("cell", ["bact8x5m.divergent",
                                  "bact10x5m.divergent",
                                  "bact8x5m.outbreak"])
def test_control_is_not_correct(tmp_path, cell):
    """The control, the reference's estimate in float32, fails
    ``distance_gap`` at each cell's test size, on three seeds, with its
    counts exact; the forward strand alone and half the pairs fail the
    counts."""
    from portbench import control, run

    root = make_tiny_root(str(tmp_path), CONTROL_SIZES.get(cell, TINY))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = control.readings(cell, seed, "cpu", root=root)
        assert r["float32"]["distance_gap"] > run.LIMITS["distance_gap"], r
        assert r["float32"]["count_cells_off"] == 0, r
        assert r["forward_strand"]["count_cells_off"] > 0, r
        assert r["half_pairs"]["count_cells_off"] > 0, r


def test_distances_are_the_ports_unrounded():
    """The reference's float64 distances are those the port estimates,
    to the last bit; in float32 they are not."""
    from andix_torch import model
    from andix_torch.runtime import Model

    seqs = family.make_family(4, 20_000, [0.005, 0.05, 0.12], 5)
    counts, seq_len = port_grid(seqs)
    dist = andi.distances(counts)
    for i in range(4):
        for j in range(4):
            if i != j:
                m = model.model_average(
                    model.CountMatrix(counts[i, j], seq_len[i, j]),
                    model.CountMatrix(counts[j, i], seq_len[j, i]))
                assert model.estimate(m, Model.JC) == dist[i, j]
    assert (andi.distances(counts, np.float32) != dist).any()
