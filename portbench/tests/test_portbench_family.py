"""The traffic generator: the same family for a seed, each genome at its
rate."""

import json
import os

import numpy as np
import pytest
from portbench_tiny import DRAFT, ROOT

from portbench import family

RATES = json.load(open(os.path.join(
    ROOT, "portbench", "traffic", "divergent.json")))["rates"]


def test_same_seed_same_family_other_seed_other():
    a = family.make_family(9, 50_000, RATES, 2**31 + 5)
    b = family.make_family(9, 50_000, RATES, 2**31 + 5)
    c = family.make_family(9, 50_000, RATES, 2**31 + 6)
    assert [n for n, _ in a] == [f"g{k}" for k in range(9)]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not np.array_equal(a[0][1], c[0][1])
    assert all(len(d) == 50_000 and set(d.tobytes()) <= set(b"ACGT")
               for _, d in a)


def test_mutation_share_matches_each_rate():
    length = 400_000
    fam = family.make_family(10, length, RATES, 77)
    g0 = fam[0][1]
    for k in range(1, 10):
        rate = RATES[(k - 1) % len(RATES)]
        share = np.count_nonzero(fam[k][1] != g0) / length
        sigma = (rate * (1 - rate) / length) ** 0.5
        assert abs(share - rate) < 5 * sigma, (k, share, rate)


@pytest.mark.parametrize("length", [1000, 980, 1, 69, 70, 71])
def test_fasta_round_trip(tmp_path, length):
    """Each genome's file holds its name and its bases in lines of 70."""
    fam = family.make_family(3, length, RATES, 1)
    paths = family.write_fasta(str(tmp_path), fam)
    for (name, data), path in zip(fam, paths):
        text = open(path, "rb").read()
        assert text.endswith(b"\n")
        head, *lines = text[:-1].split(b"\n")
        assert head == b">" + name.encode()
        assert all(len(line) == 70 for line in lines[:-1])
        assert 1 <= len(lines[-1]) <= 70
        assert b"".join(lines) == data.tobytes()


def read_records(path):
    """(name, bases, line lengths) of each record of a FASTA file."""
    out = []
    for chunk in open(path, "rb").read().split(b">")[1:]:
        head, *lines = chunk.rstrip(b"\n").split(b"\n")
        out.append((head.decode(), b"".join(lines),
                    [len(line) for line in lines]))
    return out


@pytest.mark.parametrize("length,assembly", [
    (100_000, DRAFT),
    (20_000, dict(DRAFT, contigs=40)),  # no slack: every contig 500 bp
    (20_000, dict(DRAFT, contigs=1)),
    (30_011, dict(DRAFT, contigs=7, min_contig=71, reverse_share=1.0)),
])
def test_assembly_records_put_back_give_the_genome(tmp_path, length,
                                                   assembly):
    """Each genome's file holds ``contigs`` records named after it, each
    at least ``min_contig`` long, longest first, in lines of 70; each
    record, un-reversed where its layout says so and set at its
    breakpoint, gives the genome back, every base once."""
    fam = family.make_family(3, length, RATES, 2**31 + 11)
    paths = family.write_assembly(str(tmp_path), fam, assembly, 2**31 + 11)
    for index, ((name, data), path) in enumerate(zip(fam, paths)):
        assert os.path.basename(path) == f"{name}.fa"
        records = read_records(path)
        layout = family.assembly_layout(length, assembly, 2**31 + 11, index)
        assert [r[0] for r in records] == [
            f"{name}_c{c}" for c in range(assembly["contigs"])]
        sizes = [len(bases) for _, bases, _ in records]
        assert min(sizes) >= assembly["min_contig"]
        assert sizes == sorted(sizes, reverse=True)
        assert all(max(w) <= 70 and all(x == 70 for x in w[:-1])
                   for _, _, w in records)
        rebuilt = np.zeros(length, dtype=np.uint8)
        covered = np.zeros(length, dtype=np.int64)
        for (_, bases, _), (start, end, flip) in zip(records, layout):
            part = np.frombuffer(bases, dtype=np.uint8)
            if flip:
                part = family.COMPLEMENT[part[::-1]]
            rebuilt[start:end] = part
            covered[start:end] += 1
        assert (covered == 1).all()
        assert np.array_equal(rebuilt, data)


@pytest.mark.parametrize("share", [0.0, 0.3, 0.5, 1.0])
def test_assembly_reverses_near_its_share(share):
    assembly = dict(DRAFT, reverse_share=share)
    flips = [flip for index in range(10) for _, _, flip in
             family.assembly_layout(5_000_000, assembly, 2**31 + 3, index)]
    sigma = (share * (1 - share) / len(flips)) ** 0.5
    assert abs(np.mean(flips) - share) <= 5 * sigma


def test_assembly_layout_follows_seed_and_genome():
    """The same seed and genome give the same layout; another seed or
    another genome another."""
    def layout(seed, index):
        return family.assembly_layout(5_000_000, DRAFT, seed, index)

    assert layout(2**31 + 5, 0) == layout(2**31 + 5, 0)
    assert layout(2**31 + 5, 0) != layout(2**31 + 6, 0)
    assert layout(2**31 + 5, 0) != layout(2**31 + 5, 1)


def test_assembly_that_does_not_fit_is_refused(tmp_path):
    fam = family.make_family(2, 20_000, RATES, 1)
    with pytest.raises(ValueError, match="41 contigs of at least 500 bp "
                                         "do not fit a genome of 20000 bp"):
        family.write_assembly(str(tmp_path), fam, dict(DRAFT, contigs=41), 1)
