"""The traffic generator: the same family for a seed, each genome at its
rate."""

import json
import os

import numpy as np
import pytest
from portbench_tiny import ROOT

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
