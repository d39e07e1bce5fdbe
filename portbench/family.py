"""The synthetic genome families a traffic mix describes.

A frozen copy of the generator the repository has used since its first
benchmark (``bench.make_family``): g0 is uniform random over ACGT; g_k, k
>= 1, is g0 with each site substituted, with probability
``rates[(k - 1) % len(rates)]``, by one of the three other bases.  Every
seed gives the same sizes; the seed changes the sequences only.
"""

from __future__ import annotations

import os

import numpy as np

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
WIDTH = 70  # bases a FASTA line, as genome files are wrapped


def make_family(n_genomes: int, length: int, rates: list[float],
                seed: int) -> list[tuple[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    seqs = [("g0", base)]
    codes = np.searchsorted(NUCL, base)
    for k in range(1, n_genomes):
        rate = rates[(k - 1) % len(rates)]
        hit = rng.random(length) < rate
        seqs.append((f"g{k}", NUCL[(codes + np.where(
            hit, rng.integers(1, 4, length), 0)) % 4]))
    return seqs


def write_fasta(directory: str, seqs) -> list[str]:
    """One file a genome, its name the record's name, the sequence in
    lines of ``WIDTH`` bases."""
    paths = []
    for name, data in seqs:
        full = len(data) // WIDTH * WIDTH
        rows = data[:full].reshape(-1, WIDTH)
        body = np.concatenate(
            [rows, np.full((len(rows), 1), ord("\n"), np.uint8)], axis=1)
        tail = data[full:].tobytes() + b"\n" if full < len(data) else b""
        path = os.path.join(directory, f"{name}.fa")
        with open(path, "wb") as f:
            f.write(b">" + name.encode() + b"\n" + body.tobytes() + tail)
        paths.append(path)
    return paths
