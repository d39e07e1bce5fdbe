"""The synthetic genome families a traffic mix describes.

A frozen copy of the generator the repository has used since its first
benchmark (``bench.make_family``): g0 is uniform random over ACGT; g_k, k
>= 1, is g0 with each site substituted, with probability
``rates[(k - 1) % len(rates)]``, by one of the three other bases.  Every
seed gives the same sizes; the seed changes the sequences only.

``write_assembly`` writes the same genomes as draft assemblies: each cut
into contigs at breakpoints drawn from a stream of its own, some contigs
reverse-complemented, all of one genome in one file.
"""

from __future__ import annotations

import os

import numpy as np

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
WIDTH = 70  # bases a FASTA line, as genome files are wrapped
COMPLEMENT = np.zeros(256, dtype=np.uint8)
COMPLEMENT[NUCL] = np.frombuffer(b"TGCA", dtype=np.uint8)
# the spawn key of each genome's layout stream: its draws never share a
# word with ``make_family``'s, which uses the bare seed
ASSEMBLY_STREAM = 0x6173


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


def assembly_layout(length: int, assembly: dict, seed: int,
                    index: int) -> list[tuple[int, int, bool]]:
    """The contigs of genome ``index`` in the order they are written:
    ``(start, end, reversed)``, longest first (ties in genome order).

    ``assembly["contigs"] - 1`` breakpoints are drawn uniformly among the
    layouts whose every contig holds at least ``assembly["min_contig"]``
    bases; each contig is reversed with probability
    ``assembly["reverse_share"]``.  The draws come from (``seed``,
    ``index``) alone."""
    contigs, least = assembly["contigs"], assembly["min_contig"]
    if assembly["order"] != "longest_first":
        raise ValueError(f"unknown contig order {assembly['order']!r}")
    if contigs < 1 or contigs * least > length:
        raise ValueError(f"{contigs} contigs of at least {least} bp do not "
                         f"fit a genome of {length} bp")
    rng = np.random.default_rng(np.random.SeedSequence(
        seed, spawn_key=(ASSEMBLY_STREAM, index)))
    slack = length - contigs * least
    cuts = (np.sort(rng.integers(0, slack + 1, contigs - 1))
            + least * np.arange(1, contigs))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [length]])
    flip = rng.random(contigs) < assembly["reverse_share"]
    order = np.argsort(starts - ends, kind="stable")
    return [(int(starts[k]), int(ends[k]), bool(flip[k])) for k in order]


def _record(name: str, data: np.ndarray) -> bytes:
    full = len(data) // WIDTH * WIDTH
    rows = data[:full].reshape(-1, WIDTH)
    body = np.concatenate(
        [rows, np.full((len(rows), 1), ord("\n"), np.uint8)], axis=1)
    tail = data[full:].tobytes() + b"\n" if full < len(data) else b""
    return b">" + name.encode() + b"\n" + body.tobytes() + tail


def write_assembly(directory: str, seqs, assembly: dict,
                   seed: int) -> list[str]:
    """One file a genome, ``<genome>.fa``, holding its contigs as
    ``assembly_layout`` gives them, each a record ``<genome>_c<i>`` in
    lines of ``WIDTH`` bases, a reversed one reverse-complemented.  Every
    base of the genome lies in exactly one contig."""
    paths = []
    for index, (name, data) in enumerate(seqs):
        records = []
        for c, (start, end, flip) in enumerate(
                assembly_layout(len(data), assembly, seed, index)):
            part = data[start:end]
            if flip:
                part = COMPLEMENT[part[::-1]]
            records.append(_record(f"{name}_c{c}", part))
        path = os.path.join(directory, f"{name}.fa")
        with open(path, "wb") as f:
            f.write(b"".join(records))
        paths.append(path)
    return paths
