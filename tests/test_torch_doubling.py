"""The doubling loop's two hand kernels (``csrc/doubling.cu``) through
their host twin (``doubling_cpu.cpp``, g++), the plain torch version and
``andix.esa.doubling``, exactly, on the same numpy-seeded texts.

One round at a time: ``_initial_ranks`` (width 1, the clamped base-4
key, the dense-code key at bases 5-12), ``_doubling_round``,
``_extract_tied`` and ``_bucketed_round``, from the same inputs.  The
sort is not stable, so a round's order inside a tied group may differ
between the routes: a round is compared by its ranks, its tied count,
the heads in SA order (``rank[sa]``), the ascending tied slots and the
heads of their suffixes.  Whole: ``sa_loop`` (SA, every level row below
the count, the count and the overflow flag, with the budget cut below
the need too) and ``sa_lcp_device``.  Texts: random DNA, mutated joint
families with separators, padded to the block bucket, a duplicated
genome and a clonal pair (many levels); n = 1, 2, 3, 17 and the twin's
tiles (64 tiny, 2048 the kernel's) +- 1, so the look-back folds across
tiles and the tail compaction crosses them.  Run alone:

    python -m pytest tests/test_torch_doubling.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix.esa import doubling as jdoubling
from andix_torch.esa import doubling, joint
from andix_torch.esa.backend import bucket, pad_symbols
from andix_torch.sequence import catcomp

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
TILES = (63, 64, 65, 2047, 2048, 2049)  # the twin's tiles (tiny, kernel)
ROUTES = ("twin", "twin_tiny")


def _route(name):
    return doubling.Kernels(twin=True, tiny=name == "twin_tiny")


def _dna(rng, n):
    return NUCL[rng.integers(0, 4, n)]


def _mutate(rng, seq, rate):
    codes = np.searchsorted(NUCL, seq)
    hit = rng.random(len(seq)) < rate
    return NUCL[(codes + np.where(hit, rng.integers(1, 4, len(seq)), 0)) % 4]


def _block(genomes):
    """A joint block text of the genomes (each with its reverse
    complement), padded to its bucket: (int32 text, segments)."""
    layout = joint.build_block({i: catcomp(g) for i, g in enumerate(genomes)},
                               {})
    return (pad_symbols(layout.sym, bucket(layout.n, 1024)),
            len(layout.genome_ids))


def _text(kind, n, seed):
    """(int32 text, packed, base) of one case."""
    rng = np.random.default_rng(seed)
    if kind == "dna":
        return _dna(rng, n).astype(np.int32), False, 1
    if kind == "dna_clamped":
        return pad_symbols(_dna(rng, n).astype(np.int32), n + 3), True, 4
    if kind.startswith("dna_wide"):
        base = int(kind[len("dna_wide"):])
        return pad_symbols(_dna(rng, n).astype(np.int32), n + 5), True, base
    g0 = _dna(rng, n)
    if kind == "family":
        sym, nseg = _block([g0, _mutate(rng, g0, 0.02),
                            _mutate(rng, g0, 0.1)])
    elif kind == "clonal":
        sym, nseg = _block([g0, g0.copy(), _mutate(rng, g0, 0.05)])
    elif kind == "duplicated":
        sym, nseg = _block([np.concatenate([g0, g0]), _mutate(rng, g0, 0.03)])
    else:
        raise ValueError(kind)
    return sym, True, doubling.wide_base_width(nseg, True)


def _andix_loop(sym, packed, L, base):
    n = len(sym)
    thr0 = int(n * jdoubling._BUCKET_FRAC)
    sa, levels, cnt, ovf = jdoubling._sa_core(
        jnp.asarray(sym), packed=packed, L=L, thr0=thr0,
        tiers=jdoubling._tail_tiers(n, thr0), base=base)
    return np.asarray(sa), np.asarray(levels), int(cnt), bool(ovf)


def _assert_loop_equal(got, ref, L):
    """got: (sa, rows, count, flag) of the port; ref: andix's."""
    sa, levels, cnt, ovf = got
    r_sa, r_lev, r_cnt, r_ovf = ref
    assert (cnt, ovf) == (r_cnt, r_ovf)
    rows = min(cnt, L)
    assert len(levels) == rows
    assert (sa.numpy() == r_sa).all()
    if rows:
        assert (torch.stack(levels).numpy() == r_lev[:rows]).all()


def _loop_routes(sym, packed, L, base):
    """sa_loop through the plain version and both twins."""
    t = torch.from_numpy(sym)
    out = {"plain": doubling.sa_loop(t, packed, L, base)}
    for name in ROUTES:
        out[name] = doubling.sa_loop_cpu_twin(t, packed, L, base,
                                              tiny=name == "twin_tiny")
    return out


@pytest.mark.parametrize("kind,n", [
    ("dna", 1), ("dna", 2), ("dna", 3), ("dna", 17),
    *[("dna", n) for n in TILES],
    ("dna_clamped", 17), *[("dna_clamped", n) for n in TILES],
    *[(f"dna_wide{b}", 2049) for b in range(5, 13)],
    ("dna_wide12", 1), ("dna_wide12", 2), ("dna_wide12", 3),
    ("dna_wide12", 65),
    ("family", 700), ("clonal", 600), ("duplicated", 500),
])
def test_sa_loop_equals_andix(kind, n):
    """The whole loop, every level it needs: twin == plain == andix."""
    sym, packed, base = _text(kind, n, 31 * n + len(kind))
    L = doubling.levels_needed(len(sym), packed, base)
    ref = _andix_loop(sym, packed, L, base)
    for name, got in _loop_routes(sym, packed, L, base).items():
        _assert_loop_equal(got, ref, L)
    if kind in ("clonal", "duplicated"):
        assert ref[2] >= 6  # long repeats: a random text this size needs 3


@pytest.mark.parametrize("kind,n,L", [
    ("clonal", 600, 3), ("duplicated", 500, 4), ("dna", 2049, 2),
    ("dna_clamped", 2048, 1), ("family", 700, 2),
])
def test_sa_loop_overflow_keeps_sa_exact(kind, n, L):
    """A level budget below the need: the flag rises in every route and
    the SA and the kept rows stay andix's."""
    sym, packed, base = _text(kind, n, 7 * n)
    assert L < doubling.levels_needed(len(sym), packed, base)
    ref = _andix_loop(sym, packed, L, base)
    assert ref[3]
    for got in _loop_routes(sym, packed, L, base).values():
        _assert_loop_equal(got, ref, L)


def _heads(rank, sa):
    return np.asarray(rank)[np.asarray(sa)]


@pytest.mark.parametrize("kind,n", [
    ("dna", 17), ("dna", 2049), ("dna_clamped", 2048), ("dna_wide5", 65),
    ("dna_wide9", 2047), ("dna_wide12", 2049), ("family", 700),
])
def test_initial_ranks_equal_andix(kind, n):
    sym, packed, base = _text(kind, n, n + 3)
    j_rank, j_tied, j_order = jdoubling._initial_ranks(
        jnp.asarray(sym), len(sym), packed, base)
    t = torch.from_numpy(sym)
    for route in (None, *map(_route, ROUTES)):
        rank, tied, sa = doubling._initial_ranks(t, packed, base, route)
        assert rank.dtype == sa.dtype == torch.int32
        assert tied == int(j_tied)
        assert (rank.numpy() == np.asarray(j_rank)).all()
        assert (_heads(rank, sa) == _heads(j_rank, j_order)).all()


def _after_rounds(sym, packed, base, rounds):
    """rank, sa, tied and k after the initial ranks and ``rounds`` full
    rounds, plain."""
    t = torch.from_numpy(sym)
    rank, tied, sa = doubling._initial_ranks(t, packed, base)
    k = base
    for _ in range(rounds):
        rank, tied, sa = doubling._doubling_round(rank, sa, k)
        k *= 2
    return rank, sa, tied, k


@pytest.mark.parametrize("kind,n,rounds", [
    ("dna", 2049, 0), ("dna", 65, 2), ("dna_clamped", 2048, 1),
    ("clonal", 600, 1), ("duplicated", 500, 3),
])
def test_doubling_round_equals_andix(kind, n, rounds):
    sym, packed, base = _text(kind, n, n + rounds)
    rank, sa, _, k = _after_rounds(sym, packed, base, rounds)
    nn = len(sym)
    j_rank, j_tied, j_order = jdoubling._doubling_round(
        jnp.asarray(rank.numpy()), k, nn)
    for route in (None, *map(_route, ROUTES)):
        r, tied, s = doubling._doubling_round(rank.clone(), sa.clone(), k,
                                              route)
        assert tied == int(j_tied)
        assert (r.numpy() == np.asarray(j_rank)).all()
        assert (_heads(r, s) == _heads(j_rank, j_order)).all()


@pytest.mark.parametrize("kind,n,rounds", [
    ("dna", 2049, 1), ("dna", 17, 0), ("dna_wide6", 2049, 0),
    ("clonal", 600, 2), ("duplicated", 500, 1), ("family", 700, 1),
])
def test_extract_and_bucketed_round_equal_andix(kind, n, rounds):
    """From the same ranks and SA: the tied slots and suffixes, then one
    tail round (ranks, tied count, the still-tied slots ascending and the
    heads of their suffixes), and the next round after it too."""
    sym, packed, base = _text(kind, n, 3 * n + rounds)
    rank, sa, tied, k = _after_rounds(sym, packed, base, rounds)
    assert tied > 0
    nn = len(sym)
    tp = jdoubling._bucket_t(tied)
    j_slots, j_savals = jdoubling._extract_tied(jnp.asarray(rank.numpy()),
                                                jnp.asarray(sa.numpy()), tp)
    j_slots = np.asarray(j_slots)[:tied]
    assert (np.asarray(j_savals)[:tied] == sa.numpy()[j_slots]).all()
    jr, js, jsl, jsv, jt = jdoubling._bucketed_round(
        jnp.asarray(rank.numpy()), jnp.asarray(sa.numpy()),
        jnp.asarray(np.pad(j_slots, (0, tp - tied), constant_values=nn)),
        jnp.asarray(np.pad(sa.numpy()[j_slots], (0, tp - tied),
                           constant_values=nn)), k, tp)
    jt = int(jt)
    jr = np.asarray(jr)
    for route in (None, *map(_route, ROUTES)):
        r, s = rank.clone(), sa.clone()
        slots, sa_vals = doubling._extract_tied(r, s, tied, route)
        assert (slots.numpy() == j_slots).all()
        assert (sa_vals.numpy() == sa.numpy()[j_slots]).all()
        t2, slots2, sa_vals2 = doubling._bucketed_round(r, s, slots, sa_vals,
                                                       k, route)
        assert t2 == jt
        assert (r.numpy() == jr).all()
        assert (_heads(r, s) == _heads(jr, np.asarray(js))).all()
        assert (slots2.numpy() == np.asarray(jsl)[:jt]).all()
        assert (_heads(r, sa_vals2) == jr[np.asarray(jsv)[:jt]]).all()
        assert (np.sort(sa_vals2.numpy()) == np.sort(np.asarray(jsv)[:jt])
                ).all()
        if t2:  # the compaction feeds the next round
            t3, slots3, _ = doubling._bucketed_round(r, s, slots2, sa_vals2,
                                                     2 * k, route)
            ref = doubling._bucketed_round(
                torch.from_numpy(jr.copy()), torch.from_numpy(
                    np.asarray(js).copy()), torch.from_numpy(
                    np.asarray(jsl)[:jt].astype(np.int64)),
                torch.from_numpy(np.asarray(jsv)[:jt].copy()), 2 * k)
            assert t3 == ref[0]
            assert (slots3.numpy() == ref[1].numpy()).all()


@pytest.mark.parametrize("kind,n", [("dna", 2049), ("dna", 3),
                                    ("duplicated", 500)])
@pytest.mark.parametrize("max_levels", [None, 3])
def test_sa_lcp_device_equals_andix(kind, n, max_levels):
    """SA, LCP (where the flag is down) and the flags, plain ==
    andix, in levels mode."""
    sym, packed, base = _text(kind, n, n)
    bw = base if packed else None
    j_sa, j_lcp, j_ovf, j_may = jdoubling.sa_lcp_device(
        jnp.asarray(sym), packed=packed, max_levels=max_levels,
        base_width=bw)
    sa, lcp, ovf, may = doubling.sa_lcp_device(
        torch.from_numpy(sym), packed=packed, max_levels=max_levels,
        base_width=bw)
    assert (sa.numpy() == np.asarray(j_sa)).all()
    assert bool(ovf) == bool(j_ovf) and may == j_may
    if not bool(ovf):
        assert (lcp.numpy() == np.asarray(j_lcp)).all()


def test_twin_keys_equal_plain_keys():
    """sa_keys' host twin gives the plain version's initial keys bit for
    bit, in every mode, on a text with separators and padding, and each
    position as its sort value."""
    sym, _, _ = _text("family", 300, 5)
    t = torch.from_numpy(sym)
    kern = _route("twin")
    n = len(sym)
    cases = [(doubling._KEY_WIDTH1, False, 1),
             (doubling._KEY_CLAMPED, True, 4)]
    cases += [(doubling._KEY_WIDE, True, b) for b in range(5, 13)]
    for mode, packed, base in cases:
        got, vals = kern.keys(mode, t, None, n, base=base)
        ref = doubling._initial_keys_plain(t, packed, base)
        assert torch.equal(got, ref), (mode, base)
        assert torch.equal(vals, torch.arange(n, dtype=torch.int32))


def test_kernels_refuse_bad_inputs():
    """The wrappers check dtype, contiguity and device before a pointer
    goes to the kernels (here their twin): int64 slots, as the plain
    extract gives, a strided rank, a card route's CPU tensor."""
    twin = _route("twin")
    rank = torch.zeros(8, dtype=torch.int32)
    keys = torch.zeros(4, dtype=torch.int64)
    vals = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        twin.keys(doubling._KEY_FULL, rank.long(), None, 8, 1)
    with pytest.raises(ValueError):
        twin.keys(doubling._KEY_TAIL, rank, vals.long(), 4, 1)
    with pytest.raises(ValueError):
        twin.rerank(doubling._RR_TAIL, 4, keys, vals, vals.long(), rank,
                    rank.clone(), (vals.clone(), vals.clone()))
    with pytest.raises(ValueError):
        twin.rerank(doubling._RR_FULL, 4, keys, vals, rank=rank[::2],
                    sa=rank[:4].clone())
    with pytest.raises(ValueError):
        doubling.Kernels().rerank(doubling._RR_FULL, 8, keys, vals,
                                  rank=rank, sa=rank.clone())
