"""andix_torch's suffix-array and LCP build against ``andix``'s, exactly,
on block texts: ``doubling.sa_lcp_device`` in hybrid and levels modes
(SA, LCP over the real region, overflow flag), the doubling loop's
level count and level rows (``sa_loop`` against ``_sa_core``), with the
full level buffer and with one cut short; the sampled-PLCP LCP
(``plcp_lcp_hybrid``: the plain version and the kernels' host twin)
against ``andix.esa.plcp.plcp_lcp_hybrid`` with every level row and with
fewer, where entries stay open and the flag rises, the twin at the
kernels' sample runs and at tiny ones; and the pieces
``wide_base_width``, ``clz64``, ``_word_m``, ``_build_w16`` and the
kernels' packed text.

The cases are those of tests/test_backend_jax.py's SA/LCP tests: two
genomes at 0, 0.004, 0.05 and 0.3 divergence, three at 0.005 and 0.2,
the ACGT x 800 repeat pair and two identical genomes (3000 bp)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix.esa import doubling as jdoubling
from andix.esa import joint as jjoint
from andix.esa import plcp as jplcp
from andix.esa.backend_jax import bucket, device_text
from andix.sequence import catcomp
from andix_torch.esa import doubling, plcp

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def _dna(rng, n):
    return NUCL[rng.integers(0, 4, n)]


def _mutate(rng, seq, rate):
    codes = np.searchsorted(NUCL, seq)
    hit = rng.random(len(seq)) < rate
    return NUCL[(codes + np.where(hit, rng.integers(1, 4, len(seq)), 0)) % 4]


def _families():
    out = {}
    for i, rate in enumerate((0, 0.004, 0.05, 0.3)):
        rng = np.random.default_rng(5000 + i)
        base = _dna(rng, 600 + 97 * i)
        out[f"pair_{rate}"] = {0: catcomp(base),
                               1: catcomp(_mutate(rng, base, rate))}
    rng = np.random.default_rng(12345)
    base = _dna(rng, 900)
    out["three"] = {0: catcomp(base), 1: catcomp(_mutate(rng, base, 0.005)),
                    2: catcomp(_mutate(rng, base, 0.2))}
    rep = np.frombuffer(b"ACGT" * 800, np.uint8).copy()
    out["repeat_pair"] = {0: catcomp(rep), 1: catcomp(rep.copy())}
    # 3000 bp: adjacent LCPs of 6 kbp, past the 328 probes of 16 symbols
    # that an entry gets without the walk's top rows
    base = _dna(np.random.default_rng(77), 3000)
    out["identical"] = {0: catcomp(base), 1: catcomp(base.copy())}
    return out


FAMILIES = _families()


@pytest.fixture(scope="module")
def blocks():
    """Per family: the real length, andix's padded device text (both
    packages build from it), its segment count."""
    out = {}
    for name, rs in FAMILIES.items():
        layout = jjoint.build_block(rs, {})
        sym_d = device_text(layout, bucket(layout.n))
        out[name] = (layout.n, sym_d, len(layout.genome_ids))
    return out


@pytest.mark.parametrize("max_levels", [None, 4])
@pytest.mark.parametrize("mode", ["hybrid", "levels"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_sa_lcp_device_equals_andix(blocks, name, mode, max_levels):
    """andix's ``max_levels=None`` keeps at most 14 rows in hybrid mode,
    the port as many as the text needs: the port gets andix's 14
    explicitly."""
    n_real, sym_d, nseg = blocks[name]
    base = jdoubling.wide_base_width(nseg, True)
    j_sa, j_lcp, j_ovf, j_may = jdoubling.sa_lcp_device(
        sym_d, packed=True, max_levels=max_levels, lcp_mode=mode,
        base_width=base)
    if max_levels is None and mode == "hybrid":
        max_levels = 14
    sym = torch.from_numpy(np.array(sym_d))
    sa, lcp, ovf, may = doubling.sa_lcp_device(
        sym, packed=True, max_levels=max_levels, lcp_mode=mode,
        base_width=base)
    assert (sa.numpy() == np.asarray(j_sa)).all()
    assert bool(ovf) == bool(j_ovf) and may == j_may
    if not bool(j_ovf):
        assert (lcp.numpy()[:n_real] == np.asarray(j_lcp)[:n_real]).all()
    if max_levels in (None, 14):
        assert not bool(ovf)
    if name in ("identical", "repeat_pair") and max_levels == 4:
        assert bool(ovf)  # the cut buffer cannot hold these repeats

    # the loop: level count, the rows below it and the flag
    L = doubling.plan_levels(len(sym), True, base, max_levels, True,
                             mode)[0]
    thr0 = int(len(sym) * jdoubling._BUCKET_FRAC)
    r_sa, r_lev, r_cnt, r_ovf = jdoubling._sa_core(
        sym_d, packed=True, L=L, thr0=thr0,
        tiers=jdoubling._tail_tiers(len(sym), thr0), base=base)
    sa2, levels, lev_count, ovf2 = doubling.sa_loop(sym, True, L, base)
    assert lev_count == int(r_cnt) and ovf2 == bool(r_ovf)
    rows = min(lev_count, L)
    assert len(levels) == rows
    assert (torch.stack(levels).numpy() == np.asarray(r_lev)[:rows]).all()
    assert (sa2 == sa).all()


def test_deep_repeats_keep_every_level_row():
    """Two identical 60 kbp genomes: adjacent LCPs of 120 kbp take 14
    levels, and the tie-free last round's ranks then land in row 13 of
    andix's 14-row hybrid buffer, so andix, and the port held to its 14
    rows, raise the flag (same SA and flag).  The port with no cap keeps
    every level in its own row, and its LCP (plain version and the
    kernels' host twin) equals the host Φ LCP."""
    from andix_torch import native

    base_seq = _dna(np.random.default_rng(91), 60_000)
    layout = jjoint.build_block({0: catcomp(base_seq),
                                 1: catcomp(base_seq.copy())}, {})
    sym_d = device_text(layout, bucket(layout.n))
    base = jdoubling.wide_base_width(2, True)
    sym = torch.from_numpy(np.array(sym_d))
    j_sa, _, j_ovf, _ = jdoubling.sa_lcp_device(
        sym_d, packed=True, lcp_mode="hybrid", base_width=base)
    sa14, _, ovf14, _ = doubling.sa_lcp_device(
        sym, packed=True, max_levels=14, lcp_mode="hybrid", base_width=base)
    assert bool(j_ovf) and bool(ovf14)
    assert (sa14.numpy() == np.asarray(j_sa)).all()

    counts = []
    sa, lcp, ovf, _ = doubling.sa_lcp_device(
        sym, packed=True, lcp_mode="hybrid", base_width=base,
        on_sa=lambda c, L: counts.append((c, L)))
    assert not bool(ovf) and torch.equal(sa, sa14)
    assert counts[0][0] == 14 and counts[0][1] > 14
    ref = native.lcp_from_sa(sym.numpy(), sa.numpy(), 2)
    n = layout.n
    assert (lcp.numpy()[1:n] == ref[1:n]).all()
    sa2, levels, cnt, _ = doubling.sa_loop(sym, True, counts[0][1], base)
    t_lcp, t_ovf, _ = plcp.plcp_lcp_hybrid_cpu_twin(sym, sa2, levels, cnt,
                                                    base)
    assert torch.equal(t_lcp, lcp) and not bool(t_ovf)


def _sa_and_levels(sym_d, nseg):
    """andix's SA, level buffer and level count of a block text, and the
    base width."""
    base = jdoubling.wide_base_width(nseg, True)
    L = jdoubling.levels_needed(sym_d.shape[0], True, base)
    thr0 = int(sym_d.shape[0] * jdoubling._BUCKET_FRAC)
    sa_d, lev_d, cnt, ovf = jdoubling._sa_core(
        sym_d, packed=True, L=L, thr0=thr0,
        tiers=jdoubling._tail_tiers(sym_d.shape[0], thr0), base=base)
    assert not bool(ovf)
    return sa_d, lev_d, int(cnt), base


def _plcp_three_ways(sym_d, sa_d, lev_d, cnt, base, rows):
    """andix's, the plain version's and the host twin's (the kernels' run
    sizes and tiny ones) LCP and flag, with ``rows`` level rows ("all":
    every one the text needs): all equal.  Returns the plain LCP, flag and
    the twins' counters."""
    k = cnt if rows == "all" else min(rows, cnt)
    lev = np.array(lev_d)[: max(k, 1)]
    j_lcp, j_ovf = jplcp.plcp_lcp_hybrid(sym_d, sa_d, jnp.asarray(lev),
                                         jnp.int32(k), base_width=base)
    args = (torch.from_numpy(np.array(sym_d)), torch.from_numpy(
        np.array(sa_d)), torch.from_numpy(lev), k, base)
    lcp, p_ovf = plcp.plcp_lcp_hybrid(*args)
    assert bool(p_ovf) == bool(j_ovf)
    # every survivor fits andix's fill buffer here, so even the open
    # entries hold what andix's buffers do
    assert (lcp.numpy() == np.asarray(j_lcp)).all()
    counters = []
    for tiny in (False, True):
        t_lcp, t_ovf, c = plcp.plcp_lcp_hybrid_cpu_twin(*args, tiny=tiny)
        assert torch.equal(t_lcp, lcp) and bool(t_ovf) == bool(p_ovf), tiny
        counters.append(c)
    # the open entries are andix's, entry by entry, whatever the run length
    assert torch.equal(counters[0][:2], counters[1][:2])
    return lcp, p_ovf, counters


@pytest.mark.parametrize("rows", ["all", 3, 1, 0])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_plcp_equals_andix_and_twin(blocks, name, rows):
    """The sampled-PLCP LCP from the full level stack and from a cut one
    (the top rows missing): plain == andix (LCP and flag), and the
    kernels' host twin == plain, with the kernels' sample runs and with
    tiny ones.  With every row no sample goes to the settle pass."""
    n_real, sym_d, nseg = blocks[name]
    sa_d, lev_d, cnt, base = _sa_and_levels(sym_d, nseg)
    _, p_ovf, (counters, _) = _plcp_three_ways(sym_d, sa_d, lev_d, cnt,
                                               base, rows)
    if rows == "all":  # nothing open, no sample deferred
        assert not bool(p_ovf) and counters.tolist() == [0, 0, 0]
    if name == "identical" and rows in (1, 0):
        assert bool(p_ovf) and counters[0] > 0  # samples left open


def _chain_texts():
    """Three block texts for the sample runs: a 400 bp repeat that starts
    inside a run, so a sample of the run after a short PLCP (its bound 0)
    needs more probes than it gets and walks; a family whose separators
    fall inside runs; and a genome whose samples at x, x + 16, ...,
    x + 80 (one run of 8) have PLCPs 1000, 2000, ..., 6000 (a copy of the
    text from each, that many symbols long, before it in suffix order),
    so that runs of 8 samples with 64 probes find each from the one
    before, though andix's schedule leaves the last open with no level
    row (past its 328 probes)."""
    rng = np.random.default_rng(404)
    g = _dna(rng, 4000)
    g[2003:2403] = g[500:900]
    rep = {0: catcomp(g), 1: catcomp(_mutate(rng, g, 0.1))}
    sep = {i: catcomp(_dna(rng, 413 + 77 * i)) for i in range(3)}
    n, b = 56000, 3000
    g = _dna(rng, n)
    for k in range(6):  # the copies end on "A" where x's text has "T"
        g[b + 16 * k + 1000 * (k + 1)] = ord("T")
    for k in range(6):
        c, m = 10_000 + 7000 * k, 1000 * (k + 1)
        g[c: c + m], g[c + m] = g[b + 16 * k: b + 16 * k + m], ord("A")
    # x at text offset len(g) + 1 + b: a run's second sample for runs of 8
    tail = (128 + 16 - (n + 1 + b) % 128) % 128
    g = np.concatenate([g, _dna(rng, tail)])
    return {"repeat_in_run": rep, "runs_across_separators": sep,
            "rising_repeats": {0: catcomp(g)}}


CHAIN_TEXTS = _chain_texts()


@pytest.mark.parametrize("rows", ["all", 1, 0])
@pytest.mark.parametrize("name", list(CHAIN_TEXTS))
def test_plcp_sample_runs_equal_andix(name, rows):
    """The twin's sample runs on the texts of ``_chain_texts`` (each shown
    to hold its case at the run sizes it names): LCP, flag and open
    entries equal to andix's and to the plain version's; on the rising
    repeats also with runs of 8 samples and 64 probes, where a run finds
    PLCPs that andix's schedule leaves open, and must defer them."""
    layout = jjoint.build_block(CHAIN_TEXTS[name], {})
    sym_d = device_text(layout, bucket(layout.n))
    sa_d, lev_d, cnt, base = _sa_and_levels(sym_d, len(layout.genome_ids))
    lcp, ovf, counters = _plcp_three_ways(sym_d, sa_d, lev_d, cnt, base,
                                          rows)
    exact = _plcp_three_ways(sym_d, sa_d, lev_d, cnt, base, "all")[0]
    sym = np.asarray(sym_d)
    plcp_arr = np.zeros(len(sym), np.int64)
    plcp_arr[np.asarray(sa_d)] = exact.numpy()
    S = plcp_arr[::16]
    j = np.arange(1, len(S))
    for chain, tries in ((plcp.CHAIN, plcp.TRIES),
                         (plcp.TINY_CHAIN, plcp.TINY_TRIES)):
        inside = j % chain != 0
        bound = np.maximum(S[:-1] - 16, 0)
        if name == "repeat_in_run":
            walks = inside & (bound == 0) & (S[1:] >= 16 * tries)
            assert walks.any(), chain
        elif name == "runs_across_separators":
            special = ~np.isin(sym[: layout.n], [65, 67, 71, 84, 33, 35,
                                                   59])
            pos = np.flatnonzero(special)
            run = 16 * chain  # samples at run starts + 0, 16, ...
            assert ((pos % run >= 1) & (pos % run < run - 16)).any(), chain
    if name == "rising_repeats":
        x = np.flatnonzero(S == 1000)
        x = [i for i in x if (S[i: i + 6] == np.arange(1, 7) * 1000).all()]
        assert len(x) == 1 and x[0] % 8 == 1
        args = (torch.from_numpy(np.array(sym_d)),
                torch.from_numpy(np.array(sa_d)),
                torch.from_numpy(np.array(lev_d)[: max(
                    cnt if rows == "all" else rows, 1)]),
                cnt if rows == "all" else rows, base)
        t_lcp, t_ovf, c = plcp.plcp_lcp_hybrid_cpu_twin(*args,
                                                        runs=(8, 64))
        assert torch.equal(t_lcp, lcp) and bool(t_ovf) == bool(ovf)
        assert torch.equal(c[:2], counters[0][:2])
        assert bool(ovf) == (rows != "all")


def test_wide_base_width_equals_andix():
    for nseg in (1, 2, 6, 7, 8, 22, 23, 40, 54, 55, 118, 119, 246, 247,
                 502, 503, 700):
        for ok in (True, False):
            assert (doubling.wide_base_width(nseg, ok)
                    == jdoubling.wide_base_width(nseg, ok)), (nseg, ok)
    assert doubling.wide_base_width(8, True) == 12
    assert doubling.wide_base_width(40, True) == 10


def test_levels_needed_equals_andix():
    for n in (1, 2, 3, 4, 5, 1000, 1024, 1025, 1 << 24, 100_663_296):
        for packed in (False, True):
            for base in (None, 4, 6, 12):
                assert (doubling.levels_needed(n, packed, base)
                        == jdoubling.levels_needed(n, packed, base))


def test_word_compare_equals_andix():
    """clz64 and _word_m on words with every nibble pattern that matters:
    equal words, specials in either or both, negative words."""
    rng = np.random.default_rng(3)
    wa = rng.integers(-2**63, 2**63 - 1, 4000, dtype=np.int64)
    wb = wa.copy()
    flip = rng.integers(0, 16, 4000)
    wb[:3000] ^= (np.int64(1) << (4 * flip[:3000])).astype(np.int64)
    nib = rng.integers(0, 8, (1000, 16))  # codes 0..7: specials included
    words = np.zeros(1000, np.uint64)
    for j in range(16):
        words = (words << np.uint64(4)) | nib[:, j].astype(np.uint64)
    wa[3000:] = words.view(np.int64)
    wb[3000:] = np.roll(words, 1).view(np.int64)
    wb[3000:3100] = wa[3000:3100]
    wa[0], wb[0] = 0, 0
    got = plcp._word_m(torch.from_numpy(wa), torch.from_numpy(wb)).numpy()
    ref = np.asarray(jplcp._word_m(jnp.asarray(wa), jnp.asarray(wb)))
    assert (got == ref).all()
    x = np.concatenate([wa, [0, 1, -1, 2**62, -2**63]]).astype(np.int64)
    clz = plcp.clz64(torch.from_numpy(x)).numpy()
    ref = [64 - int(v).bit_length() if v >= 0 else 0 for v in x]
    assert clz.tolist() == ref


def test_w16_equals_andix(blocks):
    for name, (_, sym_d, _) in blocks.items():
        got = plcp._build_w16(torch.from_numpy(np.array(sym_d))).numpy()
        assert (got == np.asarray(jplcp._build_w16(sym_d))).all(), name


def test_packed_text_equals_andix(blocks):
    """The kernels' packed text (plain and the twin's pack body) holds
    ``w16`` at every 16th position and words of zeros past the end, and
    the twin's probe read gives ``w16`` at every position."""
    for name, (_, sym_d, _) in blocks.items():
        sym = torch.from_numpy(np.array(sym_d))
        w16 = np.asarray(jplcp._build_w16(sym_d))
        text, words = plcp.packed_reads_cpu_twin(sym)
        plain = plcp.pack_text_plain(sym)
        assert torch.equal(text, plain), name
        pad = plcp.TEXT_PAD
        assert (text.numpy()[:-pad] == w16[::16]).all()
        assert (text[-pad:] == 0).all()
        assert (words.numpy() == w16).all(), name
