"""andix_torch ESA pieces against the JAX package, exactly: suffix array
and LCP (``doubling.sa_lcp_device`` in levels mode on arbitrary texts;
the block-text cases of both modes are in test_torch_plcp.py), range-min, matching statistics, subject tables, the block
tables of ``prepare_block``, and the verbatim host-module copies."""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix.chain import replay_device as jrd
from andix.esa import backend_jax, doubling as jdoubling
from andix.esa import joint as jjoint
from andix.esa import matchstats_jax, plcp as jplcp, rmq as jrmq, sa_numpy
from andix.runtime import Context
from andix.sequence import Seq, subject_init
from andix_torch.chain import replay_device as rd
from andix_torch.esa import backend, doubling, matchstats, rmq

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def _family_block(rng, dna, mutator, n=3, length=1500,
                  rates=(0.02, 0.2)):
    base = dna(rng, length)
    seqs = [Seq(base, "g0")] + [
        Seq(mutator(rng, base, r), f"g{k + 1}")
        for k, r in enumerate(rates[: n - 1])
    ]
    subjects = [subject_init(s, Context().anchor_p_value) for s in seqs]
    layout = jjoint.build_block({0: subjects[0].rs, 1: subjects[1].rs},
                                {k: seqs[k].data for k in range(2, n)})
    return seqs, subjects, layout


def _texts(rng, dna, mutator):
    base = dna(rng, 700)
    joint_sym = _family_block(rng, dna, mutator)[2].sym
    yield "random", rng.integers(0, 6, 1000).astype(np.int32)
    yield "random_dna", dna(rng, 2000).astype(np.int32)
    yield "tandem", np.frombuffer(b"GATTACA" * 64, np.uint8).astype(np.int32)
    yield "homopolymer", np.full(300, 65, np.int32)
    yield "duplicated", np.concatenate(
        [base, [256], base, [257]]).astype(np.int32)
    yield "joint", joint_sym
    yield "joint_padded", backend.pad_symbols(
        joint_sym, backend.bucket(len(joint_sym), minimum=1024))


def test_sa_lcp_equal_jax_and_numpy(rng, dna, mutator):
    for name, sym in _texts(rng, dna, mutator):
        t = torch.from_numpy(sym)
        sa, got_lcp, ovf, may_ovf = doubling.sa_lcp_device(t)
        got_lcp = got_lcp.numpy()
        j_sa, j_lcp, j_ovf, _ = jdoubling.sa_lcp_device(jnp.asarray(sym))
        assert not bool(j_ovf) and not bool(ovf) and not may_ovf
        ref_sa = sa_numpy.suffix_array(sym)
        assert (sa.numpy() == np.asarray(j_sa)).all(), name
        assert (sa.numpy() == ref_sa).all(), name
        assert (got_lcp == np.asarray(j_lcp)).all(), name
        assert (got_lcp == sa_numpy.lcp_array(sym, ref_sa)).all(), name
        # levels stop at the text's longest repeat
        L = doubling.levels_needed(len(sym))
        lev_count = doubling.sa_loop(t, False, L, 1)[2]
        assert 1 << lev_count > got_lcp.max(), name


def test_sa_trivial_sizes():
    for sym in ([], [5], [2, 1], [1, 1]):
        s = np.asarray(sym, np.int32)
        sa, lcp, _, _ = doubling.sa_lcp_device(torch.from_numpy(s))
        assert (sa.numpy() == sa_numpy.suffix_array(s)).all()
        if len(s):
            assert (lcp.numpy() == sa_numpy.lcp_array(
                s, sa_numpy.suffix_array(s))).all()


@pytest.mark.parametrize("n", [1, 7, 9, 513, 3000, 70000])
def test_range_min_equals_jax_and_brute(rng, n):
    vals = rng.integers(0, 1000, n).astype(np.int32)
    m = 4000
    lo = rng.integers(0, n, m).astype(np.int32)
    span = rng.choice([0, 1, 5, 9, 70, 600, 5000, n], m)
    hi = np.minimum(lo + span, n - 1).astype(np.int32)
    lo[:50] = hi[:50] + 1  # empty ranges
    got = rmq.range_min(rmq.build(torch.from_numpy(vals)),
                        torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    ref = np.asarray(jrmq.range_min(jrmq.build(jnp.asarray(vals)),
                                    jnp.asarray(lo), jnp.asarray(hi)))
    assert (got == ref).all()
    brute = np.array([vals[a: b + 1].min() if a <= b else 2**31 - 1
                      for a, b in zip(lo, hi)])
    assert (got == brute).all()


RM_ARRAYS = ("values", "pref8", "suff8", "t8", "prefg", "suffg", "tg")


@pytest.mark.parametrize("kind", ["runs", "constant"])
@pytest.mark.parametrize("n", [1, 7, 9, 513, 3000, 70000, 2**17 + 5])
def test_range_min_build_equals_andix(rng, n, kind):
    """``build_plain`` and the range-min kernel's host twin (at the
    kernel's tiles and at tiny ones, where the t8 windows cross many
    tiles) give every array ``andix``'s build gives that the port keeps:
    on values with runs of INF and of one value, and on all-equal
    values."""
    if kind == "runs":
        vals = rng.integers(0, 1000, n).astype(np.int32)
        for start in rng.integers(0, n, 6):
            vals[start: start + int(rng.integers(1, 700))] = 2**31 - 1
        for start in rng.integers(0, n, 6):
            vals[start: start + int(rng.integers(1, 700))] = 17
    else:
        vals = np.full(n, 42, np.int32)
    ref = jrmq.build(jnp.asarray(vals))
    t = torch.from_numpy(vals)
    for label, got in (("plain", rmq.build_plain(t)),
                       ("twin", rmq.build_cpu_twin(t)),
                       ("tiny twin", rmq.build_cpu_twin(t, tiny=True))):
        for name in RM_ARRAYS:
            a = getattr(got, name).numpy()
            b = np.asarray(getattr(ref, name))
            assert a.shape == b.shape and (a == b).all(), (label, name)
    assert rmq.build(t).tg.shape == tuple(ref.tg.shape)  # CPU: plain


def test_ilog2_exact():
    x = torch.tensor([0, 1, 2, 3, 4, 7, 8, 2**24 - 1, 2**24, 2**24 + 1,
                      2**31 - 1], dtype=torch.int64)
    want = [0, 0, 1, 1, 2, 2, 3, 23, 24, 24, 30]
    assert rmq.ilog2(x).tolist() == want


@pytest.fixture
def jax_block(rng, dna, mutator):
    seqs, subjects, layout = _family_block(rng, dna, mutator, n=4,
                                           rates=(0.02, 0.1, 0.4))
    be = backend_jax.JaxBackend()
    ctx = be.prepare_block(layout)
    return seqs, subjects, layout, be, ctx


def test_prepare_block_equals_jax(jax_block):
    _, _, layout, _, jctx = jax_block
    ctx = backend.TorchBackend(torch.device("cpu")).prepare_block(layout)
    n_real = layout.n
    assert (ctx.sa.numpy() == np.asarray(jctx.sa_d)).all()
    # pad-vs-pad LCPs are never read (the JAX text clamps padding)
    assert (ctx.lcp.numpy()[: n_real + 1]
            == np.asarray(jctx.lcp_d)[: n_real + 1]).all()
    assert (ctx.segid.numpy() == np.asarray(jctx.segid_d)).all()
    assert (ctx.isa.numpy() == np.asarray(jctx.isa_d)).all()
    assert (ctx.tq.numpy() == np.asarray(jctx.tq_d)).all()
    for a, b in ((ctx.q_start_h, jctx.q_start_h), (ctx.q_len_h, jctx.q_len_h),
                 (ctx.q_base_h, jctx.q_base_h), (ctx.q_off, jctx.q_off),
                 (ctx.query_blob, jctx.query_blob)):
        assert (np.asarray(a) == np.asarray(b)).all()


@pytest.mark.parametrize("byte", [None, ord("N")])
def test_prepare_block_modes_equal_jax(rng, dna, mutator, byte):
    """A block in the block alphabet (12-wide ranks, hybrid LCP) and one
    with a foreign byte in a genome (4-wide clamped ranks, the level
    walk): SA, LCP and the alphabet check equal andix's."""
    seqs, subjects, _ = _family_block(rng, dna, mutator)
    rs = subjects[1].rs.copy()
    if byte is not None:
        rs[100:105] = byte
    layout = jjoint.build_block({0: subjects[0].rs, 1: rs},
                                {2: seqs[2].data})
    present = np.nonzero(np.bincount(layout.u8, minlength=256))[0]
    assert backend.alphabet_ok(torch.from_numpy(layout.sym), layout.n) == (
        byte is None) == all(int(b) in jplcp.ALPHABET_U8 for b in present)
    jctx = backend_jax.JaxBackend().prepare_block(layout)
    ctx = backend.TorchBackend(torch.device("cpu")).prepare_block(layout)
    n_real = layout.n
    assert (ctx.sa.numpy() == np.asarray(jctx.sa_d)).all()
    assert (ctx.lcp.numpy()[: n_real + 1]
            == np.asarray(jctx.lcp_d)[: n_real + 1]).all()


def test_level_overflow_takes_the_host_lcp(rng, dna, monkeypatch):
    """andix's recipe (test_level_budget_overflow_falls_back_to_host): two
    identical 800 bp genomes and a level budget of (68 - 40) / 4 = 7 rows,
    fewer than they need, so the SA loop overflows; the block takes the
    host Φ LCP and the counts are andix's."""
    from andix import pipeline as jpipeline
    from andix.sequence import Seq as JSeq
    from andix_torch import pipeline
    from andix_torch.runtime import Context as TContext
    from andix_torch.sequence import Seq as TSeq

    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED", "0")
    base = dna(rng, 800)
    want = jpipeline.calculate_matrix([JSeq(base, "a"), JSeq(base.copy(), "b")],
                                      Context(), jpipeline.NumpyBackend())
    budgets, calls = [], []
    lcp_from_sa = backend.native.lcp_from_sa

    def budget(padded_n, _):
        budgets.append(padded_n)
        return (68 * padded_n - 40 * padded_n) // (4 * padded_n)

    def spy(sym, sa, threads=0):
        calls.append(len(sa))
        return lcp_from_sa(sym, sa, threads)

    monkeypatch.setattr(backend, "level_budget", budget)
    monkeypatch.setattr(backend.native, "lcp_from_sa", spy)
    got = pipeline.calculate_matrix(
        [TSeq(base, "a"), TSeq(base.copy(), "b")], TContext(),
        [torch.device("cpu")])
    assert budgets == [backend.bucket(2 * (2 * 800 + 2))]
    assert calls == budgets, "the block did not take the host LCP"
    for i in range(2):
        for j in range(2):
            assert (got[i][j].counts == want[i][j].counts).all()
            assert got[i][j].seq_len == want[i][j].seq_len


def _port_ctx(layout, jctx):
    return backend.BlockContext.from_numpy(
        layout, *(np.asarray(x) for x in (jctx.sa_d, jctx.lcp_d,
                                          jctx.segid_d, jctx.isa_d,
                                          jctx.tq_d)),
        jctx.q_start_h, jctx.q_len_h, jctx.q_base_h, torch.device("cpu"),
    )


def test_match_stats_equal_jax(jax_block):
    _, _, layout, _, jctx = jax_block
    ctx = _port_ctx(layout, jctx)
    for seg in range(len(layout.genome_ids) + 1):  # + a segment-free id
        start = int(layout.seg_start[min(seg, len(layout.genome_ids))])
        ref = matchstats_jax.match_stats_device(
            jctx.sa_d, jctx.lcp_d, jctx.segid_d, jnp.int32(seg),
            jnp.int32(start))
        got = matchstats.match_stats_device(ctx.sa, ctx.lcp, ctx.segid, seg,
                                            start)
        for a, b in zip(ref, got):
            assert (np.asarray(a) == b.numpy()).all()
    isa = matchstats.inverse_sa_device(ctx.sa).numpy()
    assert (isa == np.asarray(jctx.isa_d)).all()


def test_group_tables_equal_jax(jax_block):
    _, subjects, layout, be, jctx = jax_block
    ctx = _port_ctx(layout, jctx)
    sg, gp, segs, starts, _, thresholds, _ = be._group_tables(
        jctx, [0, 1], dict(enumerate(subjects)))
    ref = jrd.group_subject_tables(
        jctx.sa_d, jctx.lcp_d, jctx.segid_d, jctx.tq_d, jnp.asarray(segs),
        jnp.asarray(starts), jnp.asarray(thresholds), 0, want_jump=False)
    got = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq, segs,
                                  starts)
    assert segs.tolist()[2:] == [-1] * (sg - 2)  # padding rows covered
    for a, b in zip(ref, got):
        assert (np.asarray(a) == b.numpy()).all()


def test_bucket_and_pad_symbols_equal_jax(rng):
    for n in (0, 1, 1000, 1025, 1536, 1537, 70001, 2**24 - 7):
        assert backend.bucket(n) == backend_jax.bucket(n)
        assert backend.bucket(n, 4096) == backend_jax.bucket(n, 4096)
    sym = rng.integers(65, 300, 999).astype(np.int32)
    for padded in (999, 1024, 1536):
        assert (backend.pad_symbols(sym, padded)
                == backend_jax.pad_symbols(sym, padded)).all()


@pytest.mark.parametrize("module", [
    "runtime.py", "sequence.py", "fasta.py", "model.py", "output.py",
    "esa/joint.py", "esa/sa_numpy.py", "chain/events.py",
    "chain/replay_py.py", "oracle.py",
])
def test_host_modules_are_verbatim_copies(module):
    """The device-free host modules are copies of andix's (andix imports
    jax at package import, so the port cannot import them); they must
    stay byte for byte equal."""
    assert filecmp.cmp(os.path.join(ROOT, "andix", module),
                       os.path.join(ROOT, "andix_torch", module),
                       shallow=False), module


def test_host_native_source_is_a_verbatim_copy():
    """``andix_torch.native`` builds its own copy of the host counting
    source, byte for byte ``andix``'s, and reads nothing under andix/."""
    from andix_torch import native

    assert native.SOURCE == os.path.join(ROOT, "andix_torch", "csrc",
                                         "host_native.cpp")
    assert filecmp.cmp(os.path.join(ROOT, "andix", "native",
                                    "andix_native.cpp"),
                       native.SOURCE, shallow=False)
