"""andix_torch subject index against the JAX package, exactly: order codes,
packed words (negative int64 words included), k-mer caches for k = 1..4,
and the whole per-subject build (SA, LCP, words, cache) against JAX's
``fused_build`` and the numpy oracle, on the cases of
tests/test_subject_index.py; plus the verbatim copy of the numpy half.

Then the schedule built on the index (``ANDIX_INDEX=subject``,
``--backend cpu``) against andix's on the remaining families of
tests/test_walk_sx.py (low-memory groups, LogDet, an 8-slot event
buffer) and on a clonal pair and a self-repeating genome, and the port's
repairs of the group walk: an odd ``ANDIX_EVENT_CAP`` works, a
segmented resolve that does not converge, and a walk that would repeat a
dispatch forever, send the group to the joint schedule; a level
overflow takes the host LCP."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix import pipeline as jpipeline
from andix.esa import doubling as jdoubling
from andix.esa import joint as jjoint
from andix.esa import plcp as jplcp
from andix.esa import subject_index as jsi
from andix.esa.backend_jax import (
    JaxBackend, bucket, device_text, level_budget,
)
from andix.runtime import Context as JContext, Model as JModel
from andix.sequence import Seq, subject_init
from andix_torch import pipeline, subject_pipeline
from andix_torch.chain import segdrive
from andix_torch.esa import backend
from andix_torch.esa import subject_index as si
from andix_torch.runtime import Context, Model
from andix_torch.sequence import Seq as TSeq

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_seq(n, rng):
    return NUCL[rng.integers(0, 4, n)]


def _mutate(base, rate, rng):
    codes = np.searchsorted(NUCL, base)
    hit = rng.random(len(base)) < rate
    return NUCL[(codes + np.where(hit, rng.integers(1, 4, len(base)), 0)) % 4]


def _cases():
    """(name, subject bytes, query byte strings): the subject-index test
    cases — a related pair, joined contigs with '!' in both, low-complexity
    repeats, and tiny queries."""
    rng = np.random.default_rng(7)
    base = _random_seq(400, rng)
    yield "related", base, [_mutate(base, 0.05, rng)]
    rng = np.random.default_rng(23)
    base = _random_seq(300, rng)
    base[80] = base[200] = ord("!")
    q = _mutate(np.where(base == ord("!"), ord("A"), base), 0.03, rng)
    q[80] = q[250] = ord("!")
    yield "joined", base, [q]
    rng = np.random.default_rng(5)
    unit = _random_seq(17, rng)
    q = np.tile(unit, 12)[:180].copy()
    q[::37] = ord("A")
    yield "repeats", np.tile(unit, 20)[:300], [q]
    rng = np.random.default_rng(11)
    yield "tiny", _random_seq(64, rng), [_random_seq(n, rng)
                                         for n in (1, 2, 5)]


def _query_blob(queries):
    """Queries joined by one sentinel byte each, padded with at least 16
    more to a multiple of 16 (the schedule's query-word layout)."""
    parts = []
    for q in queries:
        parts += [q, np.zeros(1, np.uint8)]
    blob = np.concatenate(parts)
    return np.concatenate([blob, np.zeros((-len(blob)) % 16 + 16, np.uint8)])


CACHE_K = 4


@pytest.fixture(scope="module")
def cases():
    """Per case: the port's padded subject text and the JAX results (codes,
    words, caches, the fused build, the query words) from JAX's own padded
    device text, computed once."""
    out = []
    for name, subj, queries in _cases():
        rs = subject_init(Seq(subj, "s"), 0.025).rs
        layout = jjoint.build_block({0: rs}, {})
        lp = bucket(len(subj) * 2 + 2)
        sym_d = device_text(layout, lp)
        alphabet_ok = set(np.unique(layout.u8).tolist()) <= jplcp.ALPHABET_U8
        sa, lcp, ovf, words, cache = jsi.fused_build(
            sym_d, jnp.int32(layout.n), CACHE_K,
            "hybrid" if alphabet_ok else "levels",
            jdoubling.wide_base_width(1, alphabet_ok), level_budget(lp))
        codes_d = jsi.device_order_codes(sym_d)
        blob = _query_blob(queries)
        ref = dict(
            codes=np.asarray(codes_d), words=np.asarray(words),
            sa=np.asarray(sa), lcp=np.asarray(lcp), ovf=bool(ovf),
            cache=np.asarray(cache),
            caches={k: np.asarray(jsi.build_cache_device(
                codes_d, jnp.int32(layout.n), k)) for k in (1, 2, 3, 4)},
            words_sym=np.asarray(jsi.device_pack_words(sym_d)),
            qwords=np.asarray(jsi.device_pack_words_u8(jnp.asarray(blob))),
        )
        # the port pads on the host (strictly increasing symbols from
        # PAD_BASE on, like JAX's device text, but not the same values)
        out.append((name, layout, backend.pad_symbols(layout.sym, lp), blob,
                    ref))
    return out


def test_codes_and_words_equal_jax(cases):
    negative = 0
    for name, layout, sym, blob, ref in cases:
        t = torch.from_numpy(sym)
        codes = si.device_order_codes(t).numpy()
        assert (codes == ref["codes"]).all(), name
        assert (codes == si.order_codes_np(sym)).all(), name
        words = si.pack_words(t).numpy()
        assert (words == ref["words_sym"]).all(), name
        assert (words == si.pack_words_np(codes)).all(), name
        negative += int((words < 0).sum())
        qwords = si.pack_words_u8(torch.from_numpy(blob)).numpy()
        assert (qwords == ref["qwords"]).all(), name
        assert (qwords == si.pack_words_np(si.order_codes_np(blob))).all()
    # separator and padding codes (8, 9) in a word's top nibble
    assert negative > 0


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_caches_equal_jax_and_numpy(cases, k):
    for name, layout, sym, _, ref in cases:
        codes = si.device_order_codes(torch.from_numpy(sym))
        got = si.build_cache(codes, layout.n, k).numpy()
        assert (got == ref["caches"][k]).all(), (name, k)
        assert (got == si.build_cache_np(sym[: layout.n], k)).all(), name


def test_build_subject_index_equals_fused_build(cases):
    """SA over the whole padded length, LCP over the real text (all the
    walk reads), words and cache.  The two LCPs also agree on the padding
    — both are 0 there, since padding symbols are all distinct."""
    for name, layout, sym, _, ref in cases:
        assert not ref["ovf"], name
        sa, lcp, ovf, words, cache = si.build_subject_index(
            torch.from_numpy(sym), layout.n, CACHE_K,
            backend.alphabet_ok(torch.from_numpy(sym), layout.n),
            level_budget(len(sym)))
        assert not ovf, name
        n = layout.n
        assert (sa.numpy() == ref["sa"]).all(), name
        assert (lcp.numpy()[:n] == ref["lcp"][:n]).all(), name
        assert (lcp.numpy()[n:] == ref["lcp"][n:]).all(), name
        assert (lcp.numpy()[n:] == 0).all(), name
        assert (words.numpy() == ref["words"]).all(), name
        assert (cache.numpy() == ref["cache"]).all(), name
        # the numpy oracle on the unpadded text
        idx = si.build_subject_index_np(layout.u8[:-1], CACHE_K)
        assert (sa.numpy()[:n] == idx.sa).all(), name
        assert (lcp.numpy()[:n] == idx.lcp).all(), name
        assert (cache.numpy() == idx.cache).all(), name


NUMPY_HALF = ["_byte_lut", "order_codes_np", "pack_words_np",
              "SubjectIndexNp", "build_subject_index_np", "suffix_rank2",
              "build_cache_np", "_cmp_suffix_np", "search_np",
              "query_codes_np", "pick_cache_k"]


@pytest.mark.parametrize("name", NUMPY_HALF)
def test_numpy_half_is_a_verbatim_copy(name):
    assert (inspect.getsource(getattr(si, name))
            == inspect.getsource(getattr(jsi, name)))


def test_numpy_constants_equal():
    assert (si.PAD_BASE, si._BYTE_CODES, si.SEP_CODE, si.PAD_CODE) == (
        jsi.PAD_BASE, jsi._BYTE_CODES, jsi.SEP_CODE, jsi.PAD_CODE)
    assert (si._LUT == jsi._LUT).all()


def _family(n, length, rates, seed):
    """tests/test_walk_sx.py's family generator."""
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    out = [("g0", base)]
    for k in range(1, n):
        codes = np.searchsorted(NUCL, base)
        hit = rng.random(length) < rates[(k - 1) % len(rates)]
        out.append((f"g{k}", NUCL[(codes + np.where(
            hit, rng.integers(1, 4, length), 0)) % 4]))
    return out


def _clonal(fam):
    """The family with g1 replaced by a copy of g0."""
    return [(nm, fam[0][1].copy() if nm == "g1" else d) for nm, d in fam]


# (family, environment, low memory, LogDet)
FAMILIES = {
    "low_memory_groups": (_family(4, 2000, [0.03, 0.15], 41),
                          {"ANDIX_CHAIN_SEGMENTS": 4}, True, False),
    "logdet": (_family(3, 3000, [0.02, 0.08], 53),
               {"ANDIX_CHAIN_SEGMENTS": 4}, False, True),
    "event_cap_8": (_family(3, 2000, [0.02, 0.1], 61),
                    {"ANDIX_CHAIN_SEGMENTS": 4, "ANDIX_EVENT_CAP": 8},
                    False, False),
    "clonal": (_clonal(_family(3, 3000, [0.05], 71)), {}, False, False),
    # g0 is one 800 bp block twice over: its own index holds the repeat
    "self_repeat": ([(nm, np.concatenate([d, d]))
                     for nm, d in _family(3, 800, [0.03, 0.1], 67)],
                    {}, False, False),
}


def _grids(name, jax=False, env=None):
    """(counts, seq_len) grids of one package's subject-index schedule on
    a family; ``env`` replaces the family's environment."""
    fam, fam_env, low, logdet = FAMILIES[name]
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ANDIX_INDEX", "subject")
        m.setenv("ANDIX_SX_MESH", "0")  # andix: one device, like the port
        for k, v in (fam_env if env is None else env).items():
            m.setenv(k, str(v))
        if jax:
            ctx = JContext(low_memory=low,
                           model=JModel.LOGDET if logdet else JModel.JC)
            M = jpipeline.calculate_matrix([Seq(d, nm) for nm, d in fam],
                                           ctx, backend=JaxBackend())
        else:
            ctx = Context(low_memory=low,
                          model=Model.LOGDET if logdet else Model.JC)
            M = pipeline.calculate_matrix(
                [TSeq(d, nm) for nm, d in fam], ctx, [torch.device("cpu")])
    n = len(fam)
    return (np.array([[M[i][j].counts for j in range(n)] for i in range(n)]),
            np.array([[M[i][j].seq_len for j in range(n)] for i in range(n)]))


@pytest.fixture(scope="module")
def jax_grids():
    """andix's subject-index grids per family, computed once."""
    return {name: _grids(name, jax=True) for name in FAMILIES}


def _equal(a, b):
    return (a[0] == b[0]).all() and (a[1] == b[1]).all()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_subject_schedule_equals_jax(jax_grids, name):
    assert _equal(_grids(name), jax_grids[name])


@pytest.fixture
def driver_calls(monkeypatch):
    """Records (ecap, schedule) of every segmented walk and the joint
    blocks that ran."""
    calls = {"sx": [], "joint": [], "blocks": []}
    walk = segdrive.segmented_group_anchors

    def recording(fn, sg, gp, qb, *rest):
        calls["joint" if qb else "sx"].append(rest[-1])
        return walk(fn, sg, gp, qb, *rest)

    block = pipeline._process_block

    def recording_block(blk, *a, **kw):
        calls["blocks"].append(list(blk))
        return block(blk, *a, **kw)

    monkeypatch.setattr(segdrive, "segmented_group_anchors", recording)
    monkeypatch.setattr(pipeline, "_process_block", recording_block)
    return calls


@pytest.mark.parametrize("cap", [7, 1001])
def test_odd_event_cap(jax_grids, driver_calls, cap):
    """Odd caps work (no two-per-int32 pairing).  7 overflows at every
    size, escalates twice by 4 and hands the group to the joint schedule;
    1001 finishes on the subject index."""
    got = _grids("event_cap_8", env={"ANDIX_CHAIN_SEGMENTS": 4,
                                     "ANDIX_EVENT_CAP": cap})
    assert _equal(got, jax_grids["event_cap_8"])
    sx = driver_calls["sx"]
    assert sx[0] == cap and all(b == 4 * a for a, b in zip(sx, sx[1:]))
    if cap == 7:
        assert sx == [7, 28, 112] and driver_calls["blocks"]
    else:
        assert not driver_calls["blocks"]


def _without_merges(driver):
    """``driver`` with a walk callback whose cold walks' events (pass 1:
    budgets above one repair event) carry s = -1, so that no repair event
    meets one of them and no segment merges."""
    def driving(walk, *rest):
        def cold_apart(arr, chunk_iters, maxev):
            ev, *out = walk(arr, chunk_iters, maxev)
            if maxev > 1 and ev.shape[1]:
                ev = ev.copy()
                ev[2] = -1
            return (ev, *out)
        return driver(cold_apart, *rest)
    return driving


def test_nonconvergence_goes_to_the_joint_schedule(jax_grids, driver_calls,
                                                  monkeypatch, capsys):
    """A segmented resolve that never converges (one repair event, no
    fall-back, no merge): the group walks at one event cap only (a wider
    buffer would walk the same way) and its rows go to the joint
    schedule, with the same matrix."""
    monkeypatch.setattr(segdrive, "REPAIR_EVENTS", 1)
    monkeypatch.setattr(segdrive, "MAX_EXTENSIONS", 10**9)
    monkeypatch.setattr(segdrive, "segmented_group_anchors",
                        _without_merges(segdrive.segmented_group_anchors))
    got = _grids("event_cap_8", env={"ANDIX_CHAIN_SEGMENTS": 4})
    assert _equal(got, jax_grids["event_cap_8"])
    assert len(driver_calls["sx"]) == 1
    assert driver_calls["blocks"] == [[0, 1, 2]]
    assert "did not converge" in capsys.readouterr().err


def test_stalled_walk_goes_to_the_joint_schedule(jax_grids, driver_calls,
                                                 monkeypatch):
    """A chunk cap of 64 iterations: the clonal pair's exact matches need
    more, so the driver would repeat a dispatch unchanged forever (as
    andix's does); the group goes to the joint schedule after the first
    repeat, with andix's matrix."""
    monkeypatch.setattr(segdrive, "CHUNK_ITERS", 64)
    monkeypatch.setattr(segdrive, "CHUNK_ITERS_MAX", 64)
    assert _equal(_grids("clonal"), jax_grids["clonal"])
    assert driver_calls["blocks"] == [[0, 1, 2]]
    assert len(driver_calls["sx"]) == 1


def test_level_overflow_takes_the_host_lcp(jax_grids, monkeypatch):
    """A level budget of 3 rows: the self-repeating subject's index
    overflows its level buffer, its LCP is taken on the host (Φ), and
    the matrix is andix's."""
    calls = []
    lcp_from_sa = backend.native.lcp_from_sa

    def spy(sym, sa, threads=0):
        calls.append(len(sa))
        return lcp_from_sa(sym, sa, threads)

    monkeypatch.setattr(backend, "level_budget", lambda lp, budget: 3)
    monkeypatch.setattr(backend.native, "lcp_from_sa", spy)
    assert _equal(_grids("self_repeat"), jax_grids["self_repeat"])
    assert calls, "no subject took the host LCP"
    calls.clear()
    monkeypatch.undo()
    monkeypatch.setattr(backend.native, "lcp_from_sa", spy)
    assert _equal(_grids("self_repeat"), jax_grids["self_repeat"])
    assert not calls  # 14 rows hold the repeat


def test_plan_groups_fit_the_budget():
    """Groups respect the subject cap and the memory budget; low memory
    is one subject per group."""
    subjects = [subject_init(Seq(NUCL[np.zeros(n, np.int64)], "s"), 0.025)
                for n in (1000, 3000, 1000, 1000, 1000)]
    todo = list(range(5))
    assert subject_pipeline.plan_groups(subjects, todo, True, 4, 1 << 40,
                                        0) == [[i] for i in todo]
    assert subject_pipeline.plan_groups(subjects, todo, False, 4, 1 << 40,
                                        0) == [todo]
    lp = subject_pipeline.index_length(subjects[1])
    assert lp == bucket(2 * 3000 + 2)  # RS + separator
    cache = (4**4 + 1) * 4
    one = 8 * (lp * subject_pipeline.IDX_BYTES_PER_SYM + cache) + (
        lp * subject_pipeline.BUILD_BYTES_PER_PADDED_SYM + 4 * cache)
    assert subject_pipeline.plan_groups(subjects, todo, False, 4, one,
                                        0) == [[0, 1, 2, 3, 4]]
    small = subject_pipeline.plan_groups(subjects, todo, False, 4, one - 1,
                                         0)
    assert [i for g in small for i in g] == todo and len(small) > 1
