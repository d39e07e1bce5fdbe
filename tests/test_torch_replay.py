"""andix_torch's count-in-loop replay (``replay_rows``) against andix's
``replay_rows_device``: the plain lock-step version (what the CPU path
runs) and the CUDA kernels' two passes built for the host with g++ (the
"CPU twin"), at the kernels' window sizes and at tiny ones, on the same
block tables, unsegmented and with the lanes cut into K query segments
spliced with a trail of M anchors (K in 1, 2, 3, 8, 64; M in 1, 2, 12);
then ``calculate_matrix`` with ``ANDIX_REPLAY=loop`` on the
CPU against andix's ``ANDIX_REPLAY=loop`` on the cases of
tests/test_replay_device.py and every model, and the sharded grid with
``ANDIX_SHARDED_REPLAY=loop``.  Every comparison is exact: the counts
are integers.  The kernel itself is held to the plain version on a card
by tests/test_torch_cuda.py."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix import parallel as jparallel
from andix import pipeline as jpipeline
from andix.chain import replay_device as jrd
from andix.chain import segmented as jsegmented
from andix.esa import joint
from andix.esa.backend_jax import JaxBackend, device_text
from andix.runtime import Context as JContext, Model as JModel
from andix.sequence import Seq as JSeq, join as jjoin, revcomp, subject_init
from andix_torch import pipeline
from andix_torch.chain import replay_device as rd
from andix_torch.esa.backend import BlockContext
from andix_torch.runtime import Context, Model
from andix_torch.sequence import Seq

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")


def _mutate(r, base, rate):
    codes = np.searchsorted(NUCL, base)
    hit = r.random(len(base)) < rate
    return NUCL[(codes + np.where(hit, r.integers(1, 4, len(base)), 0)) % 4]


def _block(genomes):
    """JAX's exact block state and [Sg, QB] tables of ``genomes`` (every
    one a subject), JAX's loop counts in both modes, and the same state
    as a port BlockContext with its replay lanes."""
    seqs = [JSeq(g, f"g{k}") for k, g in enumerate(genomes)]
    subjects = [subject_init(s, JContext().anchor_p_value) for s in seqs]
    n = len(seqs)
    be = JaxBackend()
    layout = joint.build_block({i: subjects[i].rs for i in range(n)}, {})
    jctx = be.prepare_block(layout)
    sg, gp, segs, starts, rs_lens, thresholds, q_len2d = be._group_tables(
        jctx, list(range(n)), dict(enumerate(subjects)))
    text = device_text(layout, jctx.sa_d.shape[0])
    ref = {}
    for exact in (False, True):
        counts, _ = jrd.subject_group_counts_device(
            jctx.sa_d, jctx.lcp_d, jctx.segid_d, jctx.tq_d, text,
            jctx.isa_d, jctx.rm, jnp.asarray(segs), jnp.asarray(starts),
            jnp.asarray(rs_lens), jnp.asarray(thresholds), jctx.q_base_d,
            jctx.q_start_d, jnp.asarray(q_len2d), 0, exact)
        ref[exact] = np.asarray(counts)
    mlun, ps = jrd.group_subject_tables(
        jctx.sa_d, jctx.lcp_d, jctx.segid_d, jctx.tq_d, jnp.asarray(segs),
        jnp.asarray(starts), jnp.asarray(thresholds), 0, want_jump=False)
    ctx = BlockContext.from_numpy(
        layout, *(np.asarray(x) for x in (jctx.sa_d, jctx.lcp_d,
                                          jctx.segid_d, jctx.isa_d,
                                          jctx.tq_d)),
        jctx.q_start_h, jctx.q_len_h, jctx.q_base_h, CPU)
    lanes = rd.replay_lanes(starts, rs_lens, thresholds, jctx.q_base_h,
                            jctx.q_start_h, q_len2d, CPU)
    tables = (torch.from_numpy(np.array(mlun)),
              torch.from_numpy(np.array(ps)))
    return ctx, tables, lanes, ref


def border_pair(seed=9):
    """A subject S and a query that holds the end of S's reverse
    complement, one base in place of the strand separator, then the start
    of S: the subject string is revcomp(S) + '#' + S, so the query's two
    parts are two unique anchors on one diagonal, one on each side of the
    RS border rl / 2.  Each is shorter than twice the threshold, so the
    border test of the pairing (src/process.c:160-189) decides whether
    either counts."""
    s = NUCL[np.random.default_rng(seed).integers(0, 4, 2000)]
    thr = subject_init(JSeq(s, "s"), JContext().anchor_p_value).threshold
    part = 2 * thr - 3
    q = np.concatenate([revcomp(s)[-part:], NUCL[:1], s[:part]])
    return [s, q]


@pytest.fixture(scope="module")
def blocks():
    """A 4 x 700 family at rates 0.004, 0.05 and 0.2 (andix's
    test_events_path_equals_loop_path); a 3 x 600 block with a clonal
    pair and an unrelated genome; an unrelated (anchor-free) pair; a
    clonal copy; joined contigs; a near-clonal 2000 bp pair, whose
    anchors are longer than the segments of K = 64, beside a 40 bp genome
    shorter than K; and the border pair."""
    r = np.random.default_rng(21)
    base = NUCL[r.integers(0, 4, 700)]
    family = [base] + [_mutate(r, base, x) for x in (0.004, 0.05, 0.2)]
    other = NUCL[r.integers(0, 4, 600)]
    clonal = [other, other.copy(), NUCL[r.integers(0, 4, 600)]]
    c1, c2 = NUCL[r.integers(0, 4, 300)], NUCL[r.integers(0, 4, 250)]
    long = NUCL[r.integers(0, 4, 2000)]
    return {"family": _block(family),
            "clonal": _block(clonal),
            "unrelated": _block([NUCL[r.integers(0, 4, 500)],
                                 NUCL[r.integers(0, 4, 400)]]),
            "identical": _block([other, other.copy()]),
            "joined": _block([jjoin([c1, c2]),
                              jjoin([_mutate(r, c1, 0.04),
                                     _mutate(r, c2, 0.04)])]),
            "long_anchors": _block([long, _mutate(r, long, 0.002),
                                    long[1000:1040].copy()]),
            "border": _block(border_pair())}


CASES = [(name, exact) for name in ("family", "clonal")
         for exact in (False, True)]
SPLICE_CASES = CASES + [
    (name, exact) for name in ("unrelated", "identical", "joined",
                               "long_anchors", "border")
    for exact in (False, True)]


@pytest.mark.parametrize("name,exact", CASES)
def test_plain_equals_jax(blocks, name, exact):
    ctx, (mlun, ps), lanes, ref = blocks[name]
    counts, tally = rd.replay_rows(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                   lanes, exact, 4)  # CPU tensors: plain
    assert counts.dtype == torch.int32 and counts.shape == ref[exact].shape
    assert (counts.numpy() == ref[exact]).all()
    assert counts.sum() > 0
    # probe steps in every lane with a query; sites only where counted
    active = lanes["q_len"] > 0
    assert (tally[..., 0][active] > 0).all()
    assert (tally[~active] == 0).all()
    assert bool(tally[..., 2].any()) == exact


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name,exact", CASES)
def test_cpu_twin_of_kernel_equals_plain(blocks, name, exact, tiny):
    _need_gxx()
    ctx, (mlun, ps), lanes, ref = blocks[name]
    args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, exact)
    for chase in (0, 4, 12):
        got = rd.replay_rows_cpu_twin(*args, chase, tiny=tiny)
        want = rd.replay_rows_plain(*args, chase)
        assert (got[0].numpy() == ref[exact]).all()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def plain_runs(blocks):
    """replay_rows_plain's (counts, tally) of each case, computed once."""
    memo = {}

    def run(name, exact):
        if (name, exact) not in memo:
            ctx, (mlun, ps), lanes, _ = blocks[name]
            memo[name, exact] = rd.replay_rows_plain(
                ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, exact, 4)
        return memo[name, exact]

    return run


def _segments(lanes, k):
    """Non-empty query segments of every lane (andix's
    ``chain.segmented.plan_segments``)."""
    return sum(len(jsegmented.plan_segments(int(q), k))
               for q in lanes["q_len"].reshape(-1).tolist() if q > 0)


@pytest.mark.parametrize("segments", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("name,exact", SPLICE_CASES)
def test_cpu_twin_splice_equals_plain(blocks, plain_runs, name, exact,
                                      segments):
    """The two passes with every lane cut into K query segments and a
    trail of M anchors: counts and per-lane tallies (the unsegmented
    walk's probe steps and sites) equal the plain version's and the
    counts andix's, whatever K, M and the window sizes."""
    _need_gxx()
    ctx, (mlun, ps), lanes, ref = blocks[name]
    want = plain_runs(name, exact)
    assert (want[0].numpy() == ref[exact]).all()
    args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, exact, 4)
    spliced = _segments(lanes, segments) - int((lanes["q_len"] > 0).sum())
    for trail in (1, 2, 12):
        for tiny in (False, True):
            splice = {}
            got = rd.replay_rows_cpu_twin(*args, segments=segments,
                                          trail=trail, tiny=tiny,
                                          splice=splice)
            assert torch.equal(got[0], want[0]), (trail, tiny)
            assert torch.equal(got[1], want[1]), (trail, tiny)
            assert splice["segments"] == segments
            merges, fallbacks, steps = splice["lanes"].sum(dim=(0, 1))
            # each segment after the first merges, falls back or was
            # passed over by the true walk
            assert int(merges) + int(fallbacks) <= spliced
            assert int(steps) >= int(fallbacks)
            if segments == 1:
                assert not splice["lanes"].any()


@pytest.mark.parametrize("name", ["family", "long_anchors"])
def test_trail_of_one_forces_fallbacks(blocks, plain_runs, name):
    """With a trail of one anchor a repair merges only on the cold walk's
    first anchor, which a segment that starts inside an anchor records
    as that anchor's tail: such segments fall back and walk to their end,
    and the counts stay exact.  A longer trail merges them."""
    _need_gxx()
    ctx, (mlun, ps), lanes, _ = blocks[name]
    args = (ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, True, 4)
    want = plain_runs(name, True)
    stats = {}
    for trail in (1, 12):
        splice = {}
        got = rd.replay_rows_cpu_twin(*args, segments=8, trail=trail,
                                      splice=splice)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        stats[trail] = splice["lanes"].sum(dim=(0, 1)).tolist()
    assert stats[1][1] > 0, stats
    assert stats[12][0] > stats[1][0] and stats[12][1] < stats[1][1], stats


def test_border_pair_is_not_paired(blocks, plain_runs):
    """The border pair's two anchors lie on one diagonal across the RS
    border, so andix neither pairs them nor counts them: the query's
    lane against S counts nothing, and a replay that dropped the border
    test would count both anchors' sites (the twin, whatever K)."""
    _need_gxx()
    ctx, (mlun, ps), lanes, ref = blocks["border"]
    assert ref[False][0, 1].sum() == 0 and ref[True][0, 1].sum() == 0
    for exact in (False, True):
        want = plain_runs("border", exact)
        assert want[0][0, 1].sum() == 0 and want[1][0, 1, 0] > 0
        for segments in (1, 4, 64):
            got = rd.replay_rows_cpu_twin(ctx.isa, ctx.rm, ctx.text, mlun,
                                          ps, lanes, exact, 4,
                                          segments=segments)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_segments_rule():
    """K = 1 below 2^17 symbols; above, enough segments for 24 warps an
    SM over the live lanes, each segment at least 2^15 symbols."""
    def k(shape, qlen, sms=132):
        return rd.replay_segments(torch.full(shape, qlen, dtype=torch.int32),
                                  sms)

    assert k((8, 8), 50_000) == 1 and k((8, 8), (1 << 17) - 1) == 1
    assert k((8, 8), 5_000_000) == 50  # 132 * 24 / 64 lanes
    assert k((8, 8), 1_000_000) == 30  # 2^15 symbols a segment
    assert k((22, 22), 5_000_000) == 7
    assert k((0, 8), 5_000_000) == 1
    q = torch.zeros((8, 8), dtype=torch.int32)
    q[0, 1] = 5_000_000  # one live lane
    assert rd.replay_segments(q, 132) == 152


def test_exact_equal_count_of_every_byte():
    """The kernels' exact equal count, which reads 16-byte chunks and
    counts four bytes a word, against the byte rule of andix's
    model_count_equal (a byte at least 'A' on the diagonal cell of
    ``(s >> 1) & 3``) over every byte value, with intervals that start
    and end at every offset from a 16-byte boundary."""
    _need_gxx()
    r = np.random.default_rng(4)
    text = np.concatenate([np.arange(256, dtype=np.uint8),
                           r.integers(0, 256, 1000).astype(np.uint8),
                           NUCL[r.integers(0, 4, 600)]])
    cell = np.array([0, 5, 15, 10])[(text >> 1) & 3]
    t = torch.from_numpy(text)
    base = t.data_ptr() % 16
    for start in list(range(0, 40)) + [256, 1256]:
        for length in (0, 1, 15, 16, 17, 33, 64, 255, 600):
            got = rd.replay_equal_cpu_twin(t, start, length)
            part = slice(start, start + length)
            want = np.bincount(cell[part][text[part] >= 65], minlength=16)
            assert (got.numpy() == want).all(), (start, length, base)


def test_cpu_twin_refuses_an_interval_outside_the_text(blocks):
    """A counted interval past the text's end raises (the twin, like the
    kernel, reports it instead of clamping the reads)."""
    _need_gxx()
    ctx, (mlun, ps), lanes, _ = blocks["family"]
    short = ctx.text[: int(lanes["q_start"].max())].contiguous()
    with pytest.raises(RuntimeError, match="outside the text"):
        rd.replay_rows_cpu_twin(ctx.isa, ctx.rm, short, mlun, ps, lanes,
                                True, 4)
    with pytest.raises(RuntimeError, match="outside the text"):
        rd.replay_rows_plain(ctx.isa, ctx.rm, short, mlun, ps, lanes, True,
                             4)


def _grid(M, n):
    return np.array([[M[i][j].counts for j in range(n)] for i in range(n)])


@pytest.fixture
def loop_replay(monkeypatch):
    """Both packages on the joint schedule with ``ANDIX_REPLAY=loop``,
    single-process and unsharded; checks that the port's count-in-loop
    replay ran and the event walk did not."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED", "0")
    monkeypatch.setenv("ANDIX_REPLAY", "loop")
    from andix_torch.esa import backend

    calls = {"replay": 0}
    orig = backend.replay_rows

    def counting(*a, **kw):
        calls["replay"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(backend, "replay_rows", counting)
    def no_walk(*a, **kw):
        pytest.fail("the event walk ran")

    monkeypatch.setattr(backend.segdrive, "segmented_group_anchors",
                        no_walk)
    monkeypatch.setattr(backend, "chain_anchors_device", no_walk)

    def run(genomes, model="JC"):
        names = [f"g{k}" for k in range(len(genomes))]
        ref = jpipeline.calculate_matrix(
            [JSeq(d, nm) for nm, d in zip(names, genomes)],
            JContext(model=JModel(model)), backend=JaxBackend())
        got = pipeline.calculate_matrix(
            [Seq(d, nm) for nm, d in zip(names, genomes)],
            Context(model=Model(model)), [CPU])
        n = len(genomes)
        assert (_grid(got, n) == _grid(ref, n)).all()
        assert calls["replay"] > 0
        return _grid(got, n)

    return run


@pytest.mark.parametrize("model", ["JC", "Kimura", "LogDet", "ANI", "Raw"])
def test_loop_mutated_family_every_model(loop_replay, model):
    r = np.random.default_rng(5)
    base = NUCL[r.integers(0, 4, 700)]
    loop_replay([base] + [_mutate(r, base, x) for x in (0.004, 0.05, 0.2)],
                model)


@pytest.mark.parametrize("model", ["JC", "LogDet"])
def test_loop_identical_pair(loop_replay, model):
    s = NUCL[np.random.default_rng(6).integers(0, 4, 600)]
    got = loop_replay([s, s.copy()], model)
    assert got[0, 1].sum() == 600 and got[0, 1].sum() == np.trace(
        got[0, 1].reshape(4, 4))


def test_loop_unrelated_pair(loop_replay):
    r = np.random.default_rng(7)
    loop_replay([NUCL[r.integers(0, 4, 500)], NUCL[r.integers(0, 4, 400)]])


def test_loop_repetitive(loop_replay):
    rep = np.frombuffer(b"ACGTACGTAA" * 60, np.uint8).copy()
    tail = np.frombuffer(b"GGCCTTAAGC" * 30, np.uint8).copy()
    loop_replay([np.concatenate([rep, tail]),
                 np.concatenate([rep[7:], tail])], "LogDet")


@pytest.mark.parametrize("model", ["JC", "LogDet"])
def test_border_pair_loop_and_events_equal_andix(monkeypatch, model):
    """The border pair through calculate_matrix on the joint schedule:
    the count-in-loop path (``ANDIX_REPLAY=loop``) and the default events
    path (the walk and the host count) both give andix's grid, in which
    the query's lane against S counts nothing."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED", "0")
    from andix_torch.esa import backend

    ran = []
    replay, walk, whole = (backend.replay_rows,
                           backend.segdrive.segmented_group_anchors,
                           backend.chain_anchors_device)

    def loop(*a, **kw):
        ran.append("loop")
        return replay(*a, **kw)

    def events(*a, **kw):
        ran.append("events")
        return walk(*a, **kw)

    def events_whole(*a, **kw):
        ran.append("events")
        return whole(*a, **kw)

    monkeypatch.setattr(backend, "replay_rows", loop)
    monkeypatch.setattr(backend.segdrive, "segmented_group_anchors", events)
    monkeypatch.setattr(backend, "chain_anchors_device", events_whole)
    genomes = border_pair()
    names = ["g0", "g1"]
    ref = _grid(jpipeline.calculate_matrix(
        [JSeq(d, nm) for nm, d in zip(names, genomes)],
        JContext(model=JModel(model)), backend=JaxBackend()), 2)
    assert ref[0, 1].sum() == 0
    for mode in ("loop", "events"):
        monkeypatch.setenv("ANDIX_REPLAY", mode)
        ran.clear()
        got = pipeline.calculate_matrix(
            [Seq(d, nm) for nm, d in zip(names, genomes)],
            Context(model=Model(model)), [CPU])
        assert set(ran) == {mode}
        assert (_grid(got, 2) == ref).all(), mode


@pytest.mark.parametrize("model", ["JC", "ANI"])
def test_loop_joined_contigs(loop_replay, model):
    r = np.random.default_rng(8)
    c1, c2 = NUCL[r.integers(0, 4, 300)], NUCL[r.integers(0, 4, 250)]
    a = jjoin([c1, c2])
    b = jjoin([_mutate(r, c1, 0.04), _mutate(r, c2, 0.04)])
    assert (a < 65).any()  # the contig join
    loop_replay([a, b], model)


def test_sharded_loop_equals_andix(monkeypatch):
    """``ANDIX_SHARDED_REPLAY=loop``: andix's sharded grid (8 virtual
    devices) and the port's on 8 CPU workers, 3 x 300, each through its
    count-in-loop replay."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED_REPLAY", "loop")
    r = np.random.default_rng(61)
    base = NUCL[r.integers(0, 4, 300)]
    fam = [base, _mutate(r, base, 0.02), _mutate(r, base, 0.04)]
    names = ["g0", "g1", "g2"]
    info = jparallel._sharded_counts_fn.cache_info()
    before = info.hits + info.misses
    ref = jpipeline.calculate_matrix(
        [JSeq(d, nm) for nm, d in zip(names, fam)], JContext(), JaxBackend())
    info = jparallel._sharded_counts_fn.cache_info()
    assert info.hits + info.misses > before, "andix not sharded"

    from andix_torch.esa import backend

    modes = []
    orig = backend.TorchBackend.subject_group_counts

    def recording(self, *a, replay=None, **kw):
        modes.append(replay)
        return orig(self, *a, replay=replay, **kw)

    monkeypatch.setattr(backend.TorchBackend, "subject_group_counts",
                        recording)
    def no_walk(*a, **kw):
        pytest.fail("the event walk ran")

    monkeypatch.setattr(backend.segdrive, "segmented_group_anchors",
                        no_walk)
    monkeypatch.setattr(backend, "chain_anchors_device", no_walk)
    got = pipeline.calculate_matrix([Seq(d, nm) for nm, d in zip(names, fam)],
                                    Context(), [CPU] * 8)
    assert modes and set(modes) == {"loop"}
    assert (_grid(got, 3) == _grid(ref, 3)).all()


def test_twin_refuses_bad_lanes(blocks):
    """The wrappers check the lane arrays before passing pointers, and
    name themselves in the error."""
    _need_gxx()
    ctx, (mlun, ps), lanes, _ = blocks["family"]
    args = (ctx.isa, ctx.rm, ctx.text, mlun, ps)
    for name, bad in (("q_len", lanes["q_len"].long()),
                      ("thr", lanes["thr"][:-1]),
                      ("q_base", lanes["q_base"].reshape(1, -1))):
        with pytest.raises(ValueError, match=f"replay_rows: {name}"):
            rd.replay_rows_cpu_twin(*args, dict(lanes, **{name: bad}), False,
                                    4)
    with pytest.raises(ValueError, match="replay_rows: text"):
        rd.replay_rows_cpu_twin(ctx.isa, ctx.rm, ctx.text.int(), mlun, ps,
                                lanes, False, 4)
    with pytest.raises(ValueError, match="chain_walk_flat: text"):
        rd.chain_walk_flat_cpu_twin(ctx.isa, ctx.rm, ctx.text.int(), mlun,
                                    ps, {"row": lanes["thr"]}, 1, 1, 1, 4, 4)
