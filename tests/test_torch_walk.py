"""andix_torch flat chain walk against the JAX ``chain_walk_flat``: the
plain lock-step version (what the CPU path runs) and the CUDA kernel's
per-lane body built for the host with g++ (the "CPU twin"), at the
kernel's window sizes and at tiny ones.  Per lane: the event stream in
chain order and the exit state; overall: event count, overflow flag and
iterations.  Also the kernel's diagonal-window LCE against ISA +
range-min, and its event staging.  The kernel itself is held to the
plain version on a card by tests/test_torch_cuda.py."""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix import pipeline as jpipeline
from andix.chain import replay_device as jrd
from andix.esa import joint
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context
from andix.sequence import Seq, subject_init
from andix_torch import pipeline as tpipeline
from andix_torch.chain import replay_device as rd
from andix_torch.chain import segdrive
from andix_torch.esa import joint as tjoint
from andix_torch.esa.backend import BlockContext, TorchBackend
from andix_torch.runtime import Context as TContext
from andix_torch.sequence import Seq as TSeq

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
BIG = 1 << 29


def _family(n, length, rates, seed):
    r = np.random.default_rng(seed)
    base = NUCL[r.integers(0, 4, length)]
    seqs = [Seq(base, "g0")]
    for k in range(n - 1):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(length) < rates[k % len(rates)]
        seqs.append(Seq(NUCL[(codes + np.where(
            hit, r.integers(1, 4, length), 0)) % 4], f"g{k + 1}"))
    return seqs


@pytest.fixture(scope="module")
def block():
    """A 3 x 2500 bp joint block (the case of test_segmented.py's
    TestFlatKernelUnit) with JAX's exact tables, and the same state as a
    port BlockContext."""
    seqs = _family(3, 2500, [0.04, 0.35], seed=3)
    subjects = [subject_init(s, Context().anchor_p_value) for s in seqs]
    be = JaxBackend()
    layout = joint.build_block({i: subjects[i].rs for i in range(3)}, {})
    jctx = be.prepare_block(layout)
    sg, gp, segs, starts, rs_lens, thresholds, q_len2d = be._group_tables(
        jctx, [0, 1, 2], dict(enumerate(subjects)))
    mlun, ps = jrd.group_subject_tables(
        jctx.sa_d, jctx.lcp_d, jctx.segid_d, jctx.tq_d, jnp.asarray(segs),
        jnp.asarray(starts), jnp.asarray(thresholds), 0, want_jump=False)
    ctx = BlockContext.from_numpy(
        layout, *(np.asarray(x) for x in (jctx.sa_d, jctx.lcp_d,
                                          jctx.segid_d, jctx.isa_d,
                                          jctx.tq_d)),
        jctx.q_start_h, jctx.q_len_h, jctx.q_base_h, torch.device("cpu"))
    geo = dict(starts=starts, rs_lens=rs_lens, thresholds=thresholds,
               q_len2d=q_len2d, gp=gp, sg=sg, segs=segs)
    return jctx, mlun, ps, ctx, geo


def _lanes(jctx, geo, k):
    """Every (subject, query) lane cut into k segments, each entered
    cold (segment 0 from the start state) — the segmented walk's first
    pass — padded to 32 lanes like its lane buckets."""
    arr = {n: [] for n in rd.LANE_FIELDS}
    q_len2d = geo["q_len2d"]
    for s in range(geo["sg"]):
        for g in range(geo["gp"]):
            qlen = int(q_len2d[s, g])
            if qlen <= 0:
                continue
            step = -(-qlen // k)
            for j in range(k):
                st, en = j * step, min((j + 1) * step, qlen)
                if st >= en:
                    continue
                thr = int(geo["thresholds"][s])
                entry = (0, 0, 0, 0) if j == 0 else (
                    st, st - thr - 2, st - thr - 2, 0)
                for name, val in zip(
                    rd.LANE_FIELDS,
                    (s, jctx.q_base_h[g], jctx.q_start_h[g],
                     geo["starts"][s], geo["rs_lens"][s], thr, en) + entry,
                ):
                    arr[name].append(int(val))
    lb = 32
    assert len(arr["row"]) <= lb
    pad = dict(rl=1, thr=BIG)
    return {n: np.array(v + [pad.get(n, 0)] * (lb - len(v)), np.int32)
            for n, v in arr.items()}


def _jax_walk(jctx, mlun, ps, lanes, iters, maxev, ecap, chase, unroll):
    out = jrd.chain_walk_flat(
        jctx.isa_d, jctx.rm, mlun, ps,
        *(jnp.asarray(lanes[n]) for n in rd.LANE_FIELDS),
        jnp.int32(iters), jnp.int32(maxev), ecap, chase, unroll)
    return [np.asarray(x) for x in out]


def _per_lane(out, lb):
    cnt = min(int(out[4]), len(out[0]))
    ev = np.stack([np.asarray(x)[:cnt] for x in out[:4]])
    order = np.argsort(ev[0], kind="stable")
    ev = ev[:, order]
    bounds = np.searchsorted(ev[0], np.arange(lb + 1))
    return [ev[1:, bounds[i]: bounds[i + 1]] for i in range(lb)]


def _assert_same(ref, got, lb):
    got = [x.numpy() if isinstance(x, torch.Tensor) else x for x in got]
    assert int(got[4]) == int(ref[4])  # ev_cnt
    assert bool(got[5]) == bool(ref[5])  # ovf
    assert int(got[6]) == int(ref[6])  # iters
    for a, b in zip(ref[7:], got[7:]):  # pos, lq, ls, ll, fin
        assert (np.asarray(a) == np.asarray(b)).all()
    if not bool(ref[5]):
        for a, b in zip(_per_lane(ref, lb), _per_lane(got, lb)):
            assert a.shape == b.shape and (a == b).all()


# (segments per lane, max_iters, max_events, ecap, chase, unroll)
CASES = [
    (1, 1 << 28, 1 << 28, 1 << 15, 12, 4),  # whole lanes, grid-kernel chase
    (3, 1 << 28, 1 << 28, 1 << 15, 4, 4),  # cold segment entries
    (3, 16, 1, 1 << 15, 4, 4),  # truncated by iterations and events
    (2, 7, 3, 1 << 15, 4, 1),  # truncated, unroll 1
    (1, 1 << 28, 1 << 28, 64, 4, 4),  # event buffer overflow
]


def _run(block, case, fn):
    jctx, mlun, ps, ctx, geo = block
    k, iters, maxev, ecap, chase, unroll = case
    lanes = _lanes(jctx, geo, k)
    ref = _jax_walk(jctx, mlun, ps, lanes, iters, maxev, ecap, chase, unroll)
    t_lanes = {n: torch.from_numpy(v) for n, v in lanes.items()}
    got = fn(ctx.isa, ctx.rm, ctx.text, torch.from_numpy(np.array(mlun)),
             torch.from_numpy(np.array(ps)), t_lanes, iters, maxev, ecap,
             chase, unroll)
    _assert_same(ref, got, len(lanes["row"]))
    return ref


@pytest.mark.parametrize("case", CASES)
def test_plain_walk_equals_jax(block, case):
    ref = _run(block, case, rd.chain_walk_flat)  # CPU tensors: plain
    assert int(ref[4]) > 0


# the twin at the kernel's window sizes keeps the ids "case0".."case4"
TWIN_CASES = ([pytest.param(c, False, id=f"case{i}")
               for i, c in enumerate(CASES)]
              + [pytest.param(c, True, id=f"case{i}-tiny")
                 for i, c in enumerate(CASES)])


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")


@pytest.mark.parametrize("case,tiny", TWIN_CASES)
def test_cpu_twin_of_kernel_equals_jax(block, case, tiny):
    _need_gxx()
    _run(block, case, functools.partial(rd.chain_walk_flat_cpu_twin,
                                        tiny=tiny))


def _lce_pairs(ctx, a, b, tiny):
    a = torch.as_tensor(np.asarray(a, np.int32))
    b = torch.as_tensor(np.asarray(b, np.int32))
    return rd.walk_lce_cpu_twin(ctx.isa, ctx.rm, ctx.text, a, b, tiny=tiny)


def _diagonal_runs(starts_a, starts_b, lengths, n):
    """Pairs along each diagonal from (a0, b0), one offset after another
    (as the walk's lucky checks move along an anchor), inside the text."""
    a, b = [], []
    for a0, b0, length in zip(starts_a, starts_b, lengths):
        k = np.arange(length)
        keep = (a0 + k < n) & (b0 + k < n)
        a.append(a0 + k[keep])
        b.append(b0 + k[keep])
    return np.concatenate(a), np.concatenate(b)


@pytest.mark.parametrize("tiny", [False, True])
def test_window_lce_equals_range_min_on_probe_pairs(block, tiny):
    """The kernel's LCE from the diagonal window (cached mask, refills and
    the ISA + range-min finish past the window) equals ISA + range-min on
    every pair along the diagonals of the walk's anchors, from each
    anchor's start to past its end, and on random pairs."""
    _need_gxx()
    jctx, mlun, ps, ctx, geo = block
    lanes = _lanes(jctx, geo, 1)
    out = rd.chain_walk_flat_plain(
        ctx.isa, ctx.rm, ctx.text, torch.from_numpy(np.array(mlun)),
        torch.from_numpy(np.array(ps)),
        {n: torch.from_numpy(v) for n, v in lanes.items()}, 1 << 28,
        1 << 28, 1 << 15, 4, 4)
    cnt = int(out[4])
    lane, q, s, ln = (x[:cnt].numpy() for x in out[:4])
    n = ctx.layout.n
    # a lane of a genome against itself meets its own diagonal (LCE INF)
    a, b = _diagonal_runs(lanes["qs"][lane] + q - 3, lanes["ss"][lane] + s - 3,
                          np.minimum(ln, 600) + 40, n)
    rng = np.random.default_rng(5)
    a = np.concatenate([a, rng.integers(0, n, 4000)])
    b = np.concatenate([b, rng.integers(0, n, 4000)])
    win, ref = _lce_pairs(ctx, a, b, tiny)
    # the longest real LCE here (112) passes the tiny window; anchors past
    # the kernel's are the next test's
    assert len(a) > 10_000 and int(ref[ref < n].max()) > 100
    assert torch.equal(win, ref)


@pytest.mark.parametrize("tiny", [False, True])
def test_window_lce_at_text_edges_and_long_anchors(tiny):
    """Pairs at separators, at the ends of the reverse complements (the
    '#' between the halves matches), at n - 1, and anchors far longer than
    the window (a genome and its duplicate), on the port's own block
    tables."""
    _need_gxx()
    base = _family(2, 1200, [0.03], seed=8)
    seqs = [base[0], Seq(base[0].data.copy(), "dup"), base[1]]
    subjects = [subject_init(s, Context().anchor_p_value) for s in seqs]
    layout = tjoint.build_block({i: subjects[i].rs for i in range(3)}, {})
    ctx = TorchBackend(torch.device("cpu")).prepare_block(layout)
    n = layout.n
    seps = layout.seg_start[1:] - 1
    length = 1200
    rc_end = layout.seg_start[:-1] + length - 1  # last revcomp symbol
    fwd = layout.seg_start[:-1] + length + 1  # first forward symbol
    a, b = [], []
    for i in range(3):
        for j in range(3):
            if i == j:
                continue
            for d in range(-6, 3):  # across the '#' and into the forward
                a.append(rc_end[i] + d)
                b.append(rc_end[j] + d)
            for d in (0, 1, 100, length - 300, length - 2, length - 1):
                a.append(fwd[i] + d)  # up to the separator
                b.append(fwd[j] + d)
            for x in (seps[i], seps[i] - 1, n - 1, n - 2, 0):
                a += [x, seps[j]]
                b += [seps[j], x]
    ra, rb = _diagonal_runs([fwd[0], layout.seg_start[0]],
                            [fwd[1], layout.seg_start[1]],
                            [2 * length + 2] * 2, n)
    win, ref = _lce_pairs(ctx, np.concatenate([a, ra]),
                          np.concatenate([b, rb]), tiny)
    assert torch.equal(win, ref)
    assert int(ref[ref < n].max()) == 2 * length + 1  # revcomp, '#', fwd
    assert int(((ref > 256) & (ref < n)).sum()) > 1000


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("ecap", [50, 32, 33, 1])
def test_staged_events_in_chain_order_when_ecap_cuts_a_batch(block, tiny,
                                                             ecap):
    """With the event buffer ending inside a staging batch (32 events on
    the card, 3 tiny), ev_cnt and ovf are the plain walk's, and the slots
    below ecap hold the first events of the lanes in lane order, each
    lane's in chain order (the twin walks its lanes one after another)."""
    _need_gxx()
    jctx, mlun, ps, ctx, geo = block
    lanes = {n: torch.from_numpy(v) for n, v in _lanes(jctx, geo, 2).items()}
    args = (ctx.isa, ctx.rm, ctx.text, torch.from_numpy(np.array(mlun)),
            torch.from_numpy(np.array(ps)), lanes, 1 << 28, 1 << 28, ecap, 4,
            4)
    ref = rd.chain_walk_flat_plain(*args)
    got = rd.chain_walk_flat_cpu_twin(*args, tiny=tiny)
    assert int(got[4]) == int(ref[4]) > ecap and bool(got[5]) and bool(ref[5])
    ref_all = rd.chain_walk_flat_plain(*args[:8], 1 << 15, 4, 4)
    cnt = int(ref_all[4])
    ev = torch.stack([x[:cnt] for x in ref_all[:4]])
    lane_major = ev[:, torch.from_numpy(np.argsort(ev[0].numpy(),
                                                   kind="stable"))]
    assert torch.equal(torch.stack([x[:ecap] for x in got[:4]]),
                       lane_major[:, :ecap])
    for a, b in zip(got[7:], ref[7:]):  # pos, lq, ls, ll, fin
        assert torch.equal(a, b)


def test_text_bytes_hold_no_zero_symbol():
    """The kernel takes a 0 byte for a separator: every byte a sequence can
    hold after normalize, revcomp and catcomp is non-zero, the block text
    keeps each real byte and puts 0 at the separators, and a real 0 symbol
    is refused."""
    from andix_torch import sequence

    kept = sequence._KEEP[sequence._KEEP != 0]
    assert (sequence._REVCOMP[kept] != 0).all() and kept.min() > 0
    assert sequence.HASH != 0
    seqs = _family(2, 300, [0.1], seed=2)
    subjects = [subject_init(s, Context().anchor_p_value) for s in seqs]
    layout = tjoint.build_block({0: subjects[0].rs}, {1: seqs[1].data})
    backend = TorchBackend(torch.device("cpu"))
    text = backend.prepare_block(layout).text
    assert (text.numpy() == layout.u8).all()
    assert (text.numpy()[layout.seg_start[1:] - 1] == 0).all()
    layout.u8[5] = 0
    with pytest.raises(ValueError, match="a real symbol is 0"):
        backend.prepare_block(layout)


def _scalar_walk_reads(ctx, mlun, ps, lanes, chase, diag_win):
    """One lane after another in plain Python, whole lanes: the walk's
    counts, with each mlun entry in a set (the chain's and the probes')."""
    isa = ctx.isa.numpy()
    lcp = ctx.rm.values.numpy()
    uniq = 1 << 30
    c = dict(probes=0, hops=0, table_probes=0, table_anchors=0,
             lucky_checks=0, rm_fallbacks=0, lucky_bytes=0, events=0)

    def lce(a, b):
        t1, t2 = sorted((int(isa[a]), int(isa[b])))
        return (1 << 31) - 1 if t1 == t2 else int(lcp[t1 + 1: t2 + 1].min())

    for i in range(len(lanes["row"])):
        row, qoff, qs, ss, rl, thr, seg_end, pos, lq, ls, ll = (
            int(lanes[n][i]) for n in rd.LANE_FIELDS)
        chain, probed = set(), set()

        def hop(p):
            chain.add(p)
            v = int(mlun[row, qoff + p])
            ml = v & (uniq - 1)
            return p if (v & uniq) and ml >= thr else p + ml + 1

        while pos < seg_end:
            pos_qj = pos
            if pos - lq - ll > thr:
                pos_qj = hop(pos)
                for _ in range(chase):
                    if pos_qj >= seg_end:
                        break
                    pos_qj = hop(pos_qj)
            if pos_qj >= seg_end:
                break
            c["probes"] += 1
            advance = pos_qj - lq
            try_s = ls + advance
            found = False
            if try_s < rl and 0 <= advance - ll <= thr:
                length = lce(qs + pos_qj, ss + try_s)
                c["lucky_checks"] += 1
                c["rm_fallbacks"] += length >= diag_win
                c["lucky_bytes"] += min(2 * (length + 1), 16)
                found, this_s = length >= thr, try_s
            if not found:
                probed.add(pos_qj)
                v = int(mlun[row, qoff + pos_qj])
                length = v & (uniq - 1)
                found, this_s = bool(v & uniq) and length >= thr, int(
                    ps[row, qoff + pos_qj])
                c["table_anchors"] += found
            if found:
                lq, ls, ll = pos_qj, this_s, length
                c["events"] += 1
            pos = pos_qj + length + 1
        c["hops"] += len(chain)
        c["table_probes"] += len(probed - chain)
    return c


@pytest.mark.parametrize("k", [1, 3])
def test_plain_counts_each_table_entry_once(block, k):
    """The plain walk's counts, which set the kernel's byte bound, equal
    those of a scalar walk that keeps every mlun entry it reads in a set:
    a hop that stays on its candidate and a probe at the chain's last
    entry read nothing new, and ps is read only for the table's
    anchors."""
    jctx, mlun, ps, ctx, geo = block
    lanes = _lanes(jctx, geo, k)
    mlun, ps = np.array(mlun), np.array(ps)
    counts = {}
    rd.chain_walk_flat_plain(
        ctx.isa, ctx.rm, ctx.text, torch.from_numpy(mlun),
        torch.from_numpy(ps),
        {n: torch.from_numpy(v) for n, v in lanes.items()}, 1 << 28,
        1 << 28, 1 << 15, 4, 4, counts, diag_win=24)
    ref = _scalar_walk_reads(ctx, mlun, ps, lanes, 4, 24)
    assert counts == ref
    assert min(ref.values()) > 0
    assert ref["table_anchors"] < ref["probes"] - ref["lucky_checks"]



# --- the unsegmented events walk (andix's chain_anchors_device) ---

def _group_args(jctx, geo):
    """The group's lane arrays in ``chain_anchors_device``'s order."""
    return (geo["starts"], geo["rs_lens"], geo["thresholds"],
            jctx.q_base_h, jctx.q_start_h, geo["q_len2d"])


def _twin_walk(*args):
    return rd.chain_walk_flat_cpu_twin(*args)


@pytest.mark.parametrize("ecap", [1 << 15, 64])
@pytest.mark.parametrize("route", ["plain", "twin", "tables"])
def test_chain_anchors_device_equals_andix(block, monkeypatch, route, ecap):
    """Every (subject, query) lane walked whole into one buffer: the
    event count, the overflow flag (``ev_cnt > ecap`` over the whole walk)
    and, without an overflow, each lane's stream equal andix's
    ``chain_anchors_device`` (its jump tables, chase 12, unroll 1); by
    the plain walk, by the kernel's host twin, and with the tables built
    by ``subject_group_anchors_device``."""
    jctx, mlun, ps, ctx, geo = block
    lanes = _group_args(jctx, geo)
    jm, jp, jump = jrd.group_subject_tables(
        jctx.sa_d, jctx.lcp_d, jctx.segid_d, jctx.tq_d,
        jnp.asarray(geo["segs"]), jnp.asarray(geo["starts"]),
        jnp.asarray(geo["thresholds"]), 0)
    ref = [np.asarray(x) for x in jrd.chain_anchors_device(
        jctx.isa_d, jctx.rm, jm, jp, jump,
        *(jnp.asarray(x) for x in lanes), ecap)]
    if route == "twin":
        _need_gxx()
        monkeypatch.setattr(rd, "chain_walk_flat", _twin_walk)
    if route == "tables":
        got = rd.subject_group_anchors_device(
            ctx.sa, ctx.lcp, ctx.segid, ctx.tq, ctx.isa, ctx.rm, ctx.text,
            geo["segs"], *lanes, ecap)
    else:
        got = rd.chain_anchors_device(
            ctx.isa, ctx.rm, ctx.text, torch.from_numpy(np.array(mlun)),
            torch.from_numpy(np.array(ps)), *lanes, ecap)
    assert len(got) == 7
    got = [x.numpy() for x in got]
    assert int(got[4]) == int(ref[4]) > 64
    assert bool(got[5]) == bool(ref[5]) == (ecap == 64)
    assert int(got[6]) > 0
    if not bool(ref[5]):
        lb = geo["sg"] * geo["gp"]
        streams = list(zip(_per_lane(ref, lb), _per_lane(got, lb)))
        assert sum(a.shape[1] for a, _ in streams) == int(ref[4])
        for a, b in streams:
            assert a.shape == b.shape and (a == b).all()


def _fam3():
    """The block fixture's 3 x 2500 bp family, as (name, bytes) pairs."""
    return [(s.name, s.data) for s in _family(3, 2500, [0.04, 0.35], 3)]


def _grids(fam):
    """Both packages' count grids on the joint schedule (one process,
    unsharded)."""
    n = len(fam)
    ref = jpipeline.calculate_matrix([Seq(d, nm) for nm, d in fam],
                                     Context(), backend=JaxBackend())
    got = tpipeline.calculate_matrix([TSeq(d, nm) for nm, d in fam],
                                     TContext(), [torch.device("cpu")])
    return [np.array([[M[i][j].counts for j in range(n)] for i in range(n)])
            for M in (ref, got)]


@pytest.fixture
def spies(monkeypatch):
    """Which walk and count paths each package takes: andix's
    ``_subject_group_counts_loop``, the port's segmented driver
    (``chain.segdrive``'s entry),
    ``chain_anchors_device`` (its ecap) and ``_loop_counts``."""
    from andix_torch.esa import backend as tbackend

    calls = {"jax_loop": 0, "segmented": [], "anchors": [], "loop": 0}
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED", "0")
    orig_jloop = JaxBackend._subject_group_counts_loop
    orig_seg = segdrive.segmented_group_anchors
    orig_anchors = tbackend.chain_anchors_device
    orig_loop = TorchBackend._loop_counts

    def jax_loop(self, *a, **kw):
        calls["jax_loop"] += 1
        return orig_jloop(self, *a, **kw)

    def seg(walk, sg, gp, qb, *rest):
        calls["segmented"].append(rest[-2])  # K
        return orig_seg(walk, sg, gp, qb, *rest)

    def anchors(*a):
        calls["anchors"].append(a[11])  # ecap
        return orig_anchors(*a)

    def loop(self, *a, **kw):
        calls["loop"] += 1
        return orig_loop(self, *a, **kw)

    monkeypatch.setattr(JaxBackend, "_subject_group_counts_loop", jax_loop)
    monkeypatch.setattr(segdrive, "segmented_group_anchors", seg)
    monkeypatch.setattr(tbackend, "chain_anchors_device", anchors)
    monkeypatch.setattr(TorchBackend, "_loop_counts", loop)
    return calls


def test_one_segment_takes_the_unsegmented_walk(spies, monkeypatch):
    """``ANDIX_CHAIN_SEGMENTS=1``: the group walks once, unsegmented, into
    one buffer of andix's default cap, and its grid is andix's."""
    monkeypatch.setenv("ANDIX_CHAIN_SEGMENTS", "1")
    ref, got = _grids(_fam3())
    assert (ref == got).all()
    assert spies["segmented"] == [] and spies["loop"] == 0
    assert spies["anchors"] == [1 << 16] and spies["jax_loop"] == 0


def test_cap_between_a_dispatch_and_the_group_takes_the_replay(
        block, spies, monkeypatch):
    """An event cap that holds every chunk dispatch of a segmented walk at
    K = 1 but not the group's total: andix walks K = 1 unsegmented into
    one buffer, which overflows, and counts in the loop; so does the
    port, with the same grid (a segmented driver at K = 1 would finish on
    the events path)."""
    jctx, mlun, ps, ctx, geo = block
    monkeypatch.setattr(segdrive, "CHUNK_ITERS", 4)
    per_dispatch = []
    mlun_t, ps_t = (torch.from_numpy(np.array(x)) for x in (mlun, ps))

    def walk(arr, chunk_iters, maxev):
        lanes = {n: torch.from_numpy(arr[n]) for n in rd.LANE_FIELDS}
        res = rd.fetch_walk(rd.chain_walk_flat(
            ctx.isa, ctx.rm, ctx.text, mlun_t, ps_t, lanes, chunk_iters,
            maxev, 1 << 20, 4, 4))
        per_dispatch.append(res[0].shape[1])
        return res

    res = segdrive.segmented_group_anchors(
        walk, geo["sg"], geo["gp"], jctx.tq_d.shape[0], geo["starts"],
        geo["rs_lens"], geo["thresholds"], jctx.q_base_h, jctx.q_start_h,
        geo["q_len2d"], 1, 1 << 20)
    total = res[1].shape[0]
    cap = max(per_dispatch)
    assert len(per_dispatch) > 2 and cap < total
    spies["segmented"].clear()

    monkeypatch.setenv("ANDIX_EVENT_CAP", str(cap))
    ref, got = _grids(_fam3())
    assert (ref == got).all()
    assert spies["jax_loop"] == 1 and spies["loop"] == 1
    assert spies["segmented"] == [] and spies["anchors"] == [cap]
