"""andix_torch's CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither jax
nor andix and uses no conftest fixture, so it runs on a machine with
the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(the CPU tests hold the plain versions, and the kernels' host twins, to
the JAX package)."""

import dataclasses

import numpy as np
import pytest
import torch

from andix_torch import bootstrap, ingest, kernels, subject_pipeline
from andix_torch.chain import evpack
from andix_torch.chain import replay_device as rd
from andix_torch.chain import walk_sx
from andix_torch.esa import doubling, joint, plcp, rmq, scans, subject_index
from andix_torch.esa.backend import TorchBackend, pad_symbols
from andix_torch.sequence import Seq, subject_init

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)

pytestmark = pytest.mark.cuda


def _cold_segments(qlen, k, thr):
    """A lane's K query segments as the segmented walk's first pass walks
    them (``andix``'s ``chain.segmented.plan_segments``, empty ones
    dropped): (end, entry) pairs, the first from the lane's start and the
    rest cold, with no anchor within the threshold's reach."""
    step = -(-qlen // k) if qlen > 0 else 1
    out = []
    for j in range(k):
        start, end = min(j * step, qlen), min((j + 1) * step, qlen)
        if end > start:
            qend = start - thr - 2
            out.append((end, (0, 0, 0, 0) if j == 0
                        else (start, qend, qend, 0)))
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 64, 333, 2048, 2049, 4095, 4096, 4097,
                               70001, (1 << 24) + 7])
@pytest.mark.parametrize("flags", ["all", "none", "random"])
@pytest.mark.parametrize("reverse", [False, True])
def test_flag_scan_kernel_equals_plain(cuda, n, flags, reverse):
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
    fl = {"all": torch.ones(n, dtype=torch.bool),
          "none": torch.zeros(n, dtype=torch.bool),
          "random": torch.from_numpy(rng.random(n) < 0.1)}[flags]
    sa = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    before = kernels.launches["flag_scan"]
    got = scans.flag_scan(vals.to(cuda), fl.to(cuda), sa.to(cuda),
                          reverse=reverse)
    assert kernels.launches["flag_scan"] == before + 1
    ref = scans.flag_scan(vals, fl, sa, reverse=reverse)  # CPU: plain
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def _scan_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)).to(
                device),
            torch.from_numpy(rng.random(n) < 0.1).to(device),
            torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(
                device))


@pytest.mark.parametrize("reverse", [False, True])
def test_flag_scan_publishes_every_tile(cuda, reverse):
    """After a launch every tile's status is inclusive, the counter has
    handed out every tile id, and each tile's inclusive prefix is the
    scan's state at its last position.  1025 tiles of 4096 positions, more
    than the card holds at once, so tiles wait in the look-back."""
    n = (1 << 22) + 7
    tile = 4096
    pad = (-n) % 16 if reverse else 0
    tiles = -(-(n + pad) // tile)
    status_ints = (tiles + 1 + 3) // 4 * 4
    scratch = scans.flag_scan_scratch(n, reverse, cuda)
    assert scratch.numel() == status_ints + 16 * tiles
    v, f, p = _scan_inputs(n, 5, cuda)
    got = scans._flag_scan_cuda(v, f, p, reverse, scratch)
    sc = scratch.cpu()
    assert (sc[:tiles] == 2).all() and int(sc[tiles]) == tiles
    incl = sc[status_ints + 8 * tiles:].view(tiles, 8)
    last = np.minimum(np.arange(1, tiles + 1) * tile - 1 - pad, n - 1)
    mem = torch.from_numpy(n - 1 - last if reverse else last)
    for field, out in zip((0, 2, 3, 4), got):
        assert torch.equal(incl[:, field], out.cpu()[mem])
    ref = scans.flag_scan(v.cpu(), f.cpu(), p.cpu(), reverse=reverse)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_flag_scan_twice_on_one_stream(cuda):
    """Two launches in a row on one stream, sharing one scratch buffer
    without a synchronize between them: each zeroes the status words
    first, so both come out right."""
    n = (1 << 20) + 3
    scratch = scans.flag_scan_scratch(n, True, cuda)
    first = _scan_inputs(n, 1, cuda)
    second = _scan_inputs(n, 2, cuda)
    got1 = scans._flag_scan_cuda(*first, True, scratch)
    got2 = scans._flag_scan_cuda(*second, True, scratch)
    for got, inp in ((got1, first), (got2, second)):
        ref = scans.flag_scan(*(x.cpu() for x in inp), reverse=True)
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


def _family():
    r = np.random.default_rng(3)
    base = NUCL[r.integers(0, 4, 3000)]
    seqs = [Seq(base, "g0")]
    for rate in (0.04, 0.35):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(3000) < rate
        seqs.append(Seq(NUCL[(codes + np.where(
            hit, r.integers(1, 4, 3000), 0)) % 4], f"g{len(seqs)}"))
    return seqs


def _family_lanes(device, k):
    """3 x 3000 bp family block, every lane cut into k cold segments."""
    subjects = [subject_init(s, 0.025) for s in _family()]
    be = TorchBackend(device)
    ctx = be.prepare_block(joint.build_block(
        {i: subjects[i].rs for i in range(3)}, {}))
    segs, starts, rs_lens, thr, q_len2d = be._group_tables(
        ctx, [0, 1, 2], dict(enumerate(subjects)))
    arr = {n: [] for n in rd.LANE_FIELDS}
    for s in range(3):
        for g in range(q_len2d.shape[1]):
            for en, entry in _cold_segments(int(q_len2d[s, g]), k,
                                            int(thr[s])):
                vals = (s, ctx.q_base_h[g], ctx.q_start_h[g], starts[s],
                        rs_lens[s], thr[s], en) + entry
                for name, v in zip(rd.LANE_FIELDS, vals):
                    arr[name].append(int(v))
    lanes = {n: torch.tensor(v, dtype=torch.int32, device=device)
             for n, v in arr.items()}
    mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                       segs, starts)
    return ctx, mlun, ps, lanes


def _per_lane(out, lb):
    cnt = min(int(out[4]), out[0].shape[0])
    ev = torch.stack([x[:cnt] for x in out[:4]]).cpu().numpy()
    order = np.argsort(ev[0], kind="stable")
    ev = ev[:, order]
    bounds = np.searchsorted(ev[0], np.arange(lb + 1))
    return [ev[1:, bounds[i]: bounds[i + 1]] for i in range(lb)]


@pytest.mark.parametrize("k,iters,maxev,ecap,chase,unroll", [
    (1, 1 << 28, 1 << 28, 1 << 15, 12, 4),
    (3, 1 << 28, 1 << 28, 1 << 15, 4, 4),
    (3, 16, 1, 1 << 15, 4, 4),
    (2, 7, 3, 1 << 15, 4, 1),
    (1, 1 << 28, 1 << 28, 64, 4, 4),
    (2, 1 << 28, 1 << 28, 50, 4, 4),  # ecap inside a staging batch
])
def test_walk_kernel_equals_plain(cuda, k, iters, maxev, ecap, chase,
                                  unroll):
    ctx, mlun, ps, lanes = _family_lanes(cuda, k)
    before = kernels.launches["chain_walk_flat"]
    got = rd.chain_walk_flat(ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                             iters, maxev, ecap, chase, unroll)
    assert kernels.launches["chain_walk_flat"] == before + 1
    ref = rd.chain_walk_flat_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                   lanes, iters, maxev, ecap, chase, unroll)
    for i in (4, 5, 6):  # ev_cnt, ovf, iters
        assert int(got[i]) == int(ref[i])
    for a, b in zip(got[7:], ref[7:]):  # pos, lq, ls, ll, fin
        assert torch.equal(a, b)
    lb = lanes["row"].shape[0]
    if not bool(ref[5]):
        for a, b in zip(_per_lane(got, lb), _per_lane(ref, lb)):
            assert a.shape == b.shape and (a == b).all()
    else:  # the buffer is full, each lane keeping a prefix of its chain
        whole = rd.chain_walk_flat_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                         lanes, iters, maxev, int(ref[4]),
                                         chase, unroll)
        kept = _per_lane(got, lb)
        assert sum(a.shape[1] for a in kept) == ecap
        for a, b in zip(kept, _per_lane(whole, lb)):
            assert (a == b[:, :a.shape[1]]).all()


@pytest.mark.parametrize("clonal", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_replay_kernel_equals_plain(cuda, clonal, exact):
    """The count-in-loop replay over every (subject, query) lane of the
    3 x 3000 bp family (and of a copy where g1 = g0): counts and the
    per-lane tallies equal the plain version's."""
    seqs = _family()
    if clonal:
        seqs[1] = Seq(seqs[0].data.copy(), "g1")
    subjects = [subject_init(s, 0.025) for s in seqs]
    be = TorchBackend(cuda)
    ctx = be.prepare_block(joint.build_block(
        {i: subjects[i].rs for i in range(3)}, {}))
    segs, starts, rs_lens, thr, q_len2d = be._group_tables(
        ctx, [0, 1, 2], dict(enumerate(subjects)))
    mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                       segs, starts)
    lanes = rd.replay_lanes(starts, rs_lens, thr, ctx.q_base_h,
                            ctx.q_start_h, q_len2d, cuda)
    before = kernels.launches["replay"]
    got = rd.replay_rows(ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, exact,
                         4)
    assert kernels.launches["replay"] == before + 1
    ref = rd.replay_rows_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                               exact, 4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("clonal", [False, True])
@pytest.mark.parametrize("segments", [1, 3, 8, 64])
def test_replay_kernel_splice_equals_twin(cuda, clonal, segments):
    """The two passes at K query segments a lane: counts and tallies equal
    the plain (unsegmented) version's, and counts, tallies and each
    lane's merges, fallbacks and repair steps equal the host twin's at
    the same K."""
    seqs = _family()
    if clonal:
        seqs[1] = Seq(seqs[0].data.copy(), "g1")
    subjects = [subject_init(s, 0.025) for s in seqs]
    be = TorchBackend(cuda)
    ctx = be.prepare_block(joint.build_block(
        {i: subjects[i].rs for i in range(3)}, {}))
    segs, starts, rs_lens, thr, q_len2d = be._group_tables(
        ctx, [0, 1, 2], dict(enumerate(subjects)))
    mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                       segs, starts)
    lanes = rd.replay_lanes(starts, rs_lens, thr, ctx.q_base_h,
                            ctx.q_start_h, q_len2d, cuda)
    assert rd.replay_segments(lanes["q_len"], 132) == 1  # 3 kbp queries
    host = [x.cpu() for x in (ctx.isa, ctx.text, mlun, ps)]
    rm_h = rmq.RangeMin(*(getattr(ctx.rm, f.name).cpu()
                          for f in dataclasses.fields(rmq.RangeMin)))
    lanes_h = {k: v.cpu() for k, v in lanes.items()}
    for exact in (False, True):
        splice, twin_splice = {}, {}
        got = rd.replay_rows(ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes,
                             exact, 4, segments=segments, splice=splice)
        twin = rd.replay_rows_cpu_twin(host[0], rm_h, host[1], host[2],
                                       host[3], lanes_h, exact, 4,
                                       segments=segments,
                                       splice=twin_splice)
        ref = rd.replay_rows_plain(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                   lanes, exact, 4)
        for a, b, c in zip(got, twin, ref):
            assert torch.equal(a.cpu(), b) and torch.equal(a, c)
        assert splice["segments"] == segments
        assert torch.equal(splice["lanes"].cpu(), twin_splice["lanes"])


def _sx_group(device, k, cache_k):
    """The 3 x 3000 bp family's subject index on ``device`` and its lanes
    cut into k cold segments."""
    seqs = _family()
    subjects = [subject_init(s, 0.025) for s in seqs]
    salcp, sw, cache2, nreal, _ = subject_pipeline._build_group_index(
        [0, 1, 2], subjects, cache_k, device, 1 << 34, 0)
    raw, q_off, qw_base = subject_pipeline._host_query_blob(seqs, 3)
    qw = subject_pipeline._pack_query_words(seqs, qw_base, device)
    arr = {n: [] for n in walk_sx.SX_LANE_FIELDS}
    for s in range(3):
        thr = int(subjects[s].threshold)
        for g in range(3):
            if g == s:
                continue
            for en, entry in _cold_segments(int(q_off[g + 1] - q_off[g]),
                                            k, thr):
                vals = (s, qw_base[g], subjects[s].len, thr, en) + entry
                for name, v in zip(walk_sx.SX_LANE_FIELDS, vals):
                    arr[name].append(int(v))
    lanes = {n: torch.tensor(v, dtype=torch.int32, device=device)
             for n, v in arr.items()}
    return (salcp, sw, cache2, nreal, qw), lanes


@pytest.mark.parametrize("k,iters,maxev,ecap,cache_k", [
    (1, 1 << 28, 1 << 28, 1 << 15, 8),
    (3, 1 << 28, 1 << 28, 1 << 15, 8),
    (3, 13, 1, 1 << 15, 8),
    (1, 1 << 28, 1 << 28, 8, 8),
    (2, 1 << 28, 1 << 28, 1 << 15, 2),
    # caps that stop lanes inside probes, and an event buffer ending inside
    # a 32-event staging batch
    (1, 8, 1 << 28, 1 << 15, 8),
    (1, 24, 1 << 28, 1 << 15, 8),
    (2, 56, 1 << 28, 1 << 15, 2),
    (1, 200, 1 << 28, 1 << 15, 8),
    (2, 1 << 28, 1 << 28, 50, 8),
])
def test_walk_sx_kernel_equals_plain(cuda, k, iters, maxev, ecap, cache_k):
    index, lanes = _sx_group(cuda, k, cache_k)
    before = kernels.launches["chain_walk_flat_sx"]
    got = walk_sx.chain_walk_flat_sx(*index, lanes, iters, maxev, cache_k,
                                     ecap)
    assert kernels.launches["chain_walk_flat_sx"] == before + 1
    ref = walk_sx.chain_walk_flat_sx_plain(*index, lanes, iters, maxev,
                                           cache_k, ecap)
    for i in (4, 5, 6):  # ev_cnt, ovf, iters
        assert int(got[i]) == int(ref[i])
    assert bool(got[5]) == (int(got[4]) > ecap)
    for a, b in zip(got[7:], ref[7:]):  # pos, lq, ls, ll, fin
        assert torch.equal(a, b)
    lb = lanes["row"].shape[0]
    if not bool(ref[5]):
        for a, b in zip(_per_lane(got, lb), _per_lane(ref, lb)):
            assert a.shape == b.shape and (a == b).all()
    else:  # the buffer is full, each lane keeping a prefix of its chain
        whole = walk_sx.chain_walk_flat_sx_plain(*index, lanes, iters, maxev,
                                                 cache_k, int(ref[4]))
        kept = _per_lane(got, lb)
        assert sum(a.shape[1] for a in kept) == ecap
        for a, b in zip(kept, _per_lane(whole, lb)):
            assert (a == b[:, :a.shape[1]]).all()


def test_subject_index_build_card_equals_cpu(cuda):
    subject = subject_init(_family()[1], 0.025)
    layout = joint.build_block({0: subject.rs}, {})
    sym = torch.from_numpy(pad_symbols(
        layout.sym, subject_pipeline.index_length(subject)))
    got = subject_index.build_subject_index(sym.to(cuda), layout.n, 8)
    ref = subject_index.build_subject_index(sym, layout.n, 8)
    sa, lcp, ovf, words, cache = (x.cpu() for x in got)
    assert torch.equal(sa, ref[0])
    assert torch.equal(lcp[: layout.n], ref[1][: layout.n])
    assert not ovf and not ref[2]
    assert torch.equal(words, ref[3]) and torch.equal(cache, ref[4])


def _plcp_block(device, clonal):
    """The 3 x 3000 bp family's joint text on ``device`` (g1 = g0 when
    ``clonal``), its SA and full level buffer, and the base width."""
    seqs = _family()
    if clonal:
        seqs[1] = Seq(seqs[0].data.copy(), "g1")
    subjects = [subject_init(s, 0.025) for s in seqs]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    padded = -(-layout.n // 1024) * 1024
    sym = torch.from_numpy(pad_symbols(layout.sym, padded)).to(device)
    base = doubling.wide_base_width(3, True)
    L = doubling.levels_needed(padded, True, base)
    sa, levels, lev_count, ovf = doubling.sa_loop(sym, True, L, base)
    assert not ovf
    return sym, sa, levels, lev_count, base


@pytest.mark.parametrize("clonal", [False, True])
@pytest.mark.parametrize("rows", ["all", 2, 0])
def test_plcp_kernel_equals_plain(cuda, clonal, rows):
    """The sampled-PLCP kernels == the plain version (LCP and overflow
    flag), with every level row and with the top rows cut, where the
    clonal pair's 6 kbp LCPs leave entries open."""
    sym, sa, levels, lev_count, base = _plcp_block(cuda, clonal)
    k = lev_count if rows == "all" else min(rows, lev_count)
    lev = levels[: max(k, 1)]
    got = plcp.plcp_lcp_hybrid(sym, sa, lev, k, base)
    ref = plcp.plcp_lcp_hybrid_plain(sym, sa, lev, k, base)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    assert bool(got[1]) == bool(ref[1]) == (clonal and rows != "all")


def _clonal_block(device, length, seed=17):
    """Two identical genomes of ``length`` bp as one joint block on
    ``device``: (sym, base width)."""
    rng = np.random.default_rng(seed)
    data = NUCL[rng.integers(0, 4, length)]
    subjects = [subject_init(Seq(data.copy(), f"g{i}"), 0.025)
                for i in range(2)]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    padded = -(-layout.n // 1024) * 1024
    sym = torch.from_numpy(pad_symbols(layout.sym, padded)).to(device)
    return sym, doubling.wide_base_width(2, True)


@pytest.mark.parametrize("rows", [0, 1, 14, "all"])
def test_plcp_kernel_with_rows_cut(cuda, rows):
    """A clonal pair of 120 kbp (adjacent LCPs of 240 kbp, 15 level rows
    from width 12) with 0, 1, 14 and every row: the kernels == the plain
    version, LCP and flag; entries stay open exactly when rows are cut."""
    sym, base = _clonal_block(cuda, 120_000)
    L = doubling.levels_needed(sym.shape[0], True, base)
    sa, levels, cnt, ovf = doubling.sa_loop(sym, True, L, base)
    assert not ovf and cnt > 14
    k = cnt if rows == "all" else rows
    lev = levels[: max(k, 1)]
    before = kernels.launches["plcp_lcp_hybrid"]
    got = plcp.plcp_lcp_hybrid(sym, sa, lev, k, base)
    assert kernels.launches["plcp_lcp_hybrid"] == before + 1
    ref = plcp.plcp_lcp_hybrid_plain(sym, sa, lev, k, base)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    assert bool(got[1]) == bool(ref[1]) == (rows != "all")


@pytest.mark.parametrize("n", [1 << 20, (1 << 24) + 512])
def test_plcp_kernel_large(cuda, n):
    """A random 2-genome block text padded to n: the kernels == the plain
    version, with every level row, at the 8 x 1 Mbp block's size and
    past it."""
    rng = np.random.default_rng(n)
    half = (n - 64) // 4
    subjects = [subject_init(Seq(NUCL[rng.integers(0, 4, half)], f"g{i}"),
                             0.025) for i in range(2)]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    sym = torch.from_numpy(pad_symbols(layout.sym, n)).to(cuda)
    base = doubling.wide_base_width(2, True)
    L = doubling.levels_needed(n, True, base)
    sa, levels, cnt, _ = doubling.sa_loop(sym, True, L, base)
    got = plcp.plcp_lcp_hybrid(sym, sa, levels, cnt, base)
    ref = plcp.plcp_lcp_hybrid_plain(sym, sa, levels, cnt, base)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and not bool(got[1])
    assert not bool(ref[1])


@pytest.mark.parametrize("n", [1, 7, 512, 513, 4097, 70000, 1 << 20,
                               (1 << 24) + 512])
def test_range_min_kernel_equals_plain(cuda, n):
    """The range-min kernel's arrays == the plain build's, every one, on
    values with runs of INF and of one value; one launch counted."""
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    for start in rng.integers(0, n, 8):
        vals[start: start + int(rng.integers(1, 2000))] = 2**31 - 1
    for start in rng.integers(0, n, 8):
        vals[start: start + int(rng.integers(1, 2000))] = 5
    v = torch.from_numpy(vals).to(cuda)
    before = kernels.launches["range_min_build"]
    got = rmq.build(v)
    assert kernels.launches["range_min_build"] == before + 1
    ref = rmq.build_plain(v)
    torch.cuda.synchronize()
    for name in ("values", "pref8", "suff8", "t8", "prefg", "suffg", "tg"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.device == v.device and torch.equal(a, b), name


def test_range_min_kernel_twice_on_one_stream(cuda):
    """Two builds in a row on one stream without a synchronize, the
    second over a view that starts off a 16-byte boundary (the wrapper
    copies it): both == the plain build."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(0, 50, 70001).astype(np.int32)).to(
        cuda)
    b = a[1:]
    got = [rmq.build(a), rmq.build(b)]
    for g, x in zip(got, (a, b)):
        ref = rmq.build_plain(x.contiguous())
        for name in ("values", "pref8", "suff8", "t8", "prefg", "suffg",
                     "tg"):
            assert torch.equal(getattr(g, name), getattr(ref, name)), name


def test_plcp_kernel_keeps_every_row(cuda):
    """Two identical 60 kbp genomes: with the level rows the text needs,
    more than andix's 14-row hybrid cap, the card's build takes its LCP
    from the kernel, with no overflow, equal to the host Φ LCP."""
    from andix_torch import native

    rng = np.random.default_rng(91)
    data = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60_000)]
    subjects = [subject_init(Seq(data.copy(), f"g{i}"), 0.025)
                for i in range(2)]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    padded = -(-layout.n // 1024) * 1024
    sym = torch.from_numpy(pad_symbols(layout.sym, padded))
    base = doubling.wide_base_width(2, True)
    counts = []
    sa, lcp, ovf, _ = doubling.sa_lcp_device(
        sym.to(cuda), True, lcp_mode="hybrid", base_width=base,
        on_sa=lambda c, L: counts.append((c, L)))
    assert not bool(ovf) and counts[0][1] > 14
    host = native.lcp_from_sa(sym.numpy(), sa.cpu().numpy(), 2)
    assert (lcp.cpu().numpy()[1:layout.n] == host[1:layout.n]).all()


def test_sa_lcp_card_equals_cpu(cuda):
    """The whole build, hybrid mode, on the card and on the CPU."""
    sym, *_ = _plcp_block(torch.device("cpu"), False)
    base = doubling.wide_base_width(3, True)
    got = doubling.sa_lcp_device(sym.to(cuda), True, lcp_mode="hybrid",
                                 base_width=base)
    ref = doubling.sa_lcp_device(sym, True, lcp_mode="hybrid",
                                 base_width=base)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a.cpu(), b)


def test_wrappers_refuse_bad_inputs(cuda):
    v = torch.zeros(8, dtype=torch.int32, device=cuda)
    f = torch.zeros(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        scans.flag_scan(v, f, v.to(torch.int64))
    with pytest.raises(ValueError):
        scans.flag_scan(v, f, v[:4])
    with pytest.raises(ValueError):
        scans.flag_scan(v, f.cpu(), v)
    with pytest.raises(ValueError):  # 4 bytes off a 16-byte boundary
        scans.flag_scan(torch.zeros(9, dtype=torch.int32, device=cuda)[1:],
                        f, v)
    z = torch.zeros(32, dtype=torch.int32, device=cuda)
    for bad in ((z[:24], z[:24], z[:24].view(1, 24)),  # not 16 | n
                (z, z.cpu(), z.view(1, 32)),
                (z, z, z.view(1, 32).to(torch.int64)),
                (z, z[:16], z.view(2, 16))):
        with pytest.raises(ValueError):
            plcp.plcp_lcp_hybrid(*bad, 1, 4)
    off = torch.zeros(33, dtype=torch.int32, device=cuda)[1:]  # 4 B off 16
    with pytest.raises(ValueError):
        plcp.plcp_lcp_hybrid(off, z, z.view(1, 32), 1, 4)
    index, lanes = _sx_group(cuda, 1, 2)
    for bad in (dict(lanes, row=lanes["row"].cpu()),
                dict(lanes, pos0=lanes["pos0"][:1])):
        with pytest.raises(ValueError):
            walk_sx.chain_walk_flat_sx(*index, bad, 8, 8, 2, 64)
    with pytest.raises(ValueError):  # cache rows do not fit cache_k
        walk_sx.chain_walk_flat_sx(*index, lanes, 8, 8, 3, 64)
    ctx, mlun, ps, lanes = _family_lanes(cuda, 1)
    odd = torch.zeros(mlun.numel() + 1, dtype=torch.int32, device=cuda)
    odd = odd[1:].view(mlun.shape)  # contiguous, 4 bytes off 16
    for bad in (dict(mlun=odd), dict(text=ctx.text.to(torch.int32)),
                dict(text=ctx.text.cpu())):
        args = dict(mlun=mlun, ps=ps, text=ctx.text) | bad
        with pytest.raises(ValueError):
            rd.chain_walk_flat(ctx.isa, ctx.rm, args["text"], args["mlun"],
                               args["ps"], lanes, 8, 8, 64, 4, 4)


def _grid(M, n):
    return np.array([[M[i][j].counts for j in range(n)] for i in range(n)])


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_two_workers_on_one_card_equal_one(cuda, monkeypatch, schedule):
    """Two workers sharing the card (the sharded joint grid, or two
    subject-index workers) give the one-worker grid and the CPU's, and the
    card launched the schedule's kernels."""
    from andix_torch import pipeline
    from andix_torch.runtime import Context

    monkeypatch.setenv("ANDIX_INDEX", schedule)
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "2")
    seqs = _family()

    def grid(devices):
        return _grid(pipeline.calculate_matrix(seqs, Context(), devices), 3)

    one = grid([cuda])
    kernels.reset_launches()
    two = grid([cuda, cuda])
    card = kernels.launches_by_card[cuda.index]
    lines = list(pipeline.LAST_BALANCE if schedule == "joint"
                 else subject_pipeline.LAST_BALANCE)
    assert (two == one).all()
    assert (one == grid([torch.device("cpu")])).all()
    names = (["flag_scan", "chain_walk_flat"] if schedule == "joint"
             else ["chain_walk_flat_sx"])
    assert all(card[name] > 0 for name in names), card
    assert any(ln.startswith(f"worker 1 on {cuda}") for ln in lines), lines


def test_wrappers_launch_on_the_workers_card(cuda):
    """Every card at once, each from a worker thread of its own that never
    sets a current device: each wrapper's output lands on that card, equals
    its plain version, and counts on that card."""
    from andix_torch import parallel

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")

    def check(d):
        dev = torch.device("cuda", d)
        scan_in = _scan_inputs(70001, d, dev)
        ctx, mlun, ps, lanes = _family_lanes(dev, 2)
        index, sx_lanes = _sx_group(dev, 2, 8)
        before = dict(kernels.launches_by_card.get(d, {}))
        got_scan = scans.flag_scan(*scan_in)
        got_walk = rd.chain_walk_flat(ctx.isa, ctx.rm, ctx.text, mlun, ps,
                                      lanes, 1 << 28, 1 << 28, 1 << 15, 4, 4)
        got_sx = walk_sx.chain_walk_flat_sx(*index, sx_lanes, 1 << 28,
                                            1 << 28, 8, 1 << 15)
        after = dict(kernels.launches_by_card[d])
        assert all(after[name] == before.get(name, 0) + 1
                   for name in ("flag_scan", "chain_walk_flat",
                                "chain_walk_flat_sx")), (before, after)
        ref = scans.flag_scan(*(x.cpu() for x in scan_in))
        for a, b in zip(got_scan, ref):
            assert a.device == dev and torch.equal(a.cpu(), b)
        walks = [
            (got_walk, rd.chain_walk_flat_plain(
                ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, 1 << 28, 1 << 28,
                1 << 15, 4, 4), lanes["row"].shape[0]),
            (got_sx, walk_sx.chain_walk_flat_sx_plain(
                *index, sx_lanes, 1 << 28, 1 << 28, 8, 1 << 15),
             sx_lanes["row"].shape[0]),
        ]
        for got, ref, lb in walks:
            assert all(x.device == dev for x in got[:4] + got[7:])
            assert [int(got[i]) for i in (4, 5, 6)] == [int(ref[i])
                                                       for i in (4, 5, 6)]
            for a, b in zip(got[7:], ref[7:]):
                assert torch.equal(a, b)
            for a, b in zip(_per_lane(got, lb), _per_lane(ref, lb)):
                assert a.shape == b.shape and (a == b).all()

    parallel.run_workers([lambda d=d: check(d) for d in range(count)])


def test_chain_anchors_device_card_equals_cpu(cuda):
    """The unsegmented events walk (the flat walk kernel, one lane a
    pair, no iteration cap) on the card: the event count, the overflow
    flag and each lane's stream equal the plain walk's on the CPU, with a
    buffer that holds the walk and one that overflows."""
    seqs = _family()
    subjects = [subject_init(s, 0.025) for s in seqs]
    out, lanes = {}, 0
    for dev in (cuda, torch.device("cpu")):
        be = TorchBackend(dev)
        ctx = be.prepare_block(joint.build_block(
            {i: subjects[i].rs for i in range(3)}, {}))
        segs, starts, rs_lens, thr, q_len2d = be._group_tables(
            ctx, [0, 1, 2], dict(enumerate(subjects)))
        mlun, ps = rd.group_subject_tables(ctx.sa, ctx.lcp, ctx.segid,
                                           ctx.tq, segs, starts)
        lanes = q_len2d.size
        for ecap in (1 << 16, 50):
            before = kernels.launches["chain_walk_flat"]
            got = rd.chain_anchors_device(
                ctx.isa, ctx.rm, ctx.text, mlun, ps, starts, rs_lens, thr,
                ctx.q_base_h, ctx.q_start_h, q_len2d, ecap)
            assert kernels.launches["chain_walk_flat"] == before + (
                dev.type == "cuda")
            out[dev.type, ecap] = [x.cpu() for x in got]
    for ecap in (1 << 16, 50):
        a, b = out["cuda", ecap], out["cpu", ecap]
        assert int(a[4]) == int(b[4]) > 50
        assert bool(a[5]) == bool(b[5]) == (ecap == 50)
        if ecap > 50:
            for x, y in zip(_per_lane(a, lanes), _per_lane(b, lanes)):
                assert x.shape == y.shape and (x == y).all()


def _event_stream(cnt, n_lanes, seed, esc_frac):
    """Walk-like events in interleaved lanes (each lane's q ascending):
    large first positions escape, and a share ``esc_frac`` of long
    anchors and of diagonal jumps."""
    rng = np.random.default_rng(seed)
    lane = rng.integers(0, n_lanes, cnt).astype(np.int64)
    ln = rng.integers(20, 400, cnt)
    ln[rng.random(cnt) < esc_frac] = 70_000
    q = np.zeros(cnt, np.int64)
    s = np.zeros(cnt, np.int64)
    for k in range(n_lanes):
        sel = np.nonzero(lane == k)[0]
        step = ln[sel] + 1 + rng.integers(0, 300, len(sel))
        q[sel] = rng.integers(0, 200_000) + np.cumsum(step) - step
        jump = np.where(rng.random(len(sel)) < esc_frac,
                        rng.integers(-60_000, 60_000, len(sel)), 0)
        s[sel] = np.maximum(q[sel] + rng.integers(-5000, 5000)
                            + np.cumsum(jump), 0)
    return np.stack([lane, q, s, ln]).astype(np.int32)


def _sorted_events(runs, esc_at, seed):
    """Events whose lane-major order is known (tests/test_torch_evpack.py's
    ``_runs``): lane l holds runs[l] events in chain order, and exactly
    those at the sorted positions ``esc_at`` escape (a diagonal jump of
    40,000); the buffer interleaves the lanes."""
    rng = np.random.default_rng(seed)
    esc = np.zeros(sum(runs), bool)
    esc[list(esc_at)] = True
    lane = np.repeat(np.arange(len(runs)), runs)
    ln = rng.integers(10, 300, len(lane))
    step = ln + 1 + rng.integers(0, 200, len(lane))
    q, s = np.zeros(len(lane), np.int64), np.zeros(len(lane), np.int64)
    start = np.cumsum(runs) - runs
    for k, run in enumerate(runs):
        sel = slice(start[k], start[k] + run)
        q[sel] = rng.integers(0, 60_000) + np.cumsum(step[sel]) - step[sel]
        s[sel] = q[sel] + rng.integers(0, 30_000) + 40_000 * np.cumsum(
            esc[sel])
    arr = np.stack([lane, q, s, ln]).astype(np.int32)
    buf = arr[:, rng.permutation(arr.shape[1])]
    for k in range(len(runs)):
        buf[1:, buf[0] == k] = arr[1:, arr[0] == k]
    return buf


# sorted positions: the encode kernel's tile of 2048 and the twin's of 8
_EV_TILE, _EV_TINY = 2048, 8
_EVENT_STREAMS = {
    "edges": lambda: _sorted_events([100] * 60 + [0] * 4, [
        7, 8, 15, 16, _EV_TILE - 1, _EV_TILE, 2 * _EV_TILE - 1,
        2 * _EV_TILE, 2 * _EV_TILE + 1, 5999], 21),
    "escape_tile": lambda: _sorted_events(
        [625] * 8, list(range(8, 16)) + list(range(_EV_TILE, 2 * _EV_TILE)),
        22),
    "esc_cap": lambda: _sorted_events([750] * 8, np.random.default_rng(
        23).choice(6000, 4096, replace=False), 23),
    "esc_cap_plus1": lambda: _sorted_events([750] * 8, np.random.default_rng(
        24).choice(6000, 4097, replace=False), 23),
    "empty_lanes": lambda: _sorted_events(
        [0, 0] + [50] * 15 + [0] * 4 + [50] * 16 + [0] * 3,
        [0, 49, 50, 700, 1549], 24),
}


@pytest.mark.parametrize("stream,cnt,k,n_lanes", [
    ("random", 0, 4096, 64), ("random", 1, 7, 8), ("random", 3000, 4096, 64),
    ("random", 3001, 3001, 64),
    ("random", 5000, 6144, 4),  # more escapes than esc_cap = 4096
    ("random", 650_000, 786_432, 512), ("random", 1_000_001, 1_000_001, 8192),
    # the largest 8 x 5 Mbp subject dispatch's shape
    ("random", 1_274_839, 1_572_864, 8192),
    # more lanes than a 48 KB shared histogram's 12,288 bins
    ("random", 200_000, 262_144, 20_000),
    ("edges", 6000, 8192, 64), ("edges", 6000, 6001, 64),
    ("escape_tile", 5000, 8192, 8), ("esc_cap", 6000, 8192, 8),
    ("esc_cap_plus1", 6000, 8192, 8), ("empty_lanes", 1550, 2048, 40)])
def test_evpack_kernel_equals_twin_and_plain(cuda, stream, cnt, k, n_lanes):
    """The packed-fetch kernels' one output buffer (packed fields, escape
    records, per-lane counts, n_esc and the overflow flag) equals the host
    twin's and the plain version's exactly, garbage past cnt, odd k, an
    escape overflow, escapes across tile edges, a tile of escapes, exactly
    esc_cap escapes and one more, empty lanes and 20,000 lanes
    included."""
    if stream == "random":
        ev = _event_stream(cnt, n_lanes, cnt,
                           0.9 if n_lanes == 4 else 0.001)
    else:
        ev = _EVENT_STREAMS[stream]()
    rng = np.random.default_rng(k)
    buf = rng.integers(-2**31, 2**31, (4, k + 3)).astype(np.int32)
    buf[:, :cnt] = ev
    host = [torch.from_numpy(x.copy()) for x in buf]
    before = kernels.launches["evpack_encode"]
    got = evpack.encode_events_flat(*(x.to(cuda) for x in host), cnt, k,
                                    n_lanes)
    assert kernels.launches["evpack_encode"] == before + 1
    twin = evpack.encode_events_cpu_twin(*host, cnt, k, n_lanes)
    plain = evpack.encode_events_plain(*host, cnt, k, n_lanes)
    assert torch.equal(got.cpu(), twin) and torch.equal(twin, plain)
    _, _, counts, n_esc, esc_ovf = evpack.split_encoded(plain, k, n_lanes)
    assert int(counts.sum()) == cnt
    assert bool(esc_ovf) == (n_lanes == 4 or stream == "esc_cap_plus1")
    if stream.startswith("esc_cap"):
        assert int(n_esc) == 4096 + stream.endswith("plus1")
    if not bool(esc_ovf):
        packed, esc, counts, n_esc, _ = evpack.split_encoded(got.cpu(), k,
                                                             n_lanes)
        dec = evpack.decode_events(packed.numpy(), esc.numpy(),
                                   counts.numpy(), int(n_esc), cnt)
        order = np.argsort(ev[0], kind="stable")
        for a, b in zip(dec, ev[:, order]):
            assert (a == b).all()


@pytest.mark.parametrize("pairs,rounds,seed", [
    (40, 1, 0), (40, 200, 7), (40, 1000, 2**33 + 5), (40, 31, 1),
    (40, 33, 2), (406, 33, 3), (406, 1000, 4)])
def test_bootstrap_kernel_equals_twin_and_plain(cuda, pairs, rounds, seed):
    """The resampler kernel draws the host twin's counts exactly (the same
    Philox words and float64 operations, a warp a pair's 32 rounds, tail
    lanes masked), and the plain version's on the card; totals kept (one
    near 2^52), the zero pair zero, a lone cell whole."""
    rng = np.random.default_rng(seed % 1000)
    counts = rng.integers(0, 60_000, (pairs, 16)) * (
        rng.random((pairs, 16)) < 0.5)
    counts[3] = 0
    counts[4] = 0
    counts[4, 9] = 77
    counts[5, :4] = [3, 1, 0, 2]
    counts[6, 0] = (1 << 25) + 3
    counts[7, [0, 5, 10]] = [(1 << 52) - (1 << 41) - 12_346, 1 << 41,
                             12_345]
    host = torch.from_numpy(counts.astype(np.int64))
    before = kernels.launches["bootstrap_resample"]
    got = bootstrap.resample(host.to(cuda), rounds, seed)
    assert kernels.launches["bootstrap_resample"] == before + 1
    twin = bootstrap.resample_cpu_twin(host, rounds, seed)
    assert torch.equal(got.cpu(), twin)
    assert torch.equal(bootstrap.resample_plain(host.to(cuda), rounds,
                                                seed).cpu(), twin)
    assert (twin.sum(dim=2) == host.sum(dim=1)[None]).all()
    assert (twin[:, 3] == 0).all() and (twin[:, 4, 9] == 77).all()


def _sa_text(kind, n, seed=3):
    """(int32 text, packed, base) for the doubling kernels: random DNA
    (width 1), padded DNA (the clamped key, or the dense-code key at
    ``wide<b>``), or a joint block of three genomes with separators and
    padding (``family``; ``clonal``: g1 = g0)."""
    rng = np.random.default_rng(seed)
    dna = NUCL[rng.integers(0, 4, n)]
    if kind == "dna":
        return torch.from_numpy(dna.astype(np.int32)), False, 1
    if kind == "clamped":
        return torch.from_numpy(pad_symbols(dna.astype(np.int32), n + 3)), \
            True, 4
    if kind.startswith("wide"):  # padded to 16 | n for the PLCP kernel
        return torch.from_numpy(pad_symbols(dna.astype(np.int32),
                                            (n + 5 + 15) // 16 * 16)), \
            True, int(kind[4:])
    seqs = [Seq(dna, "g0"), Seq(dna.copy() if kind == "clonal" else
                                NUCL[rng.integers(0, 4, n)], "g1"),
            Seq(NUCL[rng.integers(0, 4, n)], "g2")]
    subjects = [subject_init(s, 0.025) for s in seqs]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)},
                               {})
    padded = -(-layout.n // 1024) * 1024
    return (torch.from_numpy(pad_symbols(layout.sym, padded)), True,
            doubling.wide_base_width(3, True))


@pytest.mark.parametrize("mode,base", [(0, 1), (1, 4)]
                         + [(2, b) for b in range(5, 13)])
def test_sa_keys_initial_kernel_equals_plain(cuda, mode, base):
    """sa_keys' initial modes == ``_initial_keys_plain``, bit for bit, on a
    joint text with separators and padding (block size 2^16 + 5)."""
    sym, _, _ = _sa_text("family", 20_000)
    sym = torch.cat([sym, sym[-5:] + 5])  # one more padded block edge
    n = sym.shape[0]
    before = kernels.launches["sa_keys"]
    got, vals = doubling.Kernels().keys(mode, sym.to(cuda), None, n,
                                        base=base)
    assert kernels.launches["sa_keys"] == before + 1
    ref = doubling._initial_keys_plain(sym, mode > 0, base)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(vals.cpu(), torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 2, 2047, 2049, (1 << 20) + 3])
@pytest.mark.parametrize("tail", [False, True])
def test_sa_keys_round_kernel_equals_plain(cuda, n, tail):
    """sa_keys' full and tail modes == the plain key rank[i] (n + 1) +
    rank[i + k] + 1 (0 past the end), at i = every suffix or the given
    suffixes (whose heads rank[i] the tail reads beside them), for k
    below and above n / 2 and k = 3 (off the 16-byte grid); each entry's
    suffix i as its sort value; the tail's part counts == a bincount."""
    rng = np.random.default_rng(n)
    rank = rng.integers(0, n, n).astype(np.int32)
    vals = (rng.permutation(n)[: max(1, n // 3)] if tail
            else np.arange(n)).astype(np.int32)
    for k in (1, 3, max(1, n // 2 + 1), n):
        i = vals.astype(np.int64)
        r2 = np.where(i + k < n, rank[np.minimum(i + k, n - 1)].astype(
            np.int64) + 1, 0)
        ref = rank[i].astype(np.int64) * (n + 1) + r2
        plan = doubling._scatter_plan(n, len(vals), True, 5)
        hist = torch.empty(plan[1], dtype=torch.int32, device=cuda)
        got, sfx = doubling.Kernels().keys(
            doubling._KEY_TAIL if tail else doubling._KEY_FULL,
            torch.from_numpy(rank).to(cuda),
            torch.from_numpy(vals).to(cuda) if tail else None, len(vals), k,
            heads=torch.from_numpy(rank[vals]).to(cuda) if tail else None,
            hist=hist if tail else None, plan=plan)
        assert (got.cpu().numpy() == ref).all()
        assert (sfx.cpu().numpy() == vals).all()
        if tail:
            assert (hist.cpu().numpy() == np.bincount(
                vals >> plan[0], minlength=plan[1])).all()


def test_sa_keys_full_kernel_unaligned_rank(cuda):
    """The full key kernel over a rank that starts off the 16-byte grid
    (its scalar path) == over an aligned copy."""
    n = (1 << 16) + 5
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.integers(0, n, n + 1).astype(np.int32))
    rank = base.to(cuda)[1:]
    assert rank.data_ptr() % 16
    for k in (1, 4, 7, 2049):
        got = doubling.Kernels().keys(doubling._KEY_FULL, rank, None, n, k)
        ref = doubling.Kernels().keys(doubling._KEY_FULL, rank.clone(), None,
                                      n, k)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _round_equal(got, ref):
    """(rank, tied, sa) of a round on the card and plain on the CPU: the
    ranks, the count and the heads in SA order (the order inside a tied
    group is the sort's)."""
    rank, tied, sa = (x.cpu() if torch.is_tensor(x) else x for x in got)
    assert tied == ref[1]
    assert torch.equal(rank, ref[0])
    assert torch.equal(rank[sa.long()], ref[0][ref[2].long()])


@pytest.mark.parametrize("kind,n", [("dna", 2049), ("clamped", 70_001),
                                    ("wide6", 70_001), ("clonal", 3000),
                                    ("dna", (1 << 22) + 1)])
def test_sa_rerank_kernel_equals_plain(cuda, kind, n):
    """sa_rerank in each mode (full: the initial ranks and a full round;
    extract; tail, twice) == the plain steps from the same inputs.  Width-1
    DNA at 2^22 + 1 gives four groups of about a million entries each, so
    the heads cross hundreds of tiles through the look-back."""
    sym, packed, base = _sa_text(kind, n)
    before = kernels.launches["sa_rerank"]
    got = doubling._initial_ranks(sym.to(cuda), packed, base)
    ref = doubling._initial_ranks(sym, packed, base)
    assert kernels.launches["sa_rerank"] == before + 1
    _round_equal(got, ref)
    rank, _, sa = ref
    k = base
    got = doubling._doubling_round(rank.to(cuda), sa.to(cuda), k)
    ref = doubling._doubling_round(rank.clone(), sa.clone(), k)
    _round_equal(got, ref)
    rank, tied, sa = ref
    k *= 2
    assert tied > 0
    r_c, s_c = rank.to(cuda), sa.to(cuda)
    kern = doubling.Kernels()
    slots, sa_vals = doubling._extract_tied(
        r_c, s_c, tied, kern, doubling.changed_bits_plain(r_c, s_c))
    p_slots, p_vals = doubling._extract_tied(rank, sa, tied)
    assert torch.equal(slots.cpu().long(), p_slots)
    assert torch.equal(sa_vals.cpu(), p_vals)
    assert torch.equal(kern.heads.cpu(), rank[p_vals.long()])
    for _ in range(2):
        t_c, slots, sa_vals = doubling._bucketed_round(r_c, s_c, slots,
                                                       sa_vals, k, kern)
        t_p, p_slots, p_vals = doubling._bucketed_round(rank, sa, p_slots,
                                                        p_vals, k)
        assert t_c == t_p
        assert torch.equal(r_c.cpu(), rank)
        assert torch.equal(rank[s_c.cpu().long()], rank[sa.long()])
        assert torch.equal(slots.cpu().long(), p_slots)
        assert torch.equal(rank[sa_vals.cpu().long()], rank[p_vals.long()])
        k *= 2
        if not t_c:
            break


@pytest.mark.parametrize("kind,n", [("dna", 1), ("dna", 3), ("dna", 2049),
                                    ("clamped", 4095), ("wide9", 100_003),
                                    ("family", 20_000), ("clonal", 20_000)])
def test_sa_loop_card_equals_plain(cuda, kind, n):
    """The whole loop on the card (every key and rerank by the kernels) ==
    the plain version on the CPU and on the card: SA, the level rows, the
    count and the flag, also with the budget cut to 2 rows."""
    sym, packed, base = _sa_text(kind, n)
    for L in (doubling.levels_needed(sym.shape[0], packed, base), 2):
        kernels.reset_launches()
        got = doubling.sa_loop(sym.to(cuda), packed, L, base)
        launched = dict(kernels.launches)
        for ref in (doubling.sa_loop(sym, packed, L, base),
                    doubling.sa_loop_plain(sym.to(cuda), packed, L, base)):
            assert got[2:] == ref[2:] and len(got[1]) == len(ref[1])
            assert torch.equal(got[0].cpu(), ref[0].cpu())
            for a, b in zip(got[1], ref[1]):
                assert torch.equal(a.cpu(), b.cpu())
        assert launched["sa_keys"] > 0 and launched["sa_rerank"] > 0


@pytest.mark.parametrize("kind,n", [("dna", 70_001), ("wide9", 100_003),
                                    ("family", 20_000), ("clonal", 20_000),
                                    ("dna", (1 << 22) + 1)])
@pytest.mark.parametrize("parts", [0, 1, 7, 300])
def test_sa_loop_partitioned_card_equals_plain(cuda, kind, n, parts):
    """The loop on the card with the rank scatter forced into at most
    ``parts`` parts in every round, full and tail (0: the direct scatter
    throughout): SA, the level rows, the count, the flag and each round's
    tied count == the plain version's on the CPU; the pair scatter
    launches in every partitioned round."""
    sym, packed, base = _sa_text(kind, n)
    L = doubling.levels_needed(sym.shape[0], packed, base)
    kernels.reset_launches()
    trace = []
    got = doubling.sa_loop(sym.to(cuda), packed, L, base,
                           doubling.Kernels(parts=parts, trace=trace))
    ref_trace = []
    ref = doubling.sa_loop(sym, packed, L, base,
                           doubling.Kernels(twin=True, trace=ref_trace))
    plain = doubling.sa_loop(sym, packed, L, base)
    for r in (ref, plain):
        assert got[2:] == r[2:] and len(got[1]) == len(r[1])
        assert torch.equal(got[0].cpu(), r[0])
        for a, b in zip(got[1], r[1]):
            assert torch.equal(a.cpu(), b)
    assert [(r["kind"], r["entries"], r["tied"]) for r in trace] == \
        [(r["kind"], r["entries"], r["tied"]) for r in ref_trace]
    rounds = sum(r["kind"] != "extract" for r in trace)
    assert kernels.launches["sa_pair_scatter"] == (rounds if parts else 0)


@pytest.mark.parametrize("kind,n,rounds", [("dna", (1 << 20) + 3, 0),
                                           ("clonal", 30_000, 2)])
def test_sa_rerank_bits_and_extract_card(cuda, kind, n, rounds):
    """A full rerank on the card leaves the changed bits of its ranks and
    SA (``changed_bits_plain``), and the extract from them == the plain
    extract, with heads == rank[suffix]."""
    sym, packed, base = _sa_text(kind, n)
    rank, tied, sa = doubling._initial_ranks(sym, packed, base)
    k = base
    for _ in range(rounds):
        rank, tied, sa = doubling._doubling_round(rank, sa, k)
        k *= 2
    kern = doubling.Kernels()
    r, tied, s = doubling._doubling_round(rank.to(cuda), sa.to(cuda), k,
                                          kern)
    assert torch.equal(kern.bits, doubling.changed_bits_plain(r, s))
    slots, sa_vals = doubling._extract_tied(r, s, tied, kern)
    p_slots, p_vals = doubling._extract_tied_plain(r, s)
    assert torch.equal(slots.long(), p_slots)
    assert torch.equal(sa_vals, p_vals)
    assert torch.equal(kern.heads, r[sa_vals.long()])


@pytest.mark.parametrize("m", [1, 2, 3, 2048, 4097, (1 << 21) + 1])
def test_sa_pair_scatter_kernel_equals_index_put(cuda, m):
    """sa_pair_scatter == ``index_put_`` of the same (suffix, head) pairs,
    in any order, an odd count too."""
    rng = np.random.default_rng(m)
    n = 2 * m + 5
    dest = rng.permutation(n)[:m].astype(np.int32)
    head = rng.integers(0, n, m).astype(np.int32)
    pairs = torch.from_numpy(np.stack([dest, head], 1).reshape(-1).copy())
    buf = torch.empty(m, dtype=torch.int64, device=cuda)
    buf.view(torch.int32).copy_(pairs.to(cuda))
    rank = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(cuda)
    ref = rank.clone()
    ref[torch.from_numpy(dest).long().to(cuda)] = torch.from_numpy(head).to(
        cuda)
    before = kernels.launches["sa_pair_scatter"]
    doubling.Kernels().scatter(buf, m, rank)
    assert kernels.launches["sa_pair_scatter"] == before + 1
    assert torch.equal(rank, ref)


@pytest.mark.parametrize("n", [1024, 70_000, 1 << 20])
def test_sa_lcp_device_card_equals_cpu_sizes(cuda, n):
    """SA + LCP (hybrid mode) of padded DNA on the card and on the CPU."""
    sym, _, base = _sa_text("wide12", n)
    got = doubling.sa_lcp_device(sym.to(cuda), True, lcp_mode="hybrid",
                                 base_width=base)
    ref = doubling.sa_lcp_device(sym, True, lcp_mode="hybrid",
                                 base_width=base)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a.cpu(), b)


def test_doubling_launches_on_the_workers_card(cuda):
    """Two worker threads a card, none of which sets a current device:
    each loop's SA and rows land on its card, equal the plain version's,
    and its keys and reranks count on that card."""
    from andix_torch import parallel

    count = torch.cuda.device_count()
    sym, packed, base = _sa_text("family", 20_000)
    L = doubling.levels_needed(sym.shape[0], packed, base)
    ref = doubling.sa_loop(sym, packed, L, base)
    kernels.reset_launches()

    def check(d):
        dev = torch.device("cuda", d)
        got = doubling.sa_loop(sym.to(dev), packed, L, base)
        assert all(x.device == dev for x in [got[0]] + got[1])
        assert got[2:] == ref[2:] and torch.equal(got[0].cpu(), ref[0])
        for a, b in zip(got[1], ref[1]):
            assert torch.equal(a.cpu(), b)

    parallel.run_workers([lambda d=d: check(d) for d in range(count)] * 2)
    rounds = kernels.launches["sa_rerank"] // (2 * count)
    for d in range(count):
        card = kernels.launches_by_card[d]
        assert card["sa_rerank"] == 2 * rounds and card["sa_keys"] > 0


def _wrapped(name: str, data: np.ndarray, width: int = 70) -> bytes:
    """One FASTA record, its sequence in lines of ``width`` bytes."""
    pad = (-len(data)) % width
    body = np.concatenate([data, np.full(pad, 10, np.uint8)]).reshape(
        -1, width)
    lines = np.concatenate([body, np.full((len(body), 1), 10, np.uint8)],
                           axis=1).ravel()[: len(data) + -(-len(data) // width)]
    return f">{name} strain {name}\n".encode() + lines.tobytes()


def _raw_family(n_genomes, length, seed):
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    recs = []
    for k in range(n_genomes):
        hit = rng.random(length) < 0.01 * k
        data = np.where(hit, NUCL[rng.integers(0, 4, length)], base)
        recs.append(_wrapped(f"g{k}", data))
    return b"".join(recs)


@pytest.mark.parametrize("kind", ["bytes", "tile_edges", "family_8x5m"])
def test_ingest_kernel_equals_plain(cuda, kind):
    """The ingest's two kernels (scan and RS) against the plain version:
    random bytes of every class (headers, refused bytes, empty names),
    records whose edges fall on tile and chunk edges, and 8 x 5 Mbp in
    70-column lines: the kept bytes, the record table and its totals, and
    the RS bytes, exactly."""
    rng = np.random.default_rng(18)
    if kind == "bytes":
        alphabet = np.frombuffer(b"ACGTacgtNn-*> \t\r\n\n1!\x00\xff",
                                 np.uint8)
        x = alphabet[rng.integers(0, len(alphabet), 300_007)]
        x[0] = ord(">")
    elif kind == "tile_edges":
        recs = [_wrapped(f"r{k}", NUCL[rng.integers(0, 4, n)], w)
                for k, (n, w) in enumerate([(16384 - 9, 61), (1, 1),
                                            (16384 * 3, 16384), (63, 64),
                                            (64, 63), (15, 16), (16, 15),
                                            (70_001, 70)])]
        x = np.frombuffer(b"".join(recs) + b"\n", np.uint8)
    else:
        x = np.frombuffer(_raw_family(8, 5_000_000, 18), np.uint8)
    raw = torch.from_numpy(x.copy())
    cap = 64
    before = kernels.launches["ingest"]
    seq, rec, rs = ingest.scan(raw.to(cuda), cap)
    assert kernels.launches["ingest"] == before + 1
    want = ingest.scan_plain(raw, cap)
    nh, k = int(want[1][cap, 0]), int(want[1][cap, 2])
    assert torch.equal(rec.cpu(), want[1])
    assert torch.equal(seq[:k].cpu(), want[0][:k])
    if nh <= cap:
        total = 2 * k + 2 * nh
        assert torch.equal(rs[:total].cpu(), want[2][:total])


def test_ingest_read_on_the_card_equals_the_host(cuda, tmp_path):
    """``ingest.read`` on the card (files read whole into pinned memory,
    one upload) against ``fasta.read_fasta`` and ``subject_init``: names,
    sequences, RS, G+C and thresholds, and a refused file (a digit) read
    by the host with its flag."""
    import contextlib
    import io

    from andix_torch import fasta
    from andix_torch.runtime import Context

    rng = np.random.default_rng(19)
    paths = []
    for k in range(4):
        body = _wrapped(f"c{k}", NUCL[rng.integers(0, 4, 50_000 + k)])
        if k == 1:
            body += b">c1b lower case\nacgtnNRYacgt\n"
        if k == 2:
            body += b">c2b\nACGT1\n"
        p = tmp_path / f"f{k}.fa"
        p.write_bytes(body)
        paths.append(str(p))
    ctx_h, ctx_d = Context(), Context()
    err_h, err_d = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_h):
        want = [s for p in paths for s in fasta.read_fasta(p, ctx_h)]
    with contextlib.redirect_stderr(err_d):
        got = ingest.read(paths, ctx_d, cuda)
    assert err_h.getvalue() == err_d.getvalue()
    assert ctx_h.non_acgt == ctx_d.non_acgt
    assert [type(s) is ingest.IngestSeq for s in got] == [
        True, True, True, False, False, True]
    for a, b in zip(want, got):
        assert a.name == b.name and np.array_equal(a.data, b.data)
        sa, sb = subject_init(a, 0.025), ingest.subject(b, 0.025)
        assert np.array_equal(sa.rs, sb.rs)
        assert (sa.gc, sa.threshold) == (sb.gc, sb.threshold)


def _draft_files(n_genomes, length, contigs, seed):
    """Each genome as one file of ``contigs`` records in 70-column lines,
    some of them lower case or holding N runs, as raw bytes."""
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    files = []
    for k in range(n_genomes):
        hit = rng.random(length) < 0.01 * k
        data = np.where(hit, NUCL[rng.integers(0, 4, length)], base)
        cuts = np.sort(rng.choice(np.arange(1, length), contigs - 1,
                                  replace=False))
        recs = [_wrapped(f"g{k}_c{c}", piece)
                for c, piece in enumerate(np.split(data, cuts))]
        recs[1] = recs[1].lower()
        recs[2] += b"NNNNNNNN\n"
        files.append(b"".join(recs) + b"\n")
    return files


@pytest.mark.parametrize("kind", ["bytes", "drafts_8x5m"])
def test_ingest_join_kernel_equals_plain(cuda, kind):
    """The ingest in join mode (``ingest_join_rs_kernel`` after the scan)
    against the plain version: random bytes of every class with random
    file starts, and 8 x 5 Mbp drafts of 150 contigs a file: the kept
    bytes, the table and every RS byte, in one ``ingest`` launch."""
    rng = np.random.default_rng(26)
    if kind == "bytes":
        alphabet = np.frombuffer(b"ACGTacgtNn-*> \t\r\n\n1!\x00\xff",
                                 np.uint8)
        x = alphabet[rng.integers(0, len(alphabet), 300_007)]
        x[0] = ord(">")
        starts = np.unique(np.append(rng.integers(0, len(x), 40), 0))
        cap = 1 << 14
    else:
        files = _draft_files(8, 5_000_000, 150, 26)
        x = np.frombuffer(b"".join(files), np.uint8)
        starts = np.cumsum([0] + [len(f) for f in files[:-1]])
        cap = 2048
    raw = torch.from_numpy(x.copy())
    st = torch.from_numpy(starts.astype(np.int64))
    before = kernels.launches["ingest"]
    seq, rec, rs = ingest.scan(raw.to(cuda), cap, st.to(cuda))
    assert kernels.launches["ingest"] == before + 1
    want = ingest.scan_plain(raw.to(cuda), cap, st.to(cuda))
    nh, k = int(want[1][cap, 0]), int(want[1][cap, 2])
    assert nh <= cap
    assert torch.equal(rec, want[1])
    assert torch.equal(seq[:k], want[0][:k])
    total = 2 * k + 2 * nh
    assert torch.equal(rs[:total], want[2][:total])


def test_ingest_join_read_on_the_card_equals_the_host(cuda, tmp_path):
    """``ingest.read`` on the card in join mode against
    ``fasta.read_fasta_join`` and ``subject_init``: one joined sequence a
    file, named after it, with its RS, G+C and threshold; a refused file
    (a digit) between them joined on the host; the joined texts back to
    back in the RS buffer, so the joint text is a view."""
    import contextlib
    import io

    from andix_torch import fasta
    from andix_torch.runtime import Context

    blobs = _draft_files(4, 200_000, 30, 27)
    blobs.insert(2, blobs[2] + b">bad\nACGT1\n")
    paths = []
    for k, blob in enumerate(blobs):
        p = tmp_path / f"g{k}.draft.fa"
        p.write_bytes(blob)
        paths.append(str(p))
    ctx_h, ctx_d = Context(), Context()
    ctx_h.join = ctx_d.join = True
    err_h, err_d = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_h):
        want = [s for p in paths for s in fasta.read_fasta_join(p, ctx_h)]
    with contextlib.redirect_stderr(err_d):
        got = ingest.read(paths, ctx_d, cuda)
    assert err_h.getvalue() == err_d.getvalue()
    assert ctx_h.non_acgt == ctx_d.non_acgt
    assert [type(s) is ingest.IngestSeq for s in got] == [
        True, True, False, True, True]
    for a, b in zip(want, got):
        assert a.name == b.name and np.array_equal(a.data, b.data)
        sa, sb = subject_init(a, 0.025), ingest.subject(b, 0.025)
        assert np.array_equal(sa.rs, sb.rs)
        assert (sa.gc, sa.threshold) == (sb.gc, sb.threshold)
    layout = ingest.block_layout({0: got[0].rs, 1: got[1].rs}, {}, cuda)
    assert layout.u8.base is not None and np.shares_memory(layout.u8,
                                                           got[0].rs)


@pytest.mark.parametrize("case", ["random", "one_segment", "unpadded",
                                  "joint_8x5m"])
def test_block_text_kernel_equals_pad_symbols(cuda, case):
    """``block_text`` on the card against ``pad_symbols(layout.sym,
    padded_n)``: random layouts with query-only segments, one segment,
    ``padded_n == n``, and the 8 x 5 Mbp joint block (100,663,296 padded
    symbols); its counts read every separator's 0 and no other."""
    from andix_torch.esa.backend import bucket
    from andix_torch.sequence import catcomp

    rng = np.random.default_rng(20)
    if case == "joint_8x5m":
        sizes, queries = [5_000_000] * 8, 0
    elif case == "one_segment":
        sizes, queries = [70_001], 0
    else:
        sizes, queries = [int(x) for x in rng.integers(1, 40_000, 5)], 3
    rs = {k: catcomp(NUCL[rng.integers(0, 4, n)])
          for k, n in enumerate(sizes)}
    qs = {len(sizes) + k: NUCL[rng.integers(0, 4, 9_999 + k)]
          for k in range(queries)}
    layout = joint.build_block(rs, qs)
    padded = layout.n if case == "unpadded" else bucket(layout.n)
    ends = torch.from_numpy(layout.seg_start[1:] - 1)
    before = kernels.launches["block_text"]
    sym, counts = ingest.block_text(torch.from_numpy(layout.u8).to(cuda),
                                    ends.to(cuda), padded)
    assert kernels.launches["block_text"] == before + 1
    assert np.array_equal(sym.cpu().numpy(), pad_symbols(layout.sym, padded))
    assert counts.tolist() == [len(ends), 0]
    plain = ingest.block_text_plain(torch.from_numpy(layout.u8), ends,
                                    padded)
    assert torch.equal(sym.cpu(), plain[0])


def test_block_text_kernel_counts_a_stray_zero(cuda):
    text = torch.tensor([65, 0, 67, 0, 71, 0], dtype=torch.uint8)
    ends = torch.tensor([3, 5], dtype=torch.int64)
    sym, counts = ingest.block_text(text.to(cuda), ends.to(cuda), 64)
    assert counts.tolist() == [3, 1]
    assert counts.tolist() == ingest.block_text_plain(text, ends,
                                                      64)[1].tolist()


@pytest.mark.parametrize("lengths", [[50_000, 70_001, 33_333],
                                     [20_000 + k for k in range(9)]])
def test_subject_index_texts_on_the_card_equal_the_cpu(cuda, tmp_path,
                                                       lengths):
    """The subject schedule's group index and packed query words with
    every text made on the card, from subjects ``ingest.read`` read there
    (views of its pinned RS buffer), against the CPU's route on the same
    subjects: every tensor equal, one ``block_text`` launch a subject."""
    import contextlib
    import io

    from andix_torch.runtime import Context

    rng = np.random.default_rng(23)
    paths = []
    for k, n in enumerate(lengths):
        p = tmp_path / f"s{k}.fa"
        p.write_bytes(_wrapped(f"s{k}", NUCL[rng.integers(0, 4, n)]))
        paths.append(str(p))
    with contextlib.redirect_stderr(io.StringIO()):
        seqs = ingest.read(paths, Context(), cuda)
    subjects = [ingest.subject(s, 0.025) for s in seqs]
    assert np.shares_memory(
        ingest.block_layout({0: subjects[0].rs}, {}, cuda).u8,
        subjects[0].rs)
    group, cpu = list(range(len(seqs))), torch.device("cpu")
    before = kernels.launches["block_text"]
    got = subject_pipeline._build_group_index(group, subjects, 6, cuda,
                                              1 << 34, 0)
    assert kernels.launches["block_text"] == before + len(group)
    want = subject_pipeline._build_group_index(group, subjects, 6, cpu,
                                               1 << 34, 0)
    for a, b in zip(got[:4], want[:4]):
        assert a.device == cuda and torch.equal(a.cpu(), b)
    assert got[4] == want[4] == 0
    _, _, qw_base = subject_pipeline._host_query_blob(seqs, len(seqs))
    qw = subject_pipeline._pack_query_words(seqs, qw_base, cuda)
    assert torch.equal(qw.cpu(), subject_pipeline._pack_query_words(
        seqs, qw_base, cpu))


def test_cli_reads_on_the_card_and_prints_the_host_bytes(cuda, tmp_path,
                                                         capfd):
    """The CLI on a small family, ``--backend cuda`` against ``--backend
    cpu``: stdout, stderr and exit code byte-equal; on the card every file
    is read by the ingest kernel (one launch) and the block text widened by
    ``block_text``; a refused file (a '!' in a sequence) goes to the host
    on both and changes nothing else."""
    from andix_torch import cli

    rng = np.random.default_rng(21)
    base = NUCL[rng.integers(0, 4, 20_000)]
    paths = []
    for k in range(4):
        data = np.where(rng.random(20_000) < 0.02 * k,
                        NUCL[rng.integers(0, 4, 20_000)], base)
        body = _wrapped(f"g{k}", data)
        if k == 3:
            body = body[:-30] + b"n" + body[-30:]
        p = tmp_path / f"g{k}.fa"
        p.write_bytes(body)
        paths.append(str(p))
    bang = tmp_path / "bang.fa"
    bang.write_bytes(b">bang\n" + base[:5000].tobytes() + b"!ACGT\n")
    for files in (paths, paths + [str(bang)]):
        kernels.reset_launches()
        code_c = cli.main(["--backend", "cuda", "--progress=never"] + files)
        out_c = capfd.readouterr()
        launches = dict(kernels.launches)
        code_p = cli.main(["--backend", "cpu", "--progress=never"] + files)
        out_p = capfd.readouterr()
        assert (code_c, out_c.out, out_c.err) == (code_p, out_p.out,
                                                  out_p.err)
        assert launches["ingest"] == 1 and launches["block_text"] >= 1
