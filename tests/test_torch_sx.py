"""andix_torch search walk against the JAX ``chain_walk_flat_sx``: the
plain lock-step version (what the CPU path runs) and the CUDA kernel's
per-lane body built for the host with g++ (the "CPU twin"), on the same
subject index and query words.  Per lane: the event stream in chain
order and the exit state; overall: event count, overflow flag and
iterations.  The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py.

Then the subject-index schedule end to end (``ANDIX_INDEX=subject``,
``--backend cpu``): count grids equal to andix's subject-index schedule
on the families of tests/test_walk_sx.py (the other families are in
tests/test_torch_subject_index.py)."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix import pipeline as jpipeline
from andix import subject_pipeline as jsp
from andix.chain import segmented as jsegmented
from andix.chain.walk_sx import chain_walk_flat_sx as jax_walk_sx
from andix.esa import subject_index as jsi
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context as JContext
from andix.sequence import Seq, subject_init
from andix_torch import pipeline
from andix_torch.chain import segdrive, walk_sx
from andix_torch.runtime import Context
from andix_torch.sequence import Seq as TSeq

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
BIG = 1 << 28


def _family():
    """Three 3000 bp genomes (a close and a diverged relative) with a '!'
    contig joiner in each, so queries carry nibble code 1."""
    r = np.random.default_rng(3)
    base = NUCL[r.integers(0, 4, 3000)]
    seqs = [base]
    for rate in (0.03, 0.3):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(3000) < rate
        seqs.append(NUCL[(codes + np.where(
            hit, r.integers(1, 4, 3000), 0)) % 4])
    for k, s in enumerate(seqs):
        s[700 + 300 * k] = ord("!")
    return [Seq(s, f"g{k}") for k, s in enumerate(seqs)]


PICK_K = jsi.pick_cache_k(6002, 3, jsp.CACHE_BUDGET)


def _group(seqs, cache_ks):
    """The JAX group index of three genomes at each cache depth, the
    packed query words and the lane geometry."""
    subjects = [subject_init(s, 0.025) for s in seqs]
    n = len(seqs)
    raw, q_off, qw_base = jsp._host_query_blob(seqs, n)
    qw = jsp._pack_query_words(raw, q_off, n)
    built = {}
    for k in cache_ks:
        salcp, sw, cache2, nreal, _ = jsp._build_group_index(
            [0, 1, 2], subjects, k, 0)
        built[k] = tuple(np.array(x) for x in (salcp, sw, cache2)) + (
            np.asarray(nreal, np.int32),)
    geo = dict(q_len=(q_off[1:] - q_off[:-1]).astype(np.int32),
               qw_base=qw_base,
               rs_lens=[s.len for s in subjects],
               thresholds=[s.threshold for s in subjects])
    return built, np.array(qw), geo


@pytest.fixture(scope="module")
def index():
    """The JAX group index at cache_k 2 and at pick_cache_k's value, the
    packed query words and the lane geometry, computed once."""
    return _group(_family(), (2, PICK_K))


def _lanes(geo, k):
    """Every (subject, query) lane cut into k segments, each entered
    cold (segment 0 from the start state) — the segmented walk's first
    pass — padded to 32 lanes like its lane buckets."""
    arr = {n: [] for n in walk_sx.SX_LANE_FIELDS}
    for s in range(3):
        thr = int(geo["thresholds"][s])
        for g in range(3):
            if g == s:
                continue
            qlen = int(geo["q_len"][g])
            step = -(-qlen // k)
            for j in range(k):
                st, en = j * step, min((j + 1) * step, qlen)
                entry = (0, 0, 0, 0) if j == 0 else (
                    st, st - thr - 2, st - thr - 2, 0)
                vals = (s, geo["qw_base"][g], geo["rs_lens"][s], thr,
                        en) + entry
                for name, v in zip(walk_sx.SX_LANE_FIELDS, vals):
                    arr[name].append(int(v))
    lb = 32
    pad = dict(rl=1, thr=1 << 29)
    return {n: np.array(v + [pad.get(n, 0)] * (lb - len(v)), np.int32)
            for n, v in arr.items()}


def _jax(built, qw, lanes, iters, maxev, cache_k, ecap):
    salcp, sw, cache2, nreal = built
    out = jax_walk_sx(
        jnp.asarray(salcp), jnp.asarray(sw), jnp.asarray(cache2),
        jnp.asarray(nreal), jnp.asarray(qw),
        *(jnp.asarray(lanes[n]) for n in walk_sx.SX_LANE_FIELDS),
        jnp.int32(iters), jnp.int32(maxev), cache_k, ecap)
    a, b, cnt, ovf, it, *state = (np.asarray(x) for x in out)
    ev = [(a >> 32).astype(np.int32), (b >> 32).astype(np.int32),
          (b & 0x7FFFFFFF).astype(np.int32), (a & 0x7FFFFFFF).astype(np.int32)]
    return ev + [cnt, ovf, it] + state


def _per_lane(out, lb):
    cnt = min(int(out[4]), len(out[0]))
    ev = np.stack([np.asarray(x)[:cnt] for x in out[:4]])
    order = np.argsort(ev[0], kind="stable")
    ev = ev[:, order]
    bounds = np.searchsorted(ev[0], np.arange(lb + 1))
    return [ev[1:, bounds[i]: bounds[i + 1]] for i in range(lb)]


# (segments per lane, max_iters, max_events, ecap, cache_k)
CASES = [
    (1, BIG, BIG, 1 << 15, PICK_K),  # whole walk
    (3, BIG, BIG, 1 << 15, PICK_K),  # cold segment entries
    (3, 13, 1, 1 << 15, PICK_K),  # cut by iterations and events
    (1, BIG, BIG, 8, PICK_K),  # event buffer overflow
    (2, BIG, BIG, 1 << 15, 2),  # wide cache brackets: deep bisection
]


@pytest.fixture(scope="module")
def jax_refs(index):
    built, qw, geo = index
    return {case: _jax(built[case[4]], qw, _lanes(geo, case[0]), *case[1:3],
                       case[4], case[3]) for case in CASES}


def _run(index, jax_refs, case, fn):
    built, qw, geo = index
    k, iters, maxev, ecap, cache_k = case
    lanes = _lanes(geo, k)
    ref = jax_refs[case]
    got = fn(*(torch.from_numpy(x) for x in built[cache_k]),
             torch.from_numpy(qw),
             {n: torch.from_numpy(v) for n, v in lanes.items()},
             iters, maxev, cache_k, ecap)
    got = [x.numpy() for x in got]
    assert int(got[4]) == int(ref[4])  # ev_cnt
    assert bool(got[5]) == bool(ref[5]) == (int(ref[4]) > ecap)  # ovf
    assert int(got[6]) == int(ref[6])  # iters
    for a, b in zip(ref[7:], got[7:]):  # pos, lq, ls, ll, fin
        assert (np.asarray(a) == b).all()
    if not bool(ref[5]):
        lb = len(lanes["row"])
        for a, b in zip(_per_lane(ref, lb), _per_lane(got, lb)):
            assert a.shape == b.shape and (a == b).all()
    return ref


def test_cases_cover_the_contract(jax_refs):
    whole, _, cut, ovf, _ = (jax_refs[c] for c in CASES)
    assert int(whole[4]) > 0 and not bool(whole[5])
    assert int(cut[6]) == 16 and not np.asarray(cut[11]).all()  # 13 -> 16
    assert bool(ovf[5])


@pytest.mark.parametrize("case", CASES)
def test_plain_walk_equals_jax(index, jax_refs, case):
    _run(index, jax_refs, case, walk_sx.chain_walk_flat_sx)  # CPU: plain


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_cpu_twin_of_kernel_equals_jax(index, jax_refs, case, tiny):
    """The kernel's lane body at the kernel's round and window sizes and at
    tiny ones (2-word rounds, 3 query words, 4 diagonal words, 3 staged
    events)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    _run(index, jax_refs, case, lambda *a: walk_sx.chain_walk_flat_sx_cpu_twin(
        *a, tiny=tiny))


def test_all_lanes_finished_at_entry(index):
    """max_events = 0 finishes every lane at entry: no iteration runs."""
    built, qw, geo = index
    lanes = {n: torch.from_numpy(v) for n, v in _lanes(geo, 1).items()}
    args = [torch.from_numpy(x) for x in built[PICK_K]] + [
        torch.from_numpy(qw), lanes, BIG, 0, PICK_K, 64]
    for fn in (walk_sx.chain_walk_flat_sx,
               walk_sx.chain_walk_flat_sx_cpu_twin):
        out = fn(*args)
        assert (int(out[4]), int(out[6])) == (0, 0)
        assert out[11].all()


@pytest.mark.parametrize("a,b", [
    (0, 0), (0, 1), (1, 0), (-1, 0), (-1, -1), (1 << 62, 1 << 62 | 1),
    (-(1 << 63), 0), (0x0123456789ABCDEF, 0x0123456789ABCDE0),
    (0x7FFFFFFFFFFFFFFF, -1),
])
def test_word_lcp_counts_leading_zero_nibbles(a, b):
    x = (a ^ b) & (2**64 - 1)
    want = 16 if x == 0 else (64 - x.bit_length()) // 4
    got = walk_sx._word_lcp(torch.tensor([a], dtype=torch.int64),
                            torch.tensor([b], dtype=torch.int64))
    assert int(got[0]) == want


M64 = (1 << 64) - 1


def _window(words, last, p):
    """The 16-symbol window at symbol p and the (clamped) word indices it
    needs: one when p starts a word."""
    j, r = p >> 4, p & 15
    w0 = int(words[min(j, last)]) & M64
    if r == 0:
        return w0, (min(j, last),)
    w1 = int(words[min(j + 1, last)]) & M64
    return ((w0 << 4 * r) | (w1 >> 4 * (16 - r))) & M64, (min(j, last),
                                                            min(j + 1, last))


def _nib(w, i):
    return (w >> 4 * (15 - i)) & 15


def _scalar_sx_walk(built, qw, lanes, cache_k):
    """One lane after another in plain Python, whole lanes, one probe at a
    time (not the lock-step loop): the plain walk's counts, with every
    index entry it reads kept in a set, and per lane its probes as (first
    iteration, [(phase, iterations), ...]) and their compares' lengths in
    words."""
    salcp, sw, cache2, nreal = built
    qw_last, sw_last = len(qw) - 1, sw.shape[1] - 1
    seen = {k: set() for k in ("sa", "lcp", "cache", "sw", "qw")}
    c = dict(probes=0, lucky_checks=0, bis_steps=0, ab_pairs=0, words=0,
             events=0)
    probes, compares = [], []
    for i in range(len(lanes["row"])):
        row, qwb, rl, thr, seg_end, pos, lq, ls, ll = (
            int(lanes[n][i]) for n in walk_sx.SX_LANE_FIELDS)
        nr = int(nreal[row])
        sa, lcp = salcp[row, 0], salcp[row, 1]

        def cmp(q0, s0):
            t = 0
            while True:
                wq, jq = _window(qw, qw_last, q0 + 16 * t)
                ws, js = _window(sw[row], sw_last, s0 + 16 * t)
                seen["qw"].update(jq)
                seen["sw"].update((row, j) for j in js)
                c["words"] += 1
                x = wq ^ ws
                m = 16 if x == 0 else (64 - x.bit_length()) // 4
                if m < 16:
                    compares.append(t + 1)
                    return t, m, _nib(wq, m) < _nib(ws, m)
                t += 1

        it, mine = 0, []
        while pos < seg_end:
            c["probes"] += 1
            qa = qwb + pos
            wq0, jq = _window(qw, qw_last, qa)
            seen["qw"].update(jq)
            code, valid = 0, True
            for k in range(cache_k):
                nib = _nib(wq0, k)
                valid = valid and 4 <= nib <= 7
                code = (code << 2) | min(max(nib - 4, 0), 3)
            lo, hi = (int(cache2[row, code]), int(cache2[row, code + 1])) \
                if valid else (0, nr)
            phases, found, done = [], False, False
            advance = pos - lq
            try_s = ls + advance
            if try_s < rl and 0 <= advance - ll <= thr:
                c["lucky_checks"] += 1
                t, m, _ = cmp(qa, try_s)
                phases.append(("lucky", t + 1))
                if 16 * t + m >= thr:
                    found = done = True
                    length, this_s = 16 * t + m, try_s
            if not done and valid:
                seen["cache"].update({(row, code), (row, code + 1)})
            llo = lhi = h = 0
            while not done and lo < hi:
                mid = (lo + hi) >> 1
                seen["sa"].add((row, mid))
                t, m, less = cmp(qa + h, int(sa[mid]) + h)
                c["bis_steps"] += 1
                phases.append(("bis", t + 1))
                if less:
                    hi, lhi = mid, h + 16 * t + m
                else:
                    lo, llo = mid + 1, h + 16 * t + m
                h = min(llo, lhi)
            if not done:
                c["ab_pairs"] += 1
                ipv, aa, bb, ta, tb = lo, -1, -1, 0, 0
                if ipv > 0:
                    seen["sa"].add((row, ipv - 1))
                    ta, m, _ = cmp(qa + h, int(sa[ipv - 1]) + h)
                    aa = h + 16 * ta + m
                if ipv < nr:
                    seen["sa"].add((row, ipv))
                    tb, m, _ = cmp(qa + h, int(sa[ipv]) + h)
                    bb = h + 16 * tb + m
                phases.append(("ab", 1 + max(ta, tb)))
                length = max(aa, bb, 0)
                use_a = aa >= bb
                unique = False
                if length > 0 and aa != bb:
                    if use_a:
                        seen["lcp"].add((row, max(ipv - 1, 0)))
                        unique = int(lcp[max(ipv - 1, 0)]) < aa
                    elif ipv + 1 >= nr:
                        unique = True
                    else:
                        seen["lcp"].add((row, ipv + 1))
                        unique = int(lcp[ipv + 1]) < bb
                found = unique and length >= thr
                this_s = int(sa[ipv - 1]) if use_a else int(sa[ipv])
            mine.append((it, phases))
            it += sum(n for _, n in phases)
            if found:
                lq, ls, ll = pos, this_s, length
                c["events"] += 1
            pos += length + 1
        probes.append(mine)
    c.update({k: len(v) for k, v in seen.items()})
    return c, probes, compares


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4]])
def test_plain_counts_each_index_entry_once(index, case):
    """The plain walk's counts, which set the kernel's byte bound, equal
    those of a scalar walk that keeps every index entry it reads in a set:
    suffix array, LCP and cache entries, subject and query words, with
    its probes, lucky checks, bisection steps, boundary pairs and compared
    words."""
    built, qw, geo = index
    k, iters, maxev, ecap, cache_k = case
    lanes = _lanes(geo, k)
    counts = {}
    walk_sx.chain_walk_flat_sx_plain(
        *(torch.from_numpy(x) for x in built[cache_k]), torch.from_numpy(qw),
        {n: torch.from_numpy(v) for n, v in lanes.items()}, iters, maxev,
        cache_k, ecap, counts)
    ref, _, _ = _scalar_sx_walk(built[cache_k], qw, lanes, cache_k)
    assert counts == ref
    assert min(ref.values()) > 0
    assert ref["cache"] < 2 * ref["probes"]  # lucky anchors need no bracket


def _burst_family():
    """g0 random; g1 = g0 with a random 300-symbol burst at 2500 (its
    lanes with g0 leave the lucky diagonal there and come back to it) and
    1% substitutions after it; g2 = g0 at 10%.  4000 bp each, so the first
    probe of the g0 / g1 lanes compares 2500 symbols (156 words, past the
    kernel's 64-word query window)."""
    r = np.random.default_rng(17)
    base = NUCL[r.integers(0, 4, 4000)]
    seqs = [base]
    for rate in (0.01, 0.1):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(4000) < rate
        seqs.append(NUCL[(codes + np.where(
            hit, r.integers(1, 4, 4000), 0)) % 4])
    seqs[1][:2500] = base[:2500]
    seqs[1][2500:2800] = NUCL[r.integers(0, 4, 300)]
    return [Seq(s, f"g{k}") for k, s in enumerate(seqs)]


BURST_K = jsi.pick_cache_k(8002, 3, jsp.CACHE_BUDGET)


def _cut_phases(probes, cap):
    """The phases (lucky, bis, ab) that the iteration cap cuts strictly
    inside, over every lane: a lane stops in the probe whose iterations
    pass the cap."""
    cut = set()
    for lane in probes:
        for start, phases in lane:
            if start + sum(n for _, n in phases) > cap:
                done = cap - start
                for kind, n in phases:
                    if 0 < done < n:
                        cut.add(kind)
                    done -= n
                break
    return cut


@pytest.fixture(scope="module")
def burst():
    """The burst family's group, its whole lanes, the scalar walk's probes
    and compare lengths, and the smallest iteration cap that falls inside
    a lucky extension, inside a bisection compare of at least two words
    and inside a boundary pair."""
    built, qw, geo = _group(_burst_family(), (BURST_K,))
    lanes = _lanes(geo, 1)
    _, probes, compares = _scalar_sx_walk(built[BURST_K], qw, lanes, BURST_K)
    caps = {}
    for cap in range(walk_sx.UNROLL, 4000, walk_sx.UNROLL):
        for kind in _cut_phases(probes, cap):
            caps.setdefault(kind, cap)
    # a lane alone whose first probe takes over 128 iterations, cut by a
    # cap of 64 inside it: the lane, and so the dispatch, still spends the
    # whole cap
    first = [sum(n for _, n in lane[0][1]) for lane in probes if lane]
    long_lane = int(np.argmax(first))
    assert first[long_lane] > 128 and probes[long_lane][0][0] == 0
    return built[BURST_K], qw, lanes, probes, compares, caps, long_lane


def test_burst_family_covers_the_new_cases(burst):
    """The cases below exist in the data: caps inside each phase, a
    compare longer than the kernel's query window (which refills it in the
    middle of a probe), and a g0 / g1 lane that leaves the lucky diagonal
    and comes back to it."""
    built, qw, lanes, probes, compares, caps, _ = burst
    assert set(caps) == {"lucky", "bis", "ab"}
    assert max(compares) > 128
    out = walk_sx.chain_walk_flat_sx_plain(
        *(torch.from_numpy(x) for x in built), torch.from_numpy(qw),
        {n: torch.from_numpy(v) for n, v in lanes.items()}, BIG, BIG,
        BURST_K, 1 << 15)
    ev = _per_lane([x.numpy() for x in out], len(lanes["row"]))
    back = False
    for q, s, _ in (e for e in ev if e.shape[1]):
        diag = s - q
        main = np.bincount(diag - diag.min()).argmax() + diag.min()
        off = np.nonzero(diag != main)[0]
        back = back or (len(off) and off[0] > 0
                        and (diag[off[-1] + 1:] == main).any())
    assert back


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("kind", ["lucky", "bis", "ab", "long", "whole"])
def test_cpu_twin_stops_inside_a_probe_like_jax(burst, kind, tiny):
    """With max_iters cutting a lane inside a lucky extension, a long
    bisection compare or a boundary pair, or a lone lane inside its first
    probe's 156-word compare, the twin stops where the JAX walk does: same
    exit state, iterations, events; and whole lanes whose compares refill
    the query window mid-probe."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    built, qw, lanes, _, _, caps, long_lane = burst
    iters = {"whole": BIG, "long": 64}.get(kind) or caps[kind]
    if kind == "long":
        lanes = {n: v[[long_lane]] for n, v in lanes.items()}
    ref = _jax(built, qw, lanes, iters, BIG, BURST_K, 1 << 15)
    got = walk_sx.chain_walk_flat_sx_cpu_twin(
        *(torch.from_numpy(x) for x in built), torch.from_numpy(qw),
        {n: torch.from_numpy(v) for n, v in lanes.items()}, iters, BIG,
        BURST_K, 1 << 15, tiny=tiny)
    got = [x.numpy() for x in got]
    for i in (4, 5, 6):  # ev_cnt, ovf, iters
        assert int(got[i]) == int(ref[i])
    for a, b in zip(ref[7:], got[7:]):  # pos, lq, ls, ll, fin
        assert (np.asarray(a) == b).all()
    lb = len(lanes["row"])
    for a, b in zip(_per_lane(ref, lb), _per_lane(got, lb)):
        assert a.shape == b.shape and (a == b).all()
    if kind != "whole":
        assert not np.asarray(ref[11]).all()


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("ecap", [50, 32, 33, 1])
def test_cpu_twin_staged_events_when_ecap_cuts_a_batch(index, tiny, ecap):
    """With the event buffer ending inside a staging batch (32 events on
    the card, 3 tiny), ev_cnt and ovf are the plain walk's, and the slots
    below ecap hold the first events of the lanes in lane order, each
    lane's in chain order (the twin walks its lanes one after another)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    built, qw, geo = index
    args = ([torch.from_numpy(x) for x in built[PICK_K]]
            + [torch.from_numpy(qw),
               {n: torch.from_numpy(v) for n, v in _lanes(geo, 2).items()},
               BIG, BIG, PICK_K])
    ref = walk_sx.chain_walk_flat_sx_plain(*args, ecap)
    got = walk_sx.chain_walk_flat_sx_cpu_twin(*args, ecap, tiny=tiny)
    assert int(got[4]) == int(ref[4]) > ecap and bool(got[5]) and bool(ref[5])
    ref_all = walk_sx.chain_walk_flat_sx_plain(*args, 1 << 15)
    cnt = int(ref_all[4])
    ev = torch.stack([x[:cnt] for x in ref_all[:4]])
    lane_major = ev[:, torch.from_numpy(np.argsort(ev[0].numpy(),
                                                   kind="stable"))]
    assert torch.equal(torch.stack([x[:ecap] for x in got[:4]]),
                       lane_major[:, :ecap])
    for a, b in zip(got[7:], ref[7:]):  # pos, lq, ls, ll, fin
        assert torch.equal(a, b)


def _matrix_family(n, length, rates, seed):
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


def _joined(fam):
    out = []
    for name, d in fam:
        d = d.copy()
        d[1500] = d[2800] = ord("!")
        out.append((name, d))
    return out


def _subject_grids(fam, env, chunk=None, jax=False):
    """(counts, seq_len) grids of one package's subject-index schedule."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ANDIX_INDEX", "subject")
        m.setenv("ANDIX_SX_MESH", "0")  # andix: one device, like the port
        for k, v in env.items():
            m.setenv(k, str(v))
        if chunk is not None:
            m.setattr(jsegmented if jax else segdrive, "CHUNK_ITERS", chunk)
        if jax:
            M = jpipeline.calculate_matrix(
                [Seq(d, nm) for nm, d in fam], JContext(),
                backend=JaxBackend())
        else:
            M = pipeline.calculate_matrix(
                [TSeq(d, nm) for nm, d in fam], Context(),
                [torch.device("cpu")])
    n = len(fam)
    return (np.array([[M[i][j].counts for j in range(n)] for i in range(n)]),
            np.array([[M[i][j].seq_len for j in range(n)] for i in range(n)]))


_mixed = _matrix_family(5, 5000, [0.005, 0.05, 0.2, 0.45], 11)
# (family, environment, first-chunk iterations)
FAMILIES = {
    "mixed_duplicate_k6": (_mixed + [("dup", _mixed[0][1].copy())],
                           {"ANDIX_CHAIN_SEGMENTS": 6}, None),
    "unsegmented": (_matrix_family(3, 3000, [0.02, 0.3], 5),
                    {"ANDIX_CHAIN_SEGMENTS": 1}, None),
    "cache2_chunks16": (_matrix_family(4, 2500, [0.01, 0.12, 0.4], 23),
                        {"ANDIX_CHAIN_SEGMENTS": 8, "ANDIX_CACHE_K": 2}, 16),
    "joined_contigs": (_joined(_matrix_family(3, 4000, [0.02, 0.1], 31)),
                       {"ANDIX_CHAIN_SEGMENTS": 5}, None),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_subject_schedule_equals_jax(name):
    fam, env, chunk = FAMILIES[name]
    ref = _subject_grids(fam, env, chunk, jax=True)
    got = _subject_grids(fam, env, chunk)
    assert (got[0] == ref[0]).all() and (got[1] == ref[1]).all()
