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
from andix_torch.chain import segmented, walk_sx
from andix_torch.esa.backend import TorchBackend
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


@pytest.fixture(scope="module")
def index():
    """The JAX group index at cache_k 2 and at pick_cache_k's value, the
    packed query words and the lane geometry, computed once."""
    seqs = _family()
    subjects = [subject_init(s, 0.025) for s in seqs]
    n = len(seqs)
    raw, q_off, qw_base = jsp._host_query_blob(seqs, n)
    qw = jsp._pack_query_words(raw, q_off, n)
    built = {}
    for k in (2, PICK_K):
        salcp, sw, cache2, nreal, _ = jsp._build_group_index(
            [0, 1, 2], subjects, k, 0)
        built[k] = tuple(np.array(x) for x in (salcp, sw, cache2)) + (
            np.asarray(nreal, np.int32),)
    geo = dict(q_len=(q_off[1:] - q_off[:-1]).astype(np.int32),
               qw_base=qw_base,
               rs_lens=[s.len for s in subjects],
               thresholds=[s.threshold for s in subjects])
    return built, np.array(qw), geo


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


@pytest.mark.parametrize("case", CASES)
def test_cpu_twin_of_kernel_equals_jax(index, jax_refs, case):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    _run(index, jax_refs, case, walk_sx.chain_walk_flat_sx_cpu_twin)


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
            m.setattr(jsegmented if jax else segmented, "CHUNK_ITERS", chunk)
        if jax:
            M = jpipeline.calculate_matrix(
                [Seq(d, nm) for nm, d in fam], JContext(),
                backend=JaxBackend())
        else:
            M = pipeline.calculate_matrix(
                [TSeq(d, nm) for nm, d in fam], Context(),
                backend=TorchBackend(torch.device("cpu")))
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
