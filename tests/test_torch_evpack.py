"""andix_torch packed event fetch against ``andix.chain.evpack``: the
plain torch version (what the CPU runs) and the CUDA kernel's event
bodies built for the host with g++ (the "CPU twin", at the kernel's
block size and at a tiny one) equal andix's ``encode_events`` exactly —
packed fields, escape records, per-lane counts, ``n_esc`` and
``esc_ovf`` — on tests/test_evpack.py's streams, on a real subject-index
dispatch's events, on an escape-overflow stream and at an odd ``k``; the
decode gives back the stable lane-major stream; and the subject-index
schedule gives andix's grids under ``ANDIX_EVPACK=0`` and ``1``, odd
event caps included.  The kernel itself is held to the plain version on
a card by tests/test_torch_cuda.py."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from andix import pipeline as jpipeline
from andix.chain import evpack as jevpack
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context as JContext
from andix.sequence import Seq
from andix_torch import pipeline, subject_pipeline
from andix_torch.chain import evpack
from andix_torch.runtime import Context
from andix_torch.sequence import Seq as TSeq

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def _chainlike(seed=5, n_lanes=37):
    """tests/test_evpack.py's chain-like stream: empty lanes, large first
    q, diagonal jumps and long anchors (escapes), per-lane q ascending,
    lanes interleaved in the buffer."""
    rng = np.random.default_rng(seed)
    events = []
    for lane in range(n_lanes):
        if lane % 5 == 0:
            continue
        qpos = int(rng.integers(0, 2_000_000))
        diag = int(rng.integers(-500_000, 500_000))
        for _ in range(int(rng.integers(1, 40))):
            ln = int(rng.integers(10, 300))
            if rng.random() < 0.1:
                diag += int(rng.integers(-100_000, 100_000))
            if rng.random() < 0.05:
                ln = int(rng.integers(70_000, 200_000))
            events.append((lane, qpos, max(qpos + diag, 0), ln))
            qpos += ln + 1 + int(rng.integers(0, 200))
    arr = np.array(events, dtype=np.int64).T.astype(np.int32)
    # interleave the lanes in the buffer; each lane's slots, in buffer
    # order, take its events in chain order
    buf = arr[:, rng.permutation(arr.shape[1])]
    for lane in range(n_lanes):
        buf[1:, buf[0] == lane] = arr[1:, arr[0] == lane]
    return buf, n_lanes


def _all_escapes(n=300, n_lanes=8, seed=9):
    """Every event escapes: long anchors in interleaved lanes."""
    rng = np.random.default_rng(seed)
    lane = rng.integers(0, n_lanes, n)
    q = np.zeros(n, np.int64)
    for k in range(n_lanes):
        sel = lane == k
        q[sel] = np.cumsum(rng.integers(70_000, 90_000, sel.sum()))
    ln = rng.integers(70_000, 80_000, n)
    s = q + rng.integers(0, 1000, n)
    return np.stack([lane, q, s, ln]).astype(np.int32), n_lanes


def _escape_overflow():
    """More escapes than esc_cap = 4096 (8 lanes): 5000 anchors longer
    than 65,535."""
    return _all_escapes(5000, 8, 13)


def _runs(runs, esc_at, seed):
    """Events whose sorted (lane-major) order is known: lane l holds
    runs[l] events in chain order, and exactly the events at the sorted
    positions ``esc_at`` escape (a diagonal jump of 40,000; first events
    start below q 60,000 and diagonal 30,000, later ones step q by at most
    500); the buffer interleaves the lanes."""
    rng = np.random.default_rng(seed)
    esc = np.zeros(sum(runs), bool)
    esc[list(esc_at)] = True
    events, pos = [], 0
    for lane, run in enumerate(runs):
        q, diag = int(rng.integers(0, 60_000)), int(rng.integers(0, 30_000))
        for _ in range(run):
            diag += 40_000 * int(esc[pos])
            ln = int(rng.integers(10, 300))
            events.append((lane, q, q + diag, ln))
            q += ln + 1 + int(rng.integers(0, 200))
            pos += 1
    arr = np.array(events, dtype=np.int64).T.astype(np.int32)
    buf = arr[:, rng.permutation(arr.shape[1])]
    for lane in range(len(runs)):
        buf[1:, buf[0] == lane] = arr[1:, arr[0] == lane]
    return buf, len(runs)


# the encode kernel's tile, in sorted positions (evpack_lane.cuh), and the
# twin's tiny one
TILE, TINY = 2048, 8


def _tile_edges():
    """Escapes on both sides of tile edges, the kernel's and the tiny
    ones, and at the last live position; 6000 events in 60 of 64 lanes."""
    edges = [TINY - 1, TINY, 2 * TINY - 1, 2 * TINY, TILE - 1, TILE,
             2 * TILE - 1, 2 * TILE, 2 * TILE + 1, 5999]
    return _runs([100] * 60 + [0] * 4, edges, 21)


def _escape_tile():
    """A kernel tile (sorted positions 2048-4095) and a tiny one (8-15)
    made only of escapes; 5000 events in 8 lanes."""
    return _runs([625] * 8, list(range(TINY, 2 * TINY))
                 + list(range(TILE, 2 * TILE)), 22)


def _esc_cap(extra):
    """esc_cap + extra escapes (8 lanes: esc_cap = 4096) among 6000
    events."""
    rng = np.random.default_rng(23 + extra)
    return _runs([750] * 8, rng.choice(6000, 4096 + extra, replace=False),
                 23)


def _empty_lanes():
    """Lanes with no events at the start, in the middle and at the end."""
    runs = [0, 0] + [50] * 15 + [0] * 4 + [50] * 16 + [0] * 3
    return _runs(runs, [0, 49, 50, 700, 1549], 24)


def _wide_lanes():
    """20,000 lanes, more than a 48 KB shared histogram's 12,288 bins,
    most of them empty; 5000 events in 1000 lanes spread over all."""
    rng = np.random.default_rng(25)
    runs = np.zeros(20_000, np.int64)
    runs[rng.choice(20_000, 1000, replace=False)] = 5
    return _runs(runs.tolist(), rng.choice(5000, 300, replace=False), 25)


def _small():
    return np.array([[3], [123456], [99], [7]], np.int32), 8


def _empty():
    return np.zeros((4, 0), np.int32), 8


@pytest.fixture(scope="module")
def dispatches():
    """Every walk dispatch's raw events of the port's subject-index
    schedule on a 4 x 3000 bp family at K = 4 (the buffers as the walk
    left them, the count and the lane bucket)."""
    fam = _family(4, 3000, [0.03, 0.15], 41)
    got = []
    orig = subject_pipeline._fetch_events

    def keep(ev4, cnt, lb, ecap):
        got.append((np.stack([x.numpy() for x in ev4]), cnt, lb, ecap))
        return orig(ev4, cnt, lb, ecap)

    with pytest.MonkeyPatch.context() as m:
        m.setenv("ANDIX_INDEX", "subject")
        m.setenv("ANDIX_CHAIN_SEGMENTS", "4")
        m.setattr(subject_pipeline, "_fetch_events", keep)
        pipeline.calculate_matrix([TSeq(d, nm) for nm, d in fam], Context(),
                                  [torch.device("cpu")])
    assert len(got) >= 2 and all(c > 0 for _, c, _, _ in got)
    return got


def _stream(name, dispatches):
    """(buffers int32 [4, ecap] with garbage past cnt, cnt, k, n_lanes)."""
    if name.startswith("dispatch"):
        ev, cnt, lb, ecap = dispatches[int(name[8:])]
        k = min(subject_pipeline.bucket(max(cnt, 1), 4096), ecap)
        return ev, cnt, k, lb
    arr, n_lanes = {"chainlike": _chainlike, "all_escapes": _all_escapes,
                    "escape_overflow": _escape_overflow, "small": _small,
                    "empty": _empty, "tile_edges": _tile_edges,
                    "escape_tile": _escape_tile,
                    "esc_cap": lambda: _esc_cap(0),
                    "esc_cap_plus1": lambda: _esc_cap(1),
                    "empty_lanes": _empty_lanes,
                    "wide_lanes": _wide_lanes}[name.split("-")[0]]()
    cnt = arr.shape[1]
    k = max(16, 1 << int(max(cnt, 1) - 1).bit_length())
    if name.endswith("-odd"):
        k = cnt + 6 if cnt % 2 else cnt + 7  # odd, past cnt
    rng = np.random.default_rng(cnt)
    buf = rng.integers(-2**31, 2**31, (4, k + 5)).astype(np.int32)
    buf[:, :cnt] = arr
    return buf, cnt, k, n_lanes


def _andix(ev, cnt, k, n_lanes):
    """andix's encoding of the same events from zero-filled int64 buffers;
    an odd k takes andix's k + 1 (its pairing needs an even k)."""
    kk = k + (k % 2)
    a = np.zeros(kk, np.int64)
    b = np.zeros(kk, np.int64)
    e = ev[:, :cnt].astype(np.int64)
    a[:cnt] = (e[0] << 32) | e[3]
    b[:cnt] = (e[1] << 32) | e[2]
    out = jax.device_get(jevpack.encode_events(
        jnp.asarray(a), jnp.asarray(b), jnp.int32(cnt), kk, n_lanes))
    return [np.asarray(x) for x in out]


def _port(route, ev, cnt, k, n_lanes):
    """The port's encoding by ``route``: ``plain``, or the twin at the
    kernel's tile size (``twin``) or the tiny one (``twin-tiny``), its
    tiles in the order shuffled by seed 0, or by the seed a ``-s<seed>``
    suffix names."""
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in ev]
    if route == "plain":
        flat = evpack.encode_events_plain(*t, cnt, k, n_lanes)
    else:
        if shutil.which("g++") is None:
            pytest.skip("g++ is needed to build the kernel's host twin")
        base, _, seed = route.partition("-s")
        flat = evpack.encode_events_cpu_twin(*t, cnt, k, n_lanes,
                                             tiny=base == "twin-tiny",
                                             seed=int(seed or 0))
    assert flat.dtype == torch.int32
    assert flat.shape == (evpack.encoded_size(k, n_lanes),)
    return flat.numpy()


STREAMS = (["chainlike", "chainlike-odd", "all_escapes", "escape_overflow",
            "small", "small-odd", "empty", "tile_edges", "tile_edges-odd",
            "escape_tile", "esc_cap", "esc_cap_plus1", "empty_lanes",
            "wide_lanes"]
           + [f"dispatch{i}" for i in range(2)])
OVERFLOWS = ("escape_overflow", "esc_cap_plus1")


@pytest.mark.parametrize("route", ["plain", "twin", "twin-tiny",
                                   "twin-s7", "twin-tiny-s7"])
@pytest.mark.parametrize("name", STREAMS)
def test_encode_equals_andix(dispatches, name, route):
    ev, cnt, k, n_lanes = _stream(name, dispatches)
    ref = _andix(ev, cnt, k, n_lanes)
    flat = _port(route, ev, cnt, k, n_lanes)
    packed, esc, counts, n_esc, esc_ovf = evpack.split_encoded(flat, k,
                                                               n_lanes)
    kh = (k + 1) // 2
    # every packed word (andix's zero-filled padding is the port's), the
    # whole escape list (zeros past n_esc), counts and the two scalars
    assert (packed == ref[0][:, :kh]).all()
    assert (esc == ref[1]).all()
    assert (counts == ref[2]).all()
    assert int(n_esc) == int(ref[3]) and bool(esc_ovf) == bool(ref[4])
    assert bool(esc_ovf) == (name in OVERFLOWS)


@pytest.mark.parametrize("route", ["plain", "twin-tiny"])
@pytest.mark.parametrize("name", [s for s in STREAMS if s not in OVERFLOWS])
def test_decode_gives_the_lane_major_stream(dispatches, name, route):
    ev, cnt, k, n_lanes = _stream(name, dispatches)
    if route == "plain":  # the public tuple; CPU tensors take the plain
        packed, esc, counts, n_esc, esc_ovf = (
            x.numpy() for x in evpack.encode_events(
                *(torch.from_numpy(x.copy()) for x in ev), cnt, k, n_lanes))
    else:
        packed, esc, counts, n_esc, esc_ovf = evpack.split_encoded(
            _port(route, ev, cnt, k, n_lanes), k, n_lanes)
    assert packed.shape == (3, (k + 1) // 2) and counts.shape == (n_lanes,)
    assert not esc_ovf
    got = evpack.decode_events(packed, esc, counts, int(n_esc), cnt)
    order = np.argsort(ev[0, :cnt], kind="stable")
    for a, b in zip(got, ev[:, :cnt][:, order]):
        assert a.dtype == np.int32 and (a == b).all()


def test_decode_is_andix_s():
    """The port's decode is a copy of andix's numpy half."""
    import inspect

    for name in ("decode_events", "_runfill"):
        assert (inspect.getsource(getattr(evpack, name))
                == inspect.getsource(getattr(jevpack, name)))
    assert evpack.BIAS == jevpack.BIAS


def test_encode_refuses_bad_buffers():
    ev = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="ev_q"):
        evpack.encode_events_cpu_twin(ev[0], ev[1].long(), ev[2], ev[3], 4,
                                      16, 8)
    with pytest.raises(ValueError, match="cnt"):
        evpack.encode_events_cpu_twin(*ev, 17, 16, 8)


def _family(n, length, rates, seed):
    rng = np.random.default_rng(seed)
    base = NUCL[rng.integers(0, 4, length)]
    out = [("g0", base)]
    for k in range(1, n):
        codes = np.searchsorted(NUCL, base)
        hit = rng.random(length) < rates[(k - 1) % len(rates)]
        out.append((f"g{k}", NUCL[(codes + np.where(
            hit, rng.integers(1, 4, length), 0)) % 4]))
    return out


FAM = _family(3, 2000, [0.02, 0.1], 61)


def _grid(M, n=3):
    return np.array([[M[i][j].counts for j in range(n)] for i in range(n)])


@pytest.fixture(scope="module")
def jax_grid():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ANDIX_INDEX", "subject")
        m.setenv("ANDIX_SX_MESH", "0")
        m.setenv("ANDIX_CHAIN_SEGMENTS", "4")
        return _grid(jpipeline.calculate_matrix(
            [Seq(d, nm) for nm, d in FAM], JContext(), backend=JaxBackend()))


@pytest.mark.parametrize("cap", [None, 7, 1001])
@pytest.mark.parametrize("fetch", ["0", "1"])
def test_subject_grid_under_both_fetches(jax_grid, monkeypatch, fetch, cap):
    """The subject-index schedule under ``ANDIX_EVPACK=0`` (raw) and ``1``
    (packed) gives andix's grid, at the default cap and at odd caps (7
    overflows and hands the group to the joint schedule; 1001 finishes
    with an odd k); the packed fetch encodes every dispatch and the raw
    one none."""
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.setenv("ANDIX_CHAIN_SEGMENTS", "4")
    monkeypatch.setenv("ANDIX_EVPACK", fetch)
    if cap is not None:
        monkeypatch.setenv("ANDIX_EVENT_CAP", str(cap))
    ks, fetches = [], []
    orig_enc, orig_fetch = (evpack.encode_events_flat,
                            subject_pipeline._fetch_events)

    def encoding(*a):
        ks.append(a[5])
        return orig_enc(*a)

    def fetching(*a, **kw):
        fetches.append(a[1])
        return orig_fetch(*a, **kw)

    monkeypatch.setattr(evpack, "encode_events_flat", encoding)
    monkeypatch.setattr(subject_pipeline, "_fetch_events", fetching)
    got = pipeline.calculate_matrix([TSeq(d, nm) for nm, d in FAM],
                                    Context(), [torch.device("cpu")])
    assert (_grid(got) == jax_grid).all()
    assert len(ks) == (len(fetches) if fetch == "1" else 0)
    if cap == 1001 and fetch == "1":
        assert ks and all(k == 1001 for k in ks)
