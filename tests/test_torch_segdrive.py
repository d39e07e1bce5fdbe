"""The port's segmented walk driver (``chain.segdrive``, its host code in
``csrc/segdrive.cpp``) against ``andix``'s (``andix.chain.segmented``,
imported here only as the oracle), on the CPU twins of both walk
kernels: the joint
schedule's ``chain_walk_flat`` with its events fetched raw (each
dispatch's lanes interleaved in buffer order) and the subject schedule's
``chain_walk_flat_sx`` with its events fetched packed (lane-major).  Both
drivers must make the same walk calls, every lane array, iteration cap and
event budget alike, and return byte-equal ``(lanes, q, s, len)``, or both
None."""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from andix.chain import segmented as jsegmented
from andix_torch import spans
from andix_torch import subject_pipeline as sxp
from andix_torch.chain import segdrive
from andix_torch.chain.replay_device import (LANE_FIELDS,
                                             chain_walk_flat_cpu_twin,
                                             fetch_walk, group_subject_tables)
from andix_torch.chain.walk_sx import (SX_LANE_FIELDS,
                                       chain_walk_flat_sx_cpu_twin)
from andix_torch.esa import joint
from andix_torch.esa.backend import CHASE, UNROLL, TorchBackend
from andix_torch.sequence import Seq, subject_init

torch.set_num_threads(2)

CPU = torch.device("cpu")
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
ECAP = 1 << 15


def _family(lengths, rates, seed, clonal=False):
    """Genomes from one ancestor of the longest length, each cut to its
    length and mutated at its rate; with ``clonal`` g1 = g0."""
    r = np.random.default_rng(seed)
    base = NUCL[r.integers(0, 4, max(lengths))]
    out = []
    for k, (length, rate) in enumerate(zip(lengths, rates)):
        codes = np.searchsorted(NUCL, base[:length])
        hit = r.random(length) < rate
        out.append(NUCL[(codes + np.where(hit, r.integers(1, 4, length),
                                          0)) % 4])
    if clonal:
        out[1] = out[0].copy()
    return [Seq(d, f"g{k}") for k, d in enumerate(out)]


FAMILIES = {
    "divergent": dict(lengths=[3000] * 4, rates=[0.0, 0.01, 0.05, 0.3],
                      seed=5),
    # g1 = g0, and g3 18% from them: some of its repairs at one event
    # never merge
    "clonal": dict(lengths=[10000] * 4, rates=[0.0, 0.0, 0.08, 0.18],
                   seed=6, clonal=True),
    # a 40 bp genome: at K = 64 its lanes have empty segments
    "short": dict(lengths=[2000, 2000, 40], rates=[0.0, 0.03, 0.0],
                  seed=9),
}


def _joint_group(seqs, ecap):
    """The joint block of ``seqs`` on the CPU: the flat walk's callback
    (the kernel's twin, events fetched raw) and the driver's arguments
    before ``k`` and ``ecap``."""
    subjects = [subject_init(s, 0.025) for s in seqs]
    layout = joint.build_block({i: s.rs for i, s in enumerate(subjects)}, {})
    be = TorchBackend(CPU, budget=1 << 30)
    ctx = be.prepare_block(layout)
    segs, starts, rs_lens, thresholds, q_len2d = be._group_tables(
        ctx, list(range(len(seqs))), dict(enumerate(subjects)))
    mlun, ps = group_subject_tables(ctx.sa, ctx.lcp, ctx.segid, ctx.tq,
                                    segs, starts)

    def walk(arr, chunk_iters, maxev):
        lanes = {f: torch.from_numpy(arr[f]) for f in LANE_FIELDS}
        return fetch_walk(chain_walk_flat_cpu_twin(
            ctx.isa, ctx.rm, ctx.text, mlun, ps, lanes, chunk_iters, maxev,
            ecap, CHASE, UNROLL))

    sg, gp = q_len2d.shape
    return walk, [sg, gp, ctx.tq.shape[0], starts, rs_lens, thresholds,
                  ctx.q_base_h, ctx.q_start_h, q_len2d]


def _subject_group(seqs, ecap):
    """The subject index of ``seqs`` on the CPU, as ``_process_group``
    builds it: the search walk's callback (the kernel's twin, events
    fetched packed) and the driver's arguments before ``k`` and
    ``ecap``."""
    subjects = [subject_init(s, 0.025) for s in seqs]
    n = len(seqs)
    raw, q_off, qw_base = sxp._host_query_blob(seqs, n)
    qw = sxp._pack_query_words(seqs, qw_base, CPU)
    cache_k = 3
    salcp, sw, cache2, nreal, _ = sxp._build_group_index(
        list(range(n)), subjects, cache_k, CPU, 1 << 30, 0)
    sg, gp = salcp.shape[0], max(8, -(-n // 8) * 8)
    qw_base_pad = np.zeros(gp, np.int32)
    qw_base_pad[:n] = qw_base
    rs_lens = np.ones(sg, np.int32)
    thresholds = np.full(sg, 2**29, np.int32)
    q_len2d = np.zeros((sg, gp), np.int32)
    for k in range(n):
        rs_lens[k] = subjects[k].len
        thresholds[k] = subjects[k].threshold
        q_len2d[k, :n] = q_off[1:] - q_off[:-1]
        q_len2d[k, k] = 0
    fetch = functools.partial(sxp._fetch_events, ecap=ecap)

    def walk(arr, chunk_iters, maxev):
        lanes = {f: torch.from_numpy(arr["qs" if f == "qwb" else f])
                 for f in SX_LANE_FIELDS}
        return fetch_walk(chain_walk_flat_sx_cpu_twin(
            salcp, sw, cache2, nreal, qw, lanes, chunk_iters, maxev, cache_k,
            ecap), fetch)

    return walk, [sg, gp, 0, np.zeros(sg, np.int32), rs_lens, thresholds,
                  qw_base_pad, qw_base_pad, q_len2d]


BUILD = {"joint": _joint_group, "subject": _subject_group}


@functools.lru_cache(maxsize=None)
def _built(family, schedule, ecap):
    return BUILD[schedule](_family(**FAMILIES[family]), ecap)


def _group(family, schedule, ecap=ECAP):
    """A group's callback and a fresh list of its driver arguments."""
    walk, args = _built(family, schedule, ecap)
    return walk, list(args)


class _Boom(Exception):
    pass


def _recording(walk, calls, tamper=None, fail_at=None):
    """``walk`` that keeps a copy of each call's lane arrays, iteration
    cap and event budget; ``tamper`` rewrites what it returns, and the
    call numbered ``fail_at`` raises."""
    def rec(arr, chunk_iters, maxev):
        assert type(chunk_iters) is int and type(maxev) is int
        # a probe longer than the chunk cap repeats a dispatch forever
        assert len(calls) < 2000, "the walk repeats a dispatch"
        calls.append(({f: np.array(arr[f]) for f in segdrive.LANE_ARRAYS},
                      chunk_iters, maxev))
        if len(calls) == fail_at:
            raise _Boom
        out = walk(arr, chunk_iters, maxev)
        return tamper(out, maxev) if tamper is not None else out
    return rec


def _drive(driver, walk, args, k, ecap=ECAP, **kw):
    calls = []
    res = driver(_recording(walk, calls, **kw), *args, k, ecap)
    return res, calls


def _assert_same(a, b):
    (res_a, calls_a), (res_b, calls_b) = a, b
    assert len(calls_a) == len(calls_b)
    for (arr_a, it_a, ev_a), (arr_b, it_b, ev_b) in zip(calls_a, calls_b):
        assert (it_a, ev_a) == (it_b, ev_b)
        for f in segdrive.LANE_ARRAYS:
            assert arr_a[f].dtype == arr_b[f].dtype == np.int32
            assert np.array_equal(arr_a[f], arr_b[f]), f
    assert (res_a is None) == (res_b is None)
    if res_a is not None:
        assert len(res_a) == len(res_b) == 4
        for x, y in zip(res_a, res_b):
            assert x.dtype == y.dtype == np.int32
            assert x.tobytes() == y.tobytes()


def _both(walk, args, k, ecap=ECAP, **kw):
    py = _drive(jsegmented.segmented_group_anchors, walk, args, k, ecap,
                **kw)
    cc = _drive(segdrive.segmented_group_anchors, walk, args, k, ecap, **kw)
    _assert_same(py, cc)
    return py


@pytest.fixture
def patched(monkeypatch):
    """Set driver parameters on both drivers alike."""
    def patch(**values):
        for name, value in values.items():
            monkeypatch.setattr(segdrive, name, value)
            monkeypatch.setattr(jsegmented, name, value)
    return patch


def test_the_library_builds():
    assert segdrive.available()


# segdrive's parameter -> andix's name for it
PARAMETERS = {"REPAIR_EVENTS": "REPAIR_EVENTS",
              "MAX_EXTENSIONS": "MAX_EXTENSIONS",
              "CHUNK_ITERS": "CHUNK_ITERS",
              "CHUNK_ITERS_MAX": "CHUNK_ITERS_MAX",
              "CHUNK_BUDGET_S": "CHUNK_BUDGET_S",
              "NS_PER_LANE_ITER": "NS_PER_LANE_ITER",
              "BIG": "BIG", "MIN_LANES": "_MIN_LANES"}


def test_parameters_are_andix_s():
    """The port's driver takes andix's parameters (its defaults: no
    environment variable of andix's is set here), type and value."""
    for ours, theirs in PARAMETERS.items():
        mine, want = getattr(segdrive, ours), getattr(jsegmented, theirs)
        assert type(mine) is type(want) and mine == want, ours


# (family, schedule, k, the drivers' parameters)
CASES = {
    "divergent-joint": ("divergent", "joint", 4, {}),
    "divergent-subject": ("divergent", "subject", 4, {}),
    "divergent-joint-k16": ("divergent", "joint", 16, {}),
    "clonal-joint": ("clonal", "joint", 8, {}),
    "clonal-subject": ("clonal", "subject", 8, {}),
    "continuations-joint": ("clonal", "joint", 8, dict(
        REPAIR_EVENTS=1, CHUNK_ITERS=4, CHUNK_ITERS_MAX=16)),
    # (the clonal lanes' probes need more than such caps on this index)
    "continuations-subject": ("divergent", "subject", 8, dict(
        REPAIR_EVENTS=1, CHUNK_ITERS=4, CHUNK_ITERS_MAX=64)),
    "seconds-cap-joint": ("divergent", "joint", 8, dict(
        CHUNK_BUDGET_S=3e-4, NS_PER_LANE_ITER=7)),
    "empty-segments-joint": ("short", "joint", 64, {}),
    "empty-segments-subject": ("short", "subject", 64, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_calls_and_events(case, patched):
    family, schedule, k, values = CASES[case]
    patched(**values)
    walk, args = _group(family, schedule)
    res, calls = _both(walk, args, k)
    assert res is not None and len(res[0]) > 0 and len(calls) >= 2
    if "continuations" in case:
        # lanes re-issued past their chunk cap or the dispatch's budget
        assert any(c[1] < 16 for c in calls) and sum(
            c[2] == 1 for c in calls) > 2
    if "empty" in case:
        qlen = args[-1]
        assert qlen[qlen > 0].min() < k


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_repairs_fall_back_to_the_rest_of_the_lane(schedule, patched,
                                                    monkeypatch):
    """At one repair event, repairs in the clonal family run out of
    extensions without a merge and walk the rest of their lane: andix's
    driver takes that path here, and the port's makes the same calls."""
    patched(REPAIR_EVENTS=1)
    made = []
    attempt = jsegmented._Attempt

    def recording(**kw):
        made.append(attempt(**kw))
        return made[-1]

    monkeypatch.setattr(jsegmented, "_Attempt", recording)
    walk, args = _group("clonal", schedule)
    _both(walk, args, 8)
    assert any(a.extensions > jsegmented.MAX_EXTENSIONS and a.end == 10000
               for a in made)


def test_lanes_without_a_query(patched):
    """Lanes of query length 0 walk nothing (the subject schedule has
    them on its diagonal; here off it on the joint schedule)."""
    walk, args = _group("divergent", "joint")
    q_len2d = args[-1].copy()
    q_len2d[0, 1] = 0
    q_len2d[2, :] = 0
    args[-1] = q_len2d
    res, _ = _both(walk, args, 4)
    gp = q_len2d.shape[1]
    assert not ({0 * gp + 1} | {2 * gp + g for g in range(gp)}) & set(
        res[0].tolist())


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_event_overflow_gives_none(schedule):
    walk, args = _group("divergent", schedule, ecap=8)
    res, calls = _both(walk, args, 4, ecap=8)
    assert res is None and calls


def _no_merge(out, maxev):
    """A cold walk's events (pass 1: every budget above the repairs')
    with s = -1, so no repair event meets one."""
    ev, *rest = out
    if maxev > 1 << 20 and ev.shape[1]:
        ev = ev.copy()
        ev[2] = -1
    return (ev, *rest)


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_resolve_that_does_not_converge(schedule, patched, capsys):
    patched(REPAIR_EVENTS=1, MAX_EXTENSIONS=10**9)
    walk, args = _group("divergent", schedule)
    res, _ = _both(walk, args, 4, tamper=_no_merge)
    assert res is None
    err = capsys.readouterr().err.splitlines()
    want = [line for line in err if "did not converge" in line]
    assert len(want) == 2 and want[0] == want[1]
    assert want[0].startswith("andix: segmented chain resolve did not "
                              "converge after 24 rounds")


@pytest.mark.parametrize("fail_at", [1, 3, 7])
def test_exception_in_the_walk_propagates(fail_at, patched):
    """The callback's exception (as ``_Stalled``) leaves the driver, in
    pass 1, pass 2 or a resolve round; the next call walks the group as
    andix's driver does."""
    patched(REPAIR_EVENTS=1)
    walk, args = _group("clonal", "joint")
    for driver in (jsegmented.segmented_group_anchors,
                   segdrive.segmented_group_anchors):
        with pytest.raises(_Boom):
            _drive(driver, walk, args, 8, fail_at=fail_at)
    _, calls = _both(walk, args, 8)
    assert len(calls) > 7


def _request_counts(prof_file, monkeypatch, fn):
    """The counters of a ``joint.walk`` span around ``fn()`` in a traced
    request."""
    monkeypatch.setenv("ANDIX_PROF_FILE", str(prof_file))
    with spans.request():
        with spans.span("joint.walk", kind=spans.NO_LINE):
            out = fn()
    walk = next(s for s in spans.REQUESTS[-1]["spans"]
                if s["name"] == "joint.walk")
    return out, {name: n for name, n in walk["counts"].items()
                 if name.startswith("walk.driver")}


def test_counter_and_build_failure(tmp_path, monkeypatch):
    """The driver counts ``walk.driver_native`` once a group; where its
    library cannot be built (its source is missing), the call raises with
    the build's message and counts nothing."""
    walk, args = _group("divergent", "subject")
    _, counts = _request_counts(
        tmp_path / "a.txt", monkeypatch,
        lambda: segdrive.segmented_group_anchors(walk, *args, 4, ECAP))
    assert counts == {"walk.driver_native": 1}

    monkeypatch.setattr(segdrive, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(segdrive, "LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(segdrive, "_lib", None)
    monkeypatch.setattr(segdrive, "_load_error", None)
    assert not segdrive.available()
    calls = []

    def failing():
        with pytest.raises(RuntimeError, match="did not build") as raised:
            segdrive.segmented_group_anchors(_recording(walk, calls), *args,
                                             4, ECAP)
        return raised.value

    err, counts = _request_counts(tmp_path / "b.txt", monkeypatch, failing)
    assert "missing.cpp" in str(err) and calls == [] and counts == {}


def test_drivers_in_threads(patched):
    """Eight threads, each walking the group with the port's driver at
    once (a callback that replays andix's driver's dispatches), under a
    short switch interval: every thread's calls and output are andix's
    driver's."""
    patched(REPAIR_EVENTS=2, CHUNK_ITERS=8, CHUNK_ITERS_MAX=64)
    walk, args = _group("divergent", "joint")
    outs = []

    def keeping(arr, chunk_iters, maxev):
        outs.append(walk(arr, chunk_iters, maxev))
        return outs[-1]

    want = _drive(jsegmented.segmented_group_anchors, keeping, args, 4)

    def replay():
        it = iter(outs)
        return lambda arr, chunk_iters, maxev: next(it)

    got = [None] * 8

    def run(t):
        got[t] = _drive(segdrive.segmented_group_anchors, replay(), args, 4)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for g in got:
        _assert_same(want, g)
