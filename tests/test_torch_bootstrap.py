"""andix_torch device bootstrap against ``andix.bootstrap``: the plain
torch version (what the CPU runs) and the CUDA kernel's body built for
the host with g++ (the "CPU twin") hold the properties of
tests/test_model.py's device-bootstrap tests — per-pair totals kept
(also past 2^25), rounds that differ, seeded reruns that repeat, seeds
that differ, an all-zero pair that stays zero, cell means that track the
source — draw the same counts as each other exactly, and give cell means
and variances that agree, as andix's do, with the multinomial's n p and
n p (1 - p).  The two streams (Philox here, threefry in andix) cannot be
equal.  The kernel itself is held to the twin on a card by
tests/test_torch_cuda.py."""

import shutil

import numpy as np
import pytest
import torch

from andix import bootstrap as jbootstrap
from andix import model as jmodel
from andix_torch import bootstrap, model as mm
from andix_torch.device import DeviceError

CPU = torch.device("cpu")


def _make(c, seq_len, cls=mm.CountMatrix):
    return cls(np.asarray(c, dtype=np.int64), seq_len)


def _pairs(cls=mm.CountMatrix):
    """tests/test_model.py's two pairs."""
    c1 = np.zeros(16, dtype=np.int64)
    c1[mm.AtoA] = 85_000
    c1[mm.CtoC] = 5_000
    c1[mm.AtoG] = 7_000
    c1[mm.GtoG] = 3_000
    c2 = np.zeros(16, dtype=np.int64)
    c2[mm.TtoT] = 55_000
    c2[mm.TtoA] = 5_000
    return [_make(c1, 100_000, cls), _make(c2, 60_000, cls)]


def _mixed():
    """Pairs that reach every branch of the sampler: large and small
    means (BTRS and inversion), a cell holding most of the rest (p > 1/2,
    the flip), p = 1/2 exactly, a lone cell (p = 1), tiny totals, an
    all-zero pair and a total past 2^25."""
    rng = np.random.default_rng(29)
    out = _pairs()
    small = np.zeros(16, np.int64)
    small[[0, 3, 7, 12, 15]] = [3, 50, 1, 2, 9]
    out.append(_make(small, 70))
    lone = np.zeros(16, np.int64)
    lone[9] = 1234
    out.append(_make(lone, 1234))
    half = np.zeros(16, np.int64)  # p = 1/2 exactly, not flipped
    half[[2, 6, 11, 14]] = [4000, 4000, 4, 4]
    out.append(_make(half, 8008))
    out.append(mm.CountMatrix.zero(10))
    for _ in range(3):
        out.append(_make(rng.integers(0, 40, 16) * (rng.random(16) < 0.6),
                         600))
    big = np.zeros(16, np.int64)
    big[mm.AtoA] = (1 << 25) + 3
    big[mm.TtoT] = (1 << 24) + 1
    big[mm.AtoC] = 17
    out.append(_make(big, 1 << 25))
    return out


def _run(route, pairs, rounds, seed):
    if route == "twin":
        if shutil.which("g++") is None:
            pytest.skip("g++ is needed to build the kernel's host twin")
        counts = torch.from_numpy(np.stack([p.counts for p in pairs]))
        return bootstrap.resample_cpu_twin(counts, rounds, seed).numpy()
    return bootstrap.device_bootstrap_rounds(pairs, rounds, seed, CPU)


ROUTES = ["plain", "twin"]


@pytest.mark.parametrize("route", ROUTES)
def test_totals_preserved_and_reproducible(route):
    pairs = _pairs()
    out = _run(route, pairs, 5, 42)
    assert out.shape == (5, 2, 16) and out.dtype == np.int64
    totals = np.array([p.counts.sum() for p in pairs])
    assert (out.sum(axis=2) == totals[None, :]).all()
    assert (out >= 0).all()
    assert ((out > 0) <= (np.stack([p.counts for p in pairs]) > 0)).all()
    # rounds differ, reruns don't, seeds do
    assert not (out[0] == out[1]).all()
    assert (out == _run(route, pairs, 5, 42)).all()
    assert not (out == _run(route, pairs, 5, 43)).all()
    # the key is the seed's low 32 bits, as andix keys threefry
    assert (out == _run(route, pairs, 5, 42 + (1 << 32))).all()


@pytest.mark.parametrize("route", ROUTES)
def test_zero_pair_stays_zero(route):
    pairs = _pairs() + [mm.CountMatrix.zero(10)]
    out = _run(route, pairs, 3, 1)
    assert (out[:, 2, :] == 0).all()
    assert (out[:, :2].sum(axis=2) > 0).all()


@pytest.mark.parametrize("route", ROUTES)
def test_huge_totals_stay_exact(route):
    c = np.zeros(16, dtype=np.int64)
    c[mm.AtoA] = (1 << 25) + 3
    c[mm.TtoT] = (1 << 24) + 1
    out = _run(route, [_make(c, 1 << 25)], 2, 0)
    assert (out.sum(axis=2) == c.sum()).all()
    assert (out[:, 0, [mm.AtoA, mm.TtoT]] > 0).all()


@pytest.mark.parametrize("route", ROUTES)
def test_distribution_sane(route):
    pairs = _pairs()[:1]
    out = _run(route, pairs, 200, 7)
    mean = out[:, 0, :].mean(axis=0)
    np.testing.assert_allclose(mean, pairs[0].counts, rtol=0.02, atol=20)


def test_empty_and_no_rounds():
    assert bootstrap.device_bootstrap_rounds([], 4, 1, CPU).shape == (4, 0,
                                                                      16)
    out = bootstrap.device_bootstrap_rounds(_pairs(), 0, 1, CPU)
    assert out.shape == (0, 2, 16) and out.dtype == np.int64
    assert bootstrap.device_bootstrap_rounds(_pairs(), -3, 1).shape == (
        0, 2, 16)


def test_card_by_default(monkeypatch):
    """The entry point runs on the card unless the caller asks for the
    CPU: with no card it refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        bootstrap.device_bootstrap_rounds(_pairs(), 2, 0)


@pytest.mark.parametrize("seed", [0, 5, 2**40 + 77])
def test_plain_equals_twin(seed):
    """The plain version draws the twin's counts exactly, and does the
    same sampler work."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    pairs = _mixed()
    counts = torch.from_numpy(np.stack([p.counts for p in pairs]))
    tp, tt = {}, {}
    plain = bootstrap.resample_plain(counts, 200, seed, tp)
    twin = bootstrap.resample_cpu_twin(counts, 200, seed, tt)
    assert (plain == twin).all()
    assert tp == tt and min(tp.values()) > 0
    assert (plain.sum(dim=2) == counts.sum(dim=1)[None]).all()


def _warp_pairs(n):
    """``n`` pairs for the kernel's warp mapping: the mixed pairs tiled,
    and, when there is room, an all-zero pair, a lone cell (cc == mass
    at its cell) and a total near 2^52 (2^52 - 1: a cell of 2^41, one of
    12,345, one of 9, the rest in cell 0)."""
    mixed = [p.counts for p in _mixed()]
    if n == 1:
        return np.stack(mixed[:1])
    big = np.zeros(16, np.int64)
    big[[5, 10, 15]] = [1 << 41, 12_345, 9]
    big[0] = (1 << 52) - 1 - big.sum()
    lone = np.zeros(16, np.int64)
    lone[13] = 4321
    tail = [np.zeros(16, np.int64), lone, big]
    return np.stack([mixed[i % len(mixed)] for i in range(n - 3)] + tail)


@pytest.mark.parametrize("pairs", [1, 406])
@pytest.mark.parametrize("rounds", [1, 31, 33, 1000])
def test_twin_at_the_warp_mapping_equals_plain(pairs, rounds):
    """The twin runs the kernel's mapping (a pair's rounds 32 at a time,
    tail lanes masked); it draws the plain version's counts bit for bit
    at round counts below, just past and far past one warp."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's host twin")
    counts = torch.from_numpy(_warp_pairs(pairs))
    twin = bootstrap.resample_cpu_twin(counts, rounds, 31 + rounds)
    plain = bootstrap.resample_plain(counts, rounds, 31 + rounds)
    assert twin.shape == (rounds, pairs, 16)
    assert torch.equal(twin, plain)
    assert (twin.sum(dim=2) == counts.sum(dim=1)[None]).all()
    if pairs > 1:
        assert (twin[:, -3] == 0).all() and (twin[:, -2, 13] == 4321).all()
        assert (twin[:, -1, [1, 2, 3]] == 0).all()


def test_philox_known_answers():
    """Random123's known answers for Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = bootstrap.philox(*(torch.tensor(c) for c in ctr), *key)
        assert tuple(int(x) for x in got) == want


def _moments_within(out, counts, z=5.0):
    """Each cell's mean and variance over the rounds against the
    multinomial's n p and n p (1 - p), within z standard errors: of the
    mean sqrt(v / R); of the sample variance v sqrt((2 + (1 - 6 p q) /
    (n p q)) / R), the binomial's kurtosis; cells with p = 0 or 1 hold
    exactly."""
    rounds = out.shape[0]
    n = counts.sum(axis=1, keepdims=True).astype(np.float64)
    p = counts / np.maximum(n, 1)
    mu, v = n * p, n * p * (1 - p)
    mean = out.mean(axis=0)
    var = out.var(axis=0, ddof=1)
    fixed = v == 0
    assert (mean[fixed] == mu[fixed]).all() and (var[fixed] == 0).all()
    se_mean = np.sqrt(v / rounds)
    kurt = np.where(fixed, 0, (1 - 6 * p * (1 - p)) / np.where(fixed, 1, v))
    se_var = v * np.sqrt(np.maximum(2 + kurt, 0) / rounds)
    assert (np.abs(mean - mu) <= z * se_mean)[~fixed].all()
    assert (np.abs(var - v) <= z * se_var)[~fixed].all()


def test_cell_moments_agree_with_andix():
    """Over 200 rounds, the port's cell means and variances and andix's
    both lie within 5 standard errors of n p and n p (1 - p)."""
    pairs = [p for p in _mixed() if p.counts.sum() < 1 << 25]
    counts = np.stack([p.counts for p in pairs])
    port = bootstrap.device_bootstrap_rounds(pairs, 200, 11, CPU)
    jpairs = [jmodel.CountMatrix(p.counts.copy(), p.seq_len) for p in pairs]
    ref = jbootstrap.device_bootstrap_rounds(jpairs, 200, 11)
    assert port.shape == ref.shape
    _moments_within(port, counts)
    _moments_within(ref, counts)
