"""andix_torch flag scan: the plain version (what the CPU path runs)
against the JAX scan and the Pallas kernel (in interpret mode), exactly.
The CUDA kernel is held to the plain version on a card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from andix.esa import scans as jscans
from andix_torch import kernels
from andix_torch.esa import scans

torch.set_num_threads(2)

# (n, chunk) cases of tests/test_backend_jax.py::TestPallasFlagScan
CASES = [(5000, 1024), (1024, 1024), (70001, 1024), (333, 64), (64, 64)]


def _inputs(rng, n, flags="random"):
    vals = rng.integers(0, 100, n).astype(np.int32)
    if flags == "all":
        fl = np.ones(n, bool)
    elif flags == "none":
        fl = np.zeros(n, bool)
    else:
        fl = rng.random(n) < 0.1
    sa = rng.integers(0, n, n).astype(np.int32)
    return vals, fl, sa


def _port(vals, fl, sa, reverse=False):
    out = scans.flag_scan(torch.from_numpy(vals), torch.from_numpy(fl),
                          torch.from_numpy(sa), reverse=reverse)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("n,chunk", CASES)
def test_plain_equals_jax_and_pallas(rng, n, chunk):
    vals, fl, sa = _inputs(rng, n)
    args = (jnp.asarray(vals), jnp.asarray(fl), jnp.asarray(sa), chunk)
    ref = jscans.flag_scan(*args)
    pallas = jscans._flag_scan_pallas(*args, interpret=True)
    got = _port(vals, fl, sa)
    for a, b, c in zip(ref, pallas, got):
        assert (np.asarray(a) == c).all()
        assert (np.asarray(b) == c).all()


@pytest.mark.parametrize("flags", ["all", "none"])
def test_all_and_none_flagged(rng, flags):
    vals, fl, sa = _inputs(rng, 3000, flags)
    ref = jscans.flag_scan(jnp.asarray(vals), jnp.asarray(fl),
                           jnp.asarray(sa))
    for a, b in zip(ref, _port(vals, fl, sa)):
        assert (np.asarray(a) == b).all()


def test_reverse_equals_scan_of_reversed(rng):
    """reverse=True is the downward scan of the matching statistics
    (matchstats_jax.py:45-52): scan of the reversed arrays, reversed."""
    vals, fl, sa = _inputs(rng, 4097)
    ref = jscans.flag_scan(jnp.asarray(vals[::-1].copy()),
                           jnp.asarray(fl[::-1].copy()),
                           jnp.asarray(sa[::-1].copy()))
    got = _port(vals, fl, sa, reverse=True)
    for a, b in zip(ref, got):
        assert (np.asarray(a)[::-1] == b).all()


def test_empty_and_single(rng):
    for n in (0, 1):
        vals, fl, sa = _inputs(rng, n, "all")
        got = _port(vals, fl, sa)
        if n:
            ref = jscans.flag_scan(jnp.asarray(vals), jnp.asarray(fl),
                                   jnp.asarray(sa))
            for a, b in zip(ref, got):
                assert (np.asarray(a) == b).all()
        else:
            assert all(x.shape == (0,) for x in got)


def test_cpu_path_never_counts_a_launch(rng):
    before = dict(kernels.launches)
    _port(*_inputs(rng, 100))
    assert kernels.launches == before


# The kernel's tile body and look-back in the g++ host twin
# (csrc/flag_scan_tile.cuh): tiles of the kernel's 4096 positions and tiny
# ones of 64, tiles run in counter order.  Chains of tiles that publish
# only their aggregate make a later tile's look-back fold 1, 2 or 40 of
# them (40 spans two 32-tile windows) before it meets an inclusive prefix.
TWIN_TILE = {False: 4096, True: 64}


def _chains(tiles):
    """Aggregate-only tiles: a chain of 1, of 2 and of 40 predecessors."""
    agg = np.zeros(tiles, bool)
    agg[[3, 7, 8]] = True
    agg[12:52] = True
    return agg


# (n, flags, tiny tiles, aggregate-only chains)
TWIN_CASES = (
    [(1, "all", False, False), (1, "none", False, False)]
    + [(TWIN_TILE[tiny] + d, "random", tiny, False) for tiny in (False, True)
       for d in (-1, 0, 1)]
    + [(60 * 64 + 5, flags, True, chained)
       for flags in ("random", "all", "none") for chained in (False, True)]
    + [(60 * 4096 + 7, "random", False, chained) for chained in (False, True)]
)


@pytest.mark.parametrize("n,flags,tiny,chained", TWIN_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_cpu_twin_of_kernel_equals_plain_and_jax(rng, n, flags, tiny,
                                                 chained, reverse):
    vals, fl, sa = _inputs(rng, n, flags)
    tiles = scans.flag_scan_cpu_tiles(n, reverse, tiny)
    agg = torch.from_numpy(_chains(tiles)) if chained else None
    *got, status = scans.flag_scan_cpu_twin(
        torch.from_numpy(vals), torch.from_numpy(fl), torch.from_numpy(sa),
        reverse, agg, tiny)
    want_status = np.full(tiles, 2)
    if agg is not None:
        want_status[agg.numpy()] = 1
    assert (status.numpy() == want_status).all()
    got = [x.numpy() for x in got]
    plain = _port(vals, fl, sa, reverse)
    flip = (lambda x: x[::-1].copy()) if reverse else (lambda x: x)
    args = (jnp.asarray(flip(vals)), jnp.asarray(flip(fl)),
            jnp.asarray(flip(sa)))
    refs = [jscans.flag_scan(*args)]
    if n <= 70001:
        refs.append(jscans._flag_scan_pallas(*args, 1024, interpret=True))
    for a, b in zip(got, plain):
        assert (a == b).all()
    for ref in refs:
        for a, b in zip(ref, got):
            assert (flip(np.asarray(a)) == b).all()


def test_cpu_twin_tiles_mirror_in_reverse(rng):
    """In reverse the scan starts with padding up to a whole 16-position
    chunk (each chunk mirrors an aligned chunk of memory), so its tiles are
    those of n rounded up to a multiple of 16."""
    n = 4096 * 3 + 1
    assert scans.flag_scan_cpu_tiles(n, False) == 4
    assert scans.flag_scan_cpu_tiles(4096 * 3, True) == 3
    assert scans.flag_scan_cpu_tiles(4096 * 3 - 1, True) == 3
    assert scans.flag_scan_cpu_tiles(4096 * 3 + 1, True) == 4
    vals, fl, sa = _inputs(rng, n)
    got = scans.flag_scan_cpu_twin(torch.from_numpy(vals),
                                   torch.from_numpy(fl),
                                   torch.from_numpy(sa), True)
    for a, b in zip(got, _port(vals, fl, sa, True)):
        assert (a.numpy() == b).all()
