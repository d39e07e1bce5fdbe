"""ctypes bindings for the native host runtime, built for this package.

The package's own copy of the host counting source, ``csrc/host_native.cpp``
(held byte for byte equal to ``andix``'s by a test), is compiled with g++
into this package's git-ignored ``_build/`` directory on first use.
Two entries are bound here: ``count_from_anchors_batch`` (the 16-cell
counts from anchor events) and ``lcp_from_sa`` (the parallel Φ LCP the
ESA builds retreat to when the rank levels overflow).  ``available()``
reports whether the build worked; ``chain.events`` then falls back to its
exact Python counting, and the LCP retreat to ``esa.sa_numpy``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libandix_host.so")

_lib = None
_load_error: str | None = None


def build(source: str = SOURCE, lib: str = LIB,
          flags: tuple = ("-O3", "-march=native", "-fopenmp")) -> str:
    """Compile a host library (by default this one) from ``source`` into
    ``lib`` if missing or stale; returns its path."""
    if (
        os.path.exists(lib)
        and os.path.getmtime(lib) >= os.path.getmtime(source)
    ):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name and rename: parallel test workers may race
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, "-shared", "-fPIC", "-o", tmp, source]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{e.stderr}") from e
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("g++ not available for native build") from e
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as e:
        _load_error = str(e)
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.count_from_anchors_batch.argtypes = [
        i32p, i32p, i32p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, i64p,
        i64p, u8p, i64p, ctypes.c_int, ctypes.c_int, i64p,
    ]
    lib.count_from_anchors_batch.restype = None
    lib.lcp_from_sa.argtypes = [i32p, i32p, ctypes.c_int64, i32p, i32p, i32p,
                                ctypes.c_int]
    lib.lcp_from_sa.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def lcp_from_sa(sym: np.ndarray, sa: np.ndarray, threads: int = 0) -> np.ndarray:
    """Adjacent LCP array via the native parallel Φ algorithm."""
    lib = _load()
    assert lib is not None
    n = len(sa)
    sym = np.ascontiguousarray(sym, dtype=np.int32)
    sa = np.ascontiguousarray(sa, dtype=np.int32)
    lcp = np.empty(n, dtype=np.int32)
    phi = np.empty(n, dtype=np.int32)
    plcp = np.empty(n, dtype=np.int32)
    lib.lcp_from_sa(sym, sa, n, lcp, phi, plcp, threads)
    return lcp


def count_from_anchors_batch(
    ev_q: np.ndarray,
    ev_s: np.ndarray,
    ev_len: np.ndarray,
    bounds: np.ndarray,
    sg: int,
    g: int,
    subjects_rs: list,
    thresholds,
    query_blob: np.ndarray,
    q_off: np.ndarray,
    exact_counts: bool,
    threads: int = 0,
) -> np.ndarray:
    """16-cell counts for every lane of a subject group from its anchor
    events (lane-sorted, chain order).  Returns int64[sg, g, 16]."""
    lib = _load()
    assert lib is not None
    rs_off = np.zeros(sg + 1, dtype=np.int64)
    parts = []
    for k in range(sg):
        rs = subjects_rs[k] if k < len(subjects_rs) else None
        ln = 0 if rs is None else len(rs)
        rs_off[k + 1] = rs_off[k] + ln
        if ln:
            parts.append(np.ascontiguousarray(rs, dtype=np.uint8))
    rs_blob = (
        np.concatenate(parts) if parts else np.zeros(1, dtype=np.uint8)
    )
    thr = np.zeros(sg, dtype=np.int64)
    for k in range(min(sg, len(thresholds))):
        thr[k] = int(thresholds[k])
    counts = np.zeros((sg, g, 16), dtype=np.int64)
    qb = np.zeros(len(q_off), dtype=np.int64)
    qb[:] = q_off
    query_blob = np.ascontiguousarray(query_blob, dtype=np.uint8)
    if len(query_blob) == 0:
        query_blob = np.zeros(1, dtype=np.uint8)
    lib.count_from_anchors_batch(
        np.ascontiguousarray(ev_q, dtype=np.int32),
        np.ascontiguousarray(ev_s, dtype=np.int32),
        np.ascontiguousarray(ev_len, dtype=np.int32),
        np.ascontiguousarray(bounds, dtype=np.int64),
        sg, g, rs_blob, rs_off, thr, query_blob, qb,
        1 if exact_counts else 0, threads, counts.reshape(-1),
    )
    return counts
