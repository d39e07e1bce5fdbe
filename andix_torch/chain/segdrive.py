"""The segmented walk driver, in compiled host code.

``segmented_group_anchors`` walks one subject group as ``andix``'s
``chain.segmented.segmented_group_anchors`` does, call for call and event
for event: the same lane arrays, iteration caps, event budgets and
dispatches handed to the same ``walk(arr, chunk_iters, maxev)`` callback,
and the same ``(lanes, q, s, len)`` arrays back.  What it does between the
dispatches runs in ``csrc/segdrive.cpp``, built with g++ into ``_build/``
on first use and bound with ``ctypes``, which releases the interpreter
lock for each call: the sublanes' geometry, entries, budgets and event
streams live in one driver object there, each dispatch's events go to
their sublanes in one counting pass over their lane ids, and pass 1, pass
2 and the resolve rounds run there.  Python keeps the loop around the
callback.  Each call counts ``walk.driver_native`` on the open span.

There is no other driver: where the library cannot be built, the call
raises a ``RuntimeError`` with the build's message.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from .. import native, spans

SOURCE = os.path.join(os.path.dirname(native.SOURCE), "segdrive.cpp")
LIB = os.path.join(native.BUILD_DIR, "libandix_segdrive.so")

# the lane arrays of a dispatch, in the library's row order
LANE_ARRAYS = ("row", "qoff", "qs", "ss", "rl", "thr", "seg_end", "pos0",
               "lq0", "ls0", "ll0", "maxev")

# The driver's parameters, read at each call.  They are andix's values,
# set for the TPU's dispatch limits: they fix the dispatch plan, and
# retuning them for the H100 is open work.
# events a repair walk may record before it must have merged with its
# segment's cold walk; the count-in-loop replay's trail takes the same
REPAIR_EVENTS = 12
# repair budgets extended this many times without a merge: walk the rest
# of the lane in one go (a lane without anchors to merge on)
MAX_EXTENSIONS = 2
# the first dispatch's iteration cap, doubled each dispatch up to the
# ceiling: small chunks early let finished lanes compact away
CHUNK_ITERS = 768
CHUNK_ITERS_MAX = 4096
# and a cap in seconds a dispatch, through an estimated cost a lane
# iteration: iteration cost grows with the lane count
CHUNK_BUDGET_S = 12.0
NS_PER_LANE_ITER = 900.0
# "no bound": the event budget of a cold walk, the threshold of a pad lane
BIG = 1 << 29
# the smallest lane bucket of a dispatch (buckets are powers of two)
MIN_LANES = 16

_lib = None
_load_error: str | None = None
_load_lock = threading.Lock()


def _load():
    """The loaded library, built on first use; raises ``RuntimeError``
    where it cannot be built or loaded."""
    global _lib, _load_error
    with _load_lock:
        if _lib is None and _load_error is None:
            try:
                _lib = _bind(ctypes.CDLL(native.build(SOURCE, LIB,
                                                      ("-O2", "-std=c++17"))))
            except (OSError, RuntimeError) as e:
                _load_error = str(e)
        if _lib is None:
            raise RuntimeError("segdrive: the segmented walk driver's "
                               f"library did not build:\n{_load_error}")
        return _lib


def _bind(lib):
    """Declare the library's functions."""
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.segdrive_new.argtypes = [ctypes.c_int64, ctypes.c_int64] + [
        i64p] * 7 + [f64p]
    lib.segdrive_new.restype = ctypes.c_void_p
    lib.segdrive_step.argtypes = [ctypes.c_void_p, i64p]
    lib.segdrive_step.restype = ctypes.c_int
    lib.segdrive_fill.argtypes = [ctypes.c_void_p, i32p]
    lib.segdrive_fill.restype = None
    lib.segdrive_absorb.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64,
                                    i32p, ctypes.c_int64, u8p]
    lib.segdrive_absorb.restype = ctypes.c_int
    lib.segdrive_result.argtypes = [ctypes.c_void_p] + [i32p] * 4
    lib.segdrive_result.restype = None
    lib.segdrive_free.argtypes = [ctypes.c_void_p]
    lib.segdrive_free.restype = None
    return lib


def available() -> bool:
    """Whether the driver's library built and loaded (building it now if
    it was not yet tried)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _i64(a, n: int, name: str) -> np.ndarray:
    out = np.ascontiguousarray(np.asarray(a).reshape(-1)[:n], dtype=np.int64)
    if out.shape[0] != n:
        raise ValueError(f"segdrive: {name} has fewer than {n} entries")
    return out


def segmented_group_anchors(walk, sg: int, gp: int, qb: int, subj_starts,
                            rs_lens, thresholds, q_base, q_start, q_len2d,
                            k: int, ecap: int):
    """Full segmented walk of one subject group (the arguments of
    ``andix``'s ``chain.segmented.segmented_group_anchors``; ``qb`` and
    ``ecap`` are the callback's business).

    Returns (ev_lane [s * gp + g ids], ev_q, ev_s, ev_len) int32 arrays in
    chain order per lane, or None when a dispatch's event buffer
    overflowed or the resolve did not converge (the caller falls back to
    the unsegmented paths).  An exception of the callback propagates, and
    a library that cannot be built raises ``RuntimeError``."""
    lib = _load()
    spans.count("walk.driver_native")
    geometry = (_i64(subj_starts, sg, "subj_starts"),
                _i64(rs_lens, sg, "rs_lens"),
                _i64(thresholds, sg, "thresholds"),
                _i64(q_base, gp, "q_base"), _i64(q_start, gp, "q_start"),
                _i64(q_len2d, sg * gp, "q_len2d"))
    ip = np.array([k, REPAIR_EVENTS, MAX_EXTENSIONS, CHUNK_ITERS,
                   CHUNK_ITERS_MAX, BIG, MIN_LANES], np.int64)
    dp = np.array([CHUNK_BUDGET_S, NS_PER_LANE_ITER], np.float64)
    h = lib.segdrive_new(sg, gp, *geometry, ip, dp)
    if not h:
        raise MemoryError("segdrive: the driver's state does not fit")
    try:
        out = np.zeros(3, np.int64)
        while True:
            rc = lib.segdrive_step(h, out)
            if rc == 0:
                break
            if rc == -1:
                # input-dependent worst case: fail soft like the event
                # overflow, to the unsegmented walk
                print("andix: segmented chain resolve did not converge "
                      f"after {int(out[0])} rounds; falling back to the "
                      "unsegmented walk.", file=sys.stderr)
                return None
            if rc != 1:
                raise MemoryError("segdrive: the driver's state does not fit")
            lb, chunk_iters, maxev = (int(x) for x in out)
            arr = np.empty((len(LANE_ARRAYS), lb), np.int32)
            lib.segdrive_fill(h, arr)
            ev, state, fin, _, ovf = walk(dict(zip(LANE_ARRAYS, arr)),
                                          chunk_iters, maxev)
            if ovf:
                return None
            ev = np.ascontiguousarray(ev, dtype=np.int32)
            state = np.ascontiguousarray(state, dtype=np.int32)
            fin = np.ascontiguousarray(fin, dtype=np.bool_).view(np.uint8)
            if (ev.ndim != 2 or ev.shape[0] != 4 or state.ndim != 2
                    or state.shape[0] != 4 or state.shape[1] < lb
                    or fin.shape[0] < lb):
                raise ValueError("segdrive: the walk returned events of "
                                 f"shape {ev.shape}, state {state.shape}, "
                                 f"fin {fin.shape} for {lb} lanes")
            if lib.segdrive_absorb(h, ev, ev.shape[1], state, state.shape[1],
                                   fin) != 0:
                raise MemoryError("segdrive: the driver's state does not fit")
        lanes, ev_q, ev_s, ev_len = np.empty((4, int(out[0])), np.int32)
        lib.segdrive_result(h, lanes, ev_q, ev_s, ev_len)
        return lanes, ev_q, ev_s, ev_len
    finally:
        lib.segdrive_free(h)
