"""Build, load and count the hand-written kernels in ``csrc/``.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` of each ``.cu``
file to an object, all started together, then one ``nvcc -shared`` link
into a shared library with a plain C interface, loaded with ctypes
(every pointer and the stream as ``c_void_p``).  The build runs at first
use, from the sources in this checkout, into the git-ignored ``_build/``
directory — nothing is compiled at import.  Editing any source or any
header under ``csrc/`` rebuilds.

``cpu_twin()`` builds the kernels' shared bodies (``flag_scan_tile.cuh``,
``walk_lane.cuh``, ``walk_sx_lane.cuh``, ``plcp_lane.cuh``,
``rmq_tile.cuh``, ``replay_lane.cuh``, ``evpack_lane.cuh``,
``bootstrap_lane.cuh``, ``doubling_tile.cuh``) with g++ into a small host library, so the
kernels' logic can be held to the JAX functions on a machine without a
card (each at the kernel's tile, window or run sizes and at tiny ones).

``launches`` counts, per kernel wrapper, the calls that launched the
kernel on the card (the plain versions never count); ``launches_by_card``
counts them per card index.  Both are bumped under a lock, and the
library is built and loaded under one, so worker threads on several cards
may launch at once.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from contextlib import contextmanager

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_SOURCES = ("flag_scan.cu", "chain_walk.cu", "walk_sx.cu", "plcp.cu",
                "rmq.cu", "replay.cu", "evpack.cu", "bootstrap.cu",
                "doubling.cu", "sa_sort.cu")
CPU_TWIN_SOURCES = ("flag_scan_cpu.cpp", "walk_cpu.cpp", "walk_sx_cpu.cpp",
                    "plcp_cpu.cpp", "rmq_cpu.cpp", "replay_cpu.cpp",
                    "evpack_cpu.cpp", "bootstrap_cpu.cpp", "doubling_cpu.cpp")
CUDA_LIB = os.path.join(BUILD_DIR, "libandix_torch_cuda.so")
CPU_TWIN_LIB = os.path.join(BUILD_DIR, "libandix_torch_walk_cpu.so")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]
# the resampler's float64 operations must round one by one, as its host
# twin's (g++ -ffp-contract=off) and its plain version's do
_NVCC_SOURCE_FLAGS = {"bootstrap.cu": ["-fmad=false"]}

launches = {"flag_scan": 0, "chain_walk_flat": 0, "chain_walk_flat_sx": 0,
            "plcp_lcp_hybrid": 0, "range_min_build": 0, "replay": 0,
            "evpack_encode": 0, "bootstrap_resample": 0, "sa_keys": 0,
            "sa_rerank": 0, "sa_pair_scatter": 0}
launches_by_card: dict[int, dict[str, int]] = {}

_cuda_lib = None
_cpu_twin = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()

# andix_chain_walk_flat's C signature (walk_lane.cuh, chain_walk.cu): the
# ISA, the text bytes and their length, the range-min tables and sizes,
# the row tables and their stride, lane arrays, scalar budgets, then the
# output buffers; the CUDA entry adds the stream, the host twin its
# window-size switch
_P, _I = ctypes.c_void_p, ctypes.c_int
_WALK_ARGTYPES = ([_P, _P, ctypes.c_int64] + [_P] * 7 + [_I] * 3
                  + [_P, _P, ctypes.c_int64] + [_P] * 11 + [_I] * 6
                  + [_P] * 10)
# andix_chain_walk_sx's (walk_sx_lane.cuh, walk_sx.cu): the index and query
# word pointers, their sizes and cache_k, lane arrays, scalar budgets, then
# the output buffers; the CUDA entry adds the stream
_SX_ARGTYPES = ([_P] * 5 + [ctypes.c_int64] * 3 + [_I] + [_P] * 9 + [_I] * 5
                + [_P] * 10)
# andix_plcp_hybrid's (plcp.cu): text, SA, the level rows' pointer table,
# L, level count, base width, N, the run length and tries, then the
# outputs; the CUDA entry adds the stream
_PLCP_ARGTYPES = [_P] * 3 + [_I] * 3 + [ctypes.c_int64] + [_I] * 2 + [_P] * 5
# andix_range_min_build's (rmq.cu): values, Np, the six outputs, tg's rows;
# the CUDA entry adds the stream, the host twin its tile-size switch
_RMQ_ARGTYPES = [_P, ctypes.c_int64] + [_P] * 6 + [_I]
# the head shared by the replay's entries (replay_lane.cuh, replay.cu):
# the walk's tables as for the flat walk, the per-subject and per-query
# lane arrays and the [Sg, G] query lengths, Sg, G, the segments K, the
# trail M, the exact flag and the chase.  andix_replay_cold adds the
# workspace, the error counter and the stream; andix_replay_splice the
# workspace, the counts, stats, splice counters, the error counter and
# the stream; the host twin (both passes) the same with its window-size
# switch in place of the stream
_REPLAY_ARGTYPES = ([_P, _P, ctypes.c_int64] + [_P] * 7 + [_I] * 3
                    + [_P, _P, ctypes.c_int64] + [_P] * 6 + [_I] * 6)
# andix_evpack_encode's (evpack_lane.cuh, evpack.cu): the sorted lanes,
# their slots, the q, s and len buffers, cnt, k, the lane count, esc_cap
# and the output; the CUDA entry adds its scratch and the stream, the host
# twin its block-size switch
_EVPACK_ARGTYPES = [_P] * 5 + [ctypes.c_int64] * 2 + [_I] * 2 + [_P]
# andix_sa_keys's (doubling.cu): the mode, the text or rank, the tail's
# suffixes and heads, m, n, k, the base width, the keys and the suffixes
# out, the part counts, the part shift and the parts; andix_sa_rerank's:
# the mode, m, the sorted keys and suffixes, slots, rank, sa, the changed
# bits, the three compaction outputs, the tied count, the pairs, the part
# shift and the parts, the part counts.  The CUDA entries add the stream
# (the rerank its scratch first), the host twin of the rerank its tile
# switch and the pairs' order
_SA_KEYS_ARGTYPES = ([_I, _P, _P, _P] + [ctypes.c_int64] * 3
                     + [_I, _P, _P, _P, _I, _I])
_SA_RERANK_ARGTYPES = [_I, ctypes.c_int64] + [_P] * 11 + [_I, _I, _P]


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
        launches_by_card.clear()


def count_launch(name: str, device: torch.device) -> None:
    """One launch of kernel ``name`` on ``device`` (a CUDA device)."""
    with _count_lock:
        launches[name] += 1
        card = launches_by_card.setdefault(device.index,
                                           dict.fromkeys(launches, 0))
        card[name] += 1


@contextmanager
def launch_on(device: torch.device):
    """Make ``device`` current for torch and for the kernel library, which
    links its own CUDA runtime, on this thread; yields torch's current
    stream there as the handle the C entries take."""
    with torch.cuda.device(device):
        check(cuda_lib().andix_set_device(device.index), "cudaSetDevice")
        yield torch.cuda.current_stream().cuda_stream


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _stale(lib: str, sources: list[str]) -> bool:
    """True when ``lib`` is missing or older than one of ``sources`` or of
    any header under ``csrc/``."""
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    deps = sources + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > t for s in deps)


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the compiler's output if
    one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def _tmp(suffix: str) -> str:
    fd, path = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return path


def _compile(cmd_head: list[str], sources: list[str], lib: str) -> None:
    """Run ``cmd_head + [-o tmp] + sources`` and move the result into
    place atomically (parallel processes may build at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _tmp(".so")
    try:
        _run([cmd_head + ["-o", tmp] + sources])
    except RuntimeError:
        os.unlink(tmp)
        raise
    os.replace(tmp, lib)


def build_cuda() -> str:
    """Compile the CUDA kernels for sm_90a, one nvcc per source, all at
    once, and link them; returns the library path."""
    sources = [os.path.join(CSRC, s) for s in CUDA_SOURCES]
    if _stale(CUDA_LIB, sources):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        objs = [_tmp(".o") for _ in sources]
        try:
            _run([[nvcc] + _NVCC_FLAGS
                  + _NVCC_SOURCE_FLAGS.get(os.path.basename(src), [])
                  + ["-c", src, "-o", obj]
                  for src, obj in zip(sources, objs)])
            _compile([nvcc] + _NVCC_FLAGS + ["-shared"], objs, CUDA_LIB)
        finally:
            for obj in objs:
                os.unlink(obj)
    return CUDA_LIB


def cuda_lib():
    """The loaded kernel library (built on first call)."""
    global _cuda_lib
    with _load_lock:
        if _cuda_lib is None:
            _cuda_lib = _load_cuda()
    return _cuda_lib


def _load_cuda():
    lib = ctypes.CDLL(build_cuda())
    lib.andix_flag_scan.argtypes = [_P, _P, _P, ctypes.c_int64, _I, _P, _P,
                                    _P, _P, _P, _P]
    lib.andix_flag_scan.restype = _I
    lib.andix_flag_scan_scratch_ints.argtypes = [ctypes.c_int64, _I]
    lib.andix_flag_scan_scratch_ints.restype = ctypes.c_int64
    lib.andix_chain_walk_flat.argtypes = _WALK_ARGTYPES + [_P]
    lib.andix_chain_walk_flat.restype = _I
    lib.andix_walk_diag_win.argtypes = []
    lib.andix_walk_diag_win.restype = _I
    lib.andix_chain_walk_sx.argtypes = _SX_ARGTYPES + [_P]
    lib.andix_chain_walk_sx.restype = _I
    lib.andix_plcp_hybrid.argtypes = _PLCP_ARGTYPES + [_P]
    lib.andix_plcp_hybrid.restype = _I
    lib.andix_range_min_build.argtypes = _RMQ_ARGTYPES + [_P]
    lib.andix_range_min_build.restype = _I
    lib.andix_replay_cold.argtypes = _REPLAY_ARGTYPES + [_P] * 3
    lib.andix_replay_cold.restype = _I
    lib.andix_replay_splice.argtypes = _REPLAY_ARGTYPES + [_P] * 6
    lib.andix_replay_splice.restype = _I
    lib.andix_replay_seg_ints.argtypes = [_I]
    lib.andix_replay_seg_ints.restype = _I
    lib.andix_evpack_encode.argtypes = _EVPACK_ARGTYPES + [_P] * 4
    lib.andix_evpack_encode.restype = _I
    lib.andix_evpack_pairs.argtypes = []
    lib.andix_evpack_pairs.restype = _I
    lib.andix_bootstrap_resample.argtypes = [_P, _I, _I, ctypes.c_uint, _P,
                                             _P]
    lib.andix_bootstrap_resample.restype = _I
    lib.andix_sa_keys.argtypes = _SA_KEYS_ARGTYPES + [_P]
    lib.andix_sa_keys.restype = _I
    lib.andix_sa_rerank_scratch_ints.argtypes = [ctypes.c_int64, _I]
    lib.andix_sa_rerank_scratch_ints.restype = ctypes.c_int64
    lib.andix_sa_rerank.argtypes = _SA_RERANK_ARGTYPES + [_P, _P]
    lib.andix_sa_rerank.restype = _I
    lib.andix_sa_pair_scatter.argtypes = [_P, ctypes.c_int64, _P, _P]
    lib.andix_sa_pair_scatter.restype = _I
    lib.andix_sa_sort_temp_bytes.argtypes = [ctypes.c_int64, _I]
    lib.andix_sa_sort_temp_bytes.restype = ctypes.c_int64
    lib.andix_sa_sort.argtypes = ([_P] * 4 + [ctypes.c_int64, _I, _P,
                                              ctypes.c_int64, _P, _P])
    lib.andix_sa_sort.restype = _I
    lib.andix_set_device.argtypes = [_I]
    lib.andix_set_device.restype = _I
    lib.andix_cuda_error_string.argtypes = [_I]
    lib.andix_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err:
        msg = cuda_lib().andix_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def cpu_twin():
    """The kernels' tile and lane bodies built for the host with g++."""
    global _cpu_twin
    with _load_lock:
        if _cpu_twin is None:
            _cpu_twin = _load_cpu_twin()
    return _cpu_twin


def _load_cpu_twin():
    sources = [os.path.join(CSRC, s) for s in CPU_TWIN_SOURCES]
    if _stale(CPU_TWIN_LIB, sources):
        _compile(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                  "-fPIC"], sources, CPU_TWIN_LIB)
    lib = ctypes.CDLL(CPU_TWIN_LIB)
    lib.andix_flag_scan_cpu_tiles.argtypes = [ctypes.c_int64, _I, _I]
    lib.andix_flag_scan_cpu_tiles.restype = ctypes.c_int64
    lib.andix_flag_scan_cpu.argtypes = [_P, _P, _P, ctypes.c_int64, _I, _P,
                                        _I, _P, _P, _P, _P, _P]
    lib.andix_flag_scan_cpu.restype = _I
    lib.andix_chain_walk_flat_cpu.argtypes = _WALK_ARGTYPES + [_I]
    lib.andix_chain_walk_flat_cpu.restype = _I
    lib.andix_walk_lce_cpu.argtypes = ([_P, _P, ctypes.c_int64] + [_P] * 7
                                       + [_I] * 4 + [_P] * 4 + [_I])
    lib.andix_walk_lce_cpu.restype = _I
    lib.andix_chain_walk_sx_cpu.argtypes = _SX_ARGTYPES + [_I]
    lib.andix_chain_walk_sx_cpu.restype = _I
    lib.andix_plcp_hybrid_cpu.argtypes = _PLCP_ARGTYPES
    lib.andix_plcp_hybrid_cpu.restype = _I
    lib.andix_plcp_pack_cpu.argtypes = [_P, _P, ctypes.c_int64, _P, _P]
    lib.andix_plcp_pack_cpu.restype = None
    lib.andix_plcp_read_cpu.argtypes = [_P, ctypes.c_int64, _P]
    lib.andix_plcp_read_cpu.restype = None
    lib.andix_range_min_build_cpu.argtypes = _RMQ_ARGTYPES + [_I]
    lib.andix_range_min_build_cpu.restype = _I
    lib.andix_replay_rows_cpu.argtypes = _REPLAY_ARGTYPES + [_P] * 5 + [_I]
    lib.andix_replay_rows_cpu.restype = _I
    lib.andix_replay_equal_cpu.argtypes = [_P, ctypes.c_int64,
                                           ctypes.c_int64, _I, _P]
    lib.andix_replay_equal_cpu.restype = _I
    lib.andix_replay_seg_ints_cpu.argtypes = [_I]
    lib.andix_replay_seg_ints_cpu.restype = _I
    lib.andix_evpack_encode_cpu.argtypes = _EVPACK_ARGTYPES + [_I]
    lib.andix_evpack_encode_cpu.restype = _I
    lib.andix_bootstrap_resample_cpu.argtypes = [_P, _I, _I, ctypes.c_uint,
                                                 _P, _P]
    lib.andix_bootstrap_resample_cpu.restype = _I
    lib.andix_sa_keys_cpu.argtypes = _SA_KEYS_ARGTYPES
    lib.andix_sa_keys_cpu.restype = _I
    lib.andix_sa_rerank_cpu.argtypes = _SA_RERANK_ARGTYPES + [_I, _I]
    lib.andix_sa_rerank_cpu.restype = _I
    lib.andix_sa_pair_scatter_cpu.argtypes = [_P, ctypes.c_int64, _P, _I]
    lib.andix_sa_pair_scatter_cpu.restype = _I
    return lib
