"""Per-subject suffix-array index for the subject-index schedule
(counterpart of ``andix/esa/subject_index.py``).

One index per subject, queries streamed past it (andi's own design, one
``esa_init`` per subject, src/dist_hack.h:64).  Per subject: the suffix
array and adjacent LCP of ``RS + separator`` (padded to the group's
bucket length), the text's 4-bit order codes packed 16 to an int64 word
(big-endian), and an exact k-mer insertion-point cache.  The walk
(``chain.walk_sx``) bisects the suffix array with word compares, seeded
by the cache bracket.

Codes: query sentinel 0 < ``!`` 1 < ``#`` 2 < ``;`` 3 < A 4 < C 5 < G 6 <
T 7 < segment separator 8 < padding 9 — the order of the int32 symbols
the suffix array is sorted on, so nibble compares agree with SA order.
Queries hold only {ACGT, !, sentinel} and subjects only {bytes,
separator, padding}, so a compare stops at the true end of either side
without length caps.  Words whose top nibble is 8 or 9 are negative
int64 values.

* The numpy half (``order_codes_np`` .. ``query_codes_np``, and
  ``pick_cache_k``) is a verbatim copy of ``andix``'s, the host oracle.
* The device half is torch ops on the device of its input:
  ``device_order_codes``, ``pack_words`` (int32 symbols),
  ``pack_words_u8`` (query bytes), ``build_cache`` (one ``scatter_add_``
  histogram over the mixed-radix k-mer ranks, then a cumsum) and
  ``build_subject_index``, whose suffix array and LCP come from
  ``andix``'s build (``doubling.sa_lcp_device``: wide packed ranks, the
  sampled-PLCP LCP over the level rows the caller's budget holds) with
  its overflow flag; the caller takes the host Φ LCP of an overflowed
  subject.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import spans
from .joint import SEPARATOR_BASE

PAD_BASE = 1 << 20  # device_text / pad_symbols padding threshold

# byte -> order code (0 reserved for the query-end sentinel)
_BYTE_CODES = ((33, 1), (35, 2), (59, 3), (65, 4), (67, 5), (71, 6), (84, 7))
SEP_CODE = 8
PAD_CODE = 9


def _byte_lut() -> np.ndarray:
    lut = np.zeros(256, dtype=np.int32)
    for b, c in _BYTE_CODES:
        lut[b] = c
    return lut


_LUT = _byte_lut()


# ---------------------------------------------------------------------------
# NumPy reference implementation (oracle for the device kernel; also the
# host backend used by tests).
# ---------------------------------------------------------------------------


def order_codes_np(sym: np.ndarray) -> np.ndarray:
    """int32 symbols -> 4-bit order codes (see module docstring)."""
    sym = np.asarray(sym)
    c = np.where(
        sym >= PAD_BASE,
        PAD_CODE,
        np.where(sym >= SEPARATOR_BASE, SEP_CODE, _LUT[np.clip(sym, 0, 255)]),
    ).astype(np.int32)
    return c


def pack_words_np(codes: np.ndarray) -> np.ndarray:
    """4-bit codes -> int64 words of 16 codes, big-endian; length must be a
    multiple of 16."""
    assert len(codes) % 16 == 0
    q = codes.reshape(-1, 16).astype(np.int64)
    w = np.zeros(len(q), dtype=np.int64)
    for j in range(16):
        w |= q[:, j] << (4 * (15 - j))
    return w


@dataclasses.dataclass
class SubjectIndexNp:
    """One subject's search structures (host arrays)."""

    sa: np.ndarray  # int32[n_real] suffix array of RS + separator
    lcp: np.ndarray  # int32[n_real] adjacent LCP (lcp[0] = 0)
    codes: np.ndarray  # int32[n_real] order codes of the text
    n_real: int
    rs_len: int  # len(RS) = n_real - 1
    cache: np.ndarray | None = None  # int32[4^k + 1]
    cache_k: int = 0


def build_subject_index_np(rs: np.ndarray, cache_k: int = 0) -> SubjectIndexNp:
    """Host build: RS bytes -> (SA, LCP, codes[, cache]) over RS + one
    separator symbol."""
    from . import sa_numpy

    sym = np.concatenate(
        [np.asarray(rs, dtype=np.int32), [np.int32(SEPARATOR_BASE)]]
    )
    sa = sa_numpy.suffix_array(sym).astype(np.int32)
    lcp = sa_numpy.lcp_array(sym, sa).astype(np.int32)
    codes = order_codes_np(sym)
    idx = SubjectIndexNp(
        sa=sa, lcp=lcp, codes=codes, n_real=len(sym), rs_len=len(rs)
    )
    if cache_k:
        idx.cache = build_cache_np(sym, cache_k)
        idx.cache_k = cache_k
    return idx


def suffix_rank2(codes: np.ndarray, k: int) -> np.ndarray:
    """R2 rank of every suffix among ACGT k-mers: 2*R for suffixes whose
    k-prefix is itself an ACGT k-mer R, 2*R - 1 for mixed suffixes that
    sort between k-mers R-1 and R.  Vectorized mixed-radix accumulation
    truncated at the first non-ACGT symbol."""
    n = len(codes)
    c = np.concatenate([codes, np.full(k, PAD_CODE, np.int32)])
    R = np.zeros(n, dtype=np.int64)
    stopped = np.zeros(n, dtype=bool)
    for j in range(k):
        cj = c[j : j + n]
        f = np.clip(cj - 4, 0, 4).astype(np.int64)  # ACGT letters below cj
        R += np.where(stopped, 0, f << (2 * (k - 1 - j)))
        stopped |= (cj < 4) | (cj > 7)
    return 2 * R - stopped.astype(np.int64)


def build_cache_np(sym: np.ndarray, k: int) -> np.ndarray:
    """cache[c] = #suffixes < ACGT k-mer c (c in [0, 4^k)); cache[4^k] =
    n_real.  Shift ranks by +1 so mixed suffixes below every k-mer
    (R2 = -1: leading ``!``/``#``/``;``) land in a countable bin."""
    codes = order_codes_np(sym)
    r2s = suffix_rank2(codes, k) + 1  # in [0, 2*4^k]
    nk = 1 << (2 * k)
    hist = np.bincount(r2s, minlength=2 * nk + 1)
    cum = np.cumsum(hist)
    cache = np.zeros(nk + 1, dtype=np.int32)
    cache[:nk] = cum[0 : 2 * nk - 1 : 2]  # #{r2s <= 2c} = #{r2 < 2c}
    cache[nk] = len(sym)
    return cache


def _cmp_suffix_np(
    idx: SubjectIndexNp, qcodes: np.ndarray, qpos: int, spos: int, start: int
) -> tuple[int, bool]:
    """(lcp, q_less) of query suffix qpos vs subject suffix spos, starting
    the compare ``start`` symbols in.  qcodes must end with >= 1 sentinel
    (code 0)."""
    h = start
    nq = len(qcodes)
    ns = idx.n_real
    while True:
        qc = qcodes[qpos + h] if qpos + h < nq else 0
        sc = idx.codes[spos + h] if spos + h < ns else PAD_CODE
        if qc != sc:
            return h, qc < sc
        h += 1


def search_np(
    idx: SubjectIndexNp, qcodes: np.ndarray, qpos: int
) -> tuple[int, bool, int]:
    """(matchlen, unique, pos_s) of the query suffix at ``qpos`` against
    the subject — the reference ``get_match`` result
    (src/esa.c:614-624; uniqueness = interval i == j, src/process.c:118).
    Must agree exactly with ``matchstats_np.match_stats_sa_order``."""
    n = idx.n_real
    lo, hi = 0, n
    l_lo = l_hi = 0
    if idx.cache is not None:
        k = idx.cache_k
        win = qcodes[qpos : qpos + k]
        if len(win) == k and np.all((win >= 4) & (win <= 7)):
            code = 0
            for c in win:
                code = (code << 2) | int(c - 4)
            lo, hi = int(idx.cache[code]), int(idx.cache[code + 1])
    while lo < hi:
        mid = (lo + hi) >> 1
        off = min(l_lo, l_hi)
        lcp_m, q_less = _cmp_suffix_np(
            idx, qcodes, qpos, int(idx.sa[mid]), off
        )
        if q_less:
            hi, l_hi = mid, lcp_m
        else:
            lo, l_lo = mid + 1, lcp_m
    ip = lo
    a = b = -1
    if ip > 0:
        a, _ = _cmp_suffix_np(idx, qcodes, qpos, int(idx.sa[ip - 1]), l_lo)
    if ip < n:
        b, _ = _cmp_suffix_np(idx, qcodes, qpos, int(idx.sa[ip]), l_hi)
    ml = max(a, b, 0)
    if ml == 0 or a == b:
        unique = False
    elif a > b:
        unique = ip < 2 or int(idx.lcp[ip - 1]) < a
    else:
        unique = ip + 1 >= n or int(idx.lcp[ip + 1]) < b
    pos_s = int(idx.sa[ip - 1]) if a >= b else int(idx.sa[ip])
    return ml, unique, pos_s


def query_codes_np(query: np.ndarray) -> np.ndarray:
    """Query bytes -> order codes + one trailing sentinel."""
    q = np.concatenate(
        [np.asarray(query, dtype=np.int32), [np.int32(0)]]
    )
    return order_codes_np(q)


# ---------------------------------------------------------------------------
# Device build (torch)
# ---------------------------------------------------------------------------


def device_order_codes(sym: torch.Tensor) -> torch.Tensor:
    """int32 symbols -> int32 order codes, on the symbols' device."""
    lut = spans.upload(_LUT, sym.device)
    return torch.where(
        sym >= PAD_BASE,
        PAD_CODE,
        torch.where(sym >= SEPARATOR_BASE, SEP_CODE,
                    lut[sym.clamp(0, 255).long()]),
    ).to(torch.int32)


def _pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """4-bit codes -> big-endian int64 words of 16 codes (the length must
    be a multiple of 16)."""
    if codes.shape[0] % 16:
        raise ValueError(f"pack: {codes.shape[0]} codes is not a multiple "
                         f"of 16")
    q = codes.to(torch.int64).reshape(-1, 16)
    w = torch.zeros(q.shape[0], dtype=torch.int64, device=codes.device)
    for j in range(16):
        w |= q[:, j] << (4 * (15 - j))
    return w


def pack_words(sym: torch.Tensor) -> torch.Tensor:
    """Packed words of int32 symbols (a subject text)."""
    return _pack_codes(device_order_codes(sym))


def pack_words_u8(u8: torch.Tensor) -> torch.Tensor:
    """Packed words of uint8 bytes (the query blob: no separator or
    padding symbols), so the upload stays one byte per symbol."""
    return _pack_codes(device_order_codes(u8.to(torch.int32)))


def build_cache(codes: torch.Tensor, n_real: int, k: int) -> torch.Tensor:
    """int32[4^k + 1] k-mer insertion points (``build_cache_np``) from the
    order codes of a padded text whose first ``n_real`` symbols are real.

    A suffix's rank among the ACGT k-mers is a mixed-radix sum over its
    first k codes, cut at the first non-ACGT code (which decides the
    comparison against every k-mer): R2 = 2R for an ACGT prefix, 2R - 1
    for a mixed one.  Shifted by one, mixed suffixes below every k-mer land
    in bin 0, padding suffixes park on the top bin 2 * 4^k, which no entry
    reads; cache[c] is then the count of ranks <= 2c - 1."""
    dev = codes.device
    n = codes.shape[0]
    nk = 1 << (2 * k)
    cpad = torch.cat([codes, torch.full((k,), PAD_CODE, dtype=codes.dtype,
                                        device=dev)])
    r = torch.zeros(n, dtype=torch.int64, device=dev)
    stopped = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(k):
        cj = cpad[j: j + n]
        f = (cj - 4).clamp(0, 4).to(torch.int64)
        r += torch.where(stopped, 0, f << (2 * (k - 1 - j)))
        stopped |= (cj < 4) | (cj > 7)
    r2s = (2 * r - stopped.to(torch.int64) + 1).clamp(0, 2 * nk - 1)
    r2s[n_real:] = 2 * nk
    del r, stopped
    # int32 bins (counts stay below n): the histogram and its prefix sums
    # are each 2 * 4^k + 1 entries, 134 MB at k = 12
    hist = torch.zeros(2 * nk + 1, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, r2s, torch.ones(1, dtype=torch.int32,
                                         device=dev).expand(n))
    del r2s
    cum = torch.cumsum(hist, 0, dtype=torch.int32)
    del hist
    cache = torch.empty(nk + 1, dtype=torch.int32, device=dev)
    cache[:nk] = cum[0: 2 * nk - 1: 2]
    cache[nk:].fill_(n_real)
    return cache


def build_subject_index(sym: torch.Tensor, n_real: int, cache_k: int,
                        wide: bool = True, max_levels: int | None = None):
    """(sa int32[Lp], lcp int32[Lp], overflow 0-d bool, words int64[Lp /
    16], cache int32[4^k + 1]) of one padded subject text ``sym``
    (int32[Lp], real symbols first, then strictly increasing padding >=
    ``PAD_BASE``), as ``andix``'s ``fused_build``: packed initial ranks,
    12 symbols wide and the hybrid LCP when ``wide`` (the block alphabet
    holds), else 4 wide and the level walk; at most ``max_levels`` level
    rows (``andix`` keeps at most 14 in hybrid mode).  The LCP is not to
    be used when the overflow flag is set."""
    from . import doubling

    sa, lcp, ovf, _ = doubling.sa_lcp_device(
        sym, packed=True, max_levels=max_levels,
        lcp_mode="hybrid" if wide else "levels",
        base_width=doubling.wide_base_width(1, wide))
    codes = device_order_codes(sym)
    words = _pack_codes(codes)
    cache = build_cache(codes, n_real, cache_k)
    return sa, lcp, ovf, words, cache


def pick_cache_k(max_len: int, n_subjects: int, budget_bytes: int) -> int:
    """k-mer depth: deep enough that the average bracket is below ONE
    entry (4^k up to 16x the subject length — most probes then resolve
    with zero or one bisect step, which prices the latency-bound walk),
    shallow enough that all subjects' caches fit the budget."""
    k = 4
    while k < 12 and (1 << (2 * (k + 1))) <= max_len * 16:
        k += 1
    while k > 4 and n_subjects * ((1 << (2 * k)) + 1) * 4 > budget_bytes:
        k -= 1
    return k
