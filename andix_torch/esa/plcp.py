"""Sampled-PLCP adjacent LCP from the rank levels and 16-symbol packed
words (counterpart of ``andix/esa/plcp.py``: ``plcp_lcp_hybrid_traced``
with ``_ladder`` and ``_fill_from_samples``; the hybrid mode only).

* ``w16[i]`` packs the 4-bit classes of ``sym[i..i+15]`` big-endian: the
  block alphabet {A,C,G,T,!,#,;} gets distinct non-zero codes, separators,
  padding and positions past the end code 0 ("special").  Two special
  positions never hold equal symbols, so one word compare
  (``_word_m``) advances exactly to the first differing or both-special
  nibble, or by 16.
* Samples: PLCP[i] = lcp(suffix i, suffix phi(i)), phi(i) = SA[ISA[i]-1],
  from scratch on the stride-16 grid: a top-down walk over the level
  rows (width ``base << r``), then word probes.
* Fill: every position starts from the Kasai bound PLCP[i] >=
  PLCP[16 * (i >> 4)] - (i & 15); a probe that agrees on all 16 symbols
  makes a survivor, which goes on probing from h = 16.
* ``lcp[t] = PLCP[SA[t]]``, ``lcp[0] = 0``.

The level buffer comes as a list of int32 [N] rows (or one [L, N]
tensor), row r of width ``base << r``; the kernels read it through a
table of row pointers, so the rows need not be one allocation.

An entry's probes are capped as in ``andix``: PASS_CAP probes, with a
walk over the level rows before probe LADDER_PRE.  An entry still open
after them raises the overflow flag; the LCP is then not to be used, and
the caller takes the host LCP, as ``andix`` does.  With every level row
an entry is done by its first probe after the walk, so the cap only
bites when rows are missing.  ``andix`` also raises the flag when more
than max(N / 2, 8192) entries survive the first fill probe, because its
fill buffer holds no more; the port probes every survivor, so it has no
such limit and no such flag.

``plcp_lcp_hybrid`` launches the hand CUDA kernels (``csrc/plcp.cu``,
per-entry bodies in ``csrc/plcp_lane.cuh``) for a CUDA tensor and runs
the plain version ``plcp_lcp_hybrid_plain`` for a CPU tensor;
``plcp_lcp_hybrid_cpu_twin`` runs the kernels' bodies built with g++.
Entries the caps leave open keep what ``andix``'s buffers hold for them
(0 for a sample, the Kasai bound for a survivor).

The kernels probe a 4-bit packed text (``pack_text_plain``: 16 codes to
an int64 word, N / 16 + TEXT_PAD words) in place of ``w16``, and take the
samples in runs of ``CHAIN``: a run's later samples start from the Kasai
bound of the one before and walk the level rows only when ``TRIES``
probes do not find a PLCP that ``andix``'s walk would close at its first
probe; samples whose outcome needs ``andix``'s capped schedule go to a
second pass (``plcp_lane.cuh`` gives the rules).  The outcome is
``andix``'s, entry by entry, for any run length.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels, spans

# block-text alphabet (joint.py + sequence.normalize): real symbols
_CODES = ((65, 1), (67, 2), (71, 3), (84, 4), (33, 5), (35, 6), (59, 7))
ALPHABET_U8 = frozenset((0, 33, 35, 59, 65, 67, 71, 84))

LADDER_PRE = 64  # word probes before the level walk (h grows by 1024)
# andix's probe cap: after the walk, a remainder below its 4096-symbol
# walk granularity needs at most 4096 / 16 more probes
PASS_CAP = LADDER_PRE + 4096 // 16 + 8
_M7 = 0x7777777777777777
# the kernels' sample runs: samples a thread, probes a chained sample gets
# before it walks; the host twin also runs tiny ones
CHAIN, TRIES = 16, 8
TINY_CHAIN, TINY_TRIES = 2, 1
TEXT_PAD = 2  # words of zeros past the packed text (PLCP_TEXT_PAD)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of each int64 (64 for 0), exactly: each 32-bit
    half converts to float64 exactly, and its binary exponent gives its
    top bit."""
    def clz32(u):
        return 32 - torch.frexp(u.to(torch.float64)).exponent

    hi = (x >> 32) & 0xFFFFFFFF
    return torch.where(hi != 0, clz32(hi), 32 + clz32(x & 0xFFFFFFFF))


def shift_read(x: torch.Tensor, j: int) -> torch.Tensor:
    """x[i + j], 0 past the end."""
    out = torch.zeros_like(x)
    if j < x.shape[0]:
        out[: x.shape[0] - j] = x[j:]
    return out


def _word_m(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Symbols of agreement of two packed words: the index of the first
    differing nibble or of the first both-special (code 0) nibble; 16 when
    they agree with no mutual special."""
    d = clz64(wa ^ wb) >> 2
    z = wa | wb
    zn = (~(((z & _M7) + _M7) | z)) & ~_M7  # bit 3 of each zero nibble
    return torch.minimum(d, clz64(zn) >> 2).to(torch.int32)


def _codes(sym: torch.Tensor) -> torch.Tensor:
    """int64[N] 4-bit class of each symbol (0: separator, padding)."""
    c = torch.zeros(sym.shape[0], dtype=torch.int64, device=sym.device)
    for byte, code in _CODES:
        c = torch.where(sym == byte, code, c)
    return c


def _build_w16(sym: torch.Tensor) -> torch.Tensor:
    """int64[N] packed words, w16[i] = codes of sym[i..i+15] big-endian."""
    c = _codes(sym)
    p = (c << 4) | shift_read(c, 1)
    p = (p << 8) | shift_read(p, 2)
    p = (p << 16) | shift_read(p, 4)
    return (p << 32) | shift_read(p, 8)


def pack_text_plain(sym: torch.Tensor) -> torch.Tensor:
    """The kernels' packed text: int64 [N / 16 + TEXT_PAD], word k the
    codes of ``sym[16 k .. 16 k + 15]`` big-endian (``w16[16 k]``), then
    TEXT_PAD words of zeros (a probe reads the word after its own; two
    keep the length even)."""
    n = sym.shape[0]
    if n % 16:
        raise ValueError(f"plcp: {n} symbols is not a multiple of 16")
    shifts = torch.arange(60, -4, -4, dtype=torch.int64, device=sym.device)
    words = (_codes(sym).view(-1, 16) << shifts).sum(dim=1)
    return torch.cat([words, words.new_zeros(TEXT_PAD)])


def _walk(levels, lev_cnt, base, a, b, h):
    """Top-down level walk: for each row r < lev_cnt, from the top, equal
    ranks at (a + h, b + h) advance h by base << r."""
    for r in range(len(levels) - 1, -1, -1):
        if r >= lev_cnt:
            continue
        row = levels[r]
        n = row.shape[0]
        ia, ib = a + h, b + h
        ok = (ia < n) & (ib < n)
        eq = row[ia.clamp(max=n - 1)] == row[ib.clamp(max=n - 1)]
        h = torch.where(ok & eq, h + min(base << r, 1 << 30), h)
    return h


def _ladder(w16, levels, lev_cnt, base, a, b, h):
    """Word probes of every entry from h on, the level walk before probe
    LADDER_PRE, at most PASS_CAP probes.  Returns (h + m of each entry, 0
    where still open; the number still open)."""
    n = w16.shape[0]
    out = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    idx = torch.arange(a.shape[0], device=a.device)
    for p in range(PASS_CAP):
        if idx.numel() == 0:
            break
        if p == LADDER_PRE:
            h = _walk(levels, lev_cnt, base, a, b, h)
        m = _word_m(w16[(a + h).clamp(max=n - 1)],
                    w16[(b + h).clamp(max=n - 1)])
        fin = m < 16
        out[idx[fin]] = (h + m)[fin]
        keep = ~fin
        idx, a, b, h = idx[keep], a[keep], b[keep], h[keep] + 16
    return out, idx.numel()


def _check(sym, sa, rows, device_type):
    n = sym.shape[0]
    if n % 16:
        raise ValueError(f"plcp: {n} symbols is not a multiple of 16")
    if n >= 1 << 31:
        raise ValueError("plcp: more than 2^31 - 1 symbols")
    for name, t in [("sym", sym), ("sa", sa)] + [
            (f"levels[{r}]", row) for r, row in enumerate(rows)]:
        if t.device != sym.device or t.device.type != device_type:
            raise ValueError(f"plcp: {name} must be on the "
                             f"{device_type.upper()} device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plcp: {name} must be contiguous int32")
        if t.shape != (n,):
            raise ValueError(f"plcp: {name} must have shape [{n}], got "
                             f"{tuple(t.shape)}")
    for name, t in (("sym", sym), ("sa", sa)):
        if t.data_ptr() % 16:
            raise ValueError(f"plcp: {name} must start on a 16-byte "
                             f"boundary")


def _row_table(rows, device) -> torch.Tensor:
    """int64 [L] addresses of the level rows, on ``device``."""
    return spans.upload(torch.tensor([r.data_ptr() for r in rows],
                                     dtype=torch.int64), device)


def plcp_lcp_hybrid_plain(sym: torch.Tensor, sa: torch.Tensor,
                          levels: torch.Tensor, lev_cnt: int,
                          base_width: int = 4):
    """Plain PyTorch version: (lcp int32[N], overflow 0-d bool)."""
    levels = list(levels)
    n = sym.shape[0]
    dev = sym.device
    if n % 16:
        raise ValueError(f"plcp: {n} symbols is not a multiple of 16")
    w16 = _build_w16(sym)
    sa64 = sa.to(torch.int64)
    phi = torch.empty(n, dtype=torch.int32, device=dev)
    phi[sa64[1:]] = sa[:-1]
    phi[sa64[:1]] = -1

    # samples: level walk, then word probes seeded at the walk's h
    ns = n // 16
    i_s = torch.arange(ns, dtype=torch.int32, device=dev) * 16
    alive_s = phi[::16] >= 0
    a_s = phi[::16].clamp(min=0)
    h = _walk(levels, lev_cnt, base_width, a_s[alive_s], i_s[alive_s],
              torch.zeros(int(spans.readback(alive_s.sum())),
                          dtype=torch.int32, device=dev))
    s_alive, left_s = _ladder(w16, levels, lev_cnt, base_width,
                              a_s[alive_s], i_s[alive_s], h)
    S = torch.zeros(ns, dtype=torch.int32, device=dev)
    S[alive_s] = s_alive

    # fill from the Kasai bound; survivors probe on from h = 16
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    lo = (S[iota >> 4] - (iota & 15)).clamp(min=0)
    alive_f = phi >= 0
    a_f = (phi.clamp(min=0) + lo).clamp(max=n - 1)
    b_f = (iota + lo).clamp(max=n - 1)
    m1 = _word_m(w16[a_f], w16[b_f])
    survivor = alive_f & (m1 == 16)
    n_surv = int(spans.readback(survivor.sum()))
    rel, left_f = _ladder(w16, levels, lev_cnt, base_width, a_f[survivor],
                          b_f[survivor],
                          torch.full((n_surv,), 16, dtype=torch.int32,
                                     device=dev))
    plcp = torch.where(alive_f, m1 + lo, 0)
    plcp[survivor] = rel + lo[survivor]
    lcp = plcp[sa64]
    lcp[0] = 0
    return lcp, torch.tensor(left_s + left_f > 0, device=dev)


def _outputs(n, device):
    """The kernels' outputs: the packed text int64 [N/16 + TEXT_PAD],
    sample phi and PLCP int32 [N/16], the counters (open samples, open
    survivors, samples deferred to andix's schedule) and the LCP."""
    return (torch.empty(n // 16 + TEXT_PAD, dtype=torch.int64,
                        device=device),
            torch.empty(n // 16, dtype=torch.int32, device=device),
            torch.empty(n // 16, dtype=torch.int32, device=device),
            torch.zeros(3, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device))


def _chain(rows, lev_cnt: int, base_width: int, chain: int) -> int:
    """Samples a run: one where the top row may hold a wider width than
    its own (``lev_cnt`` past the rows, an overflow of the SA loop) or the
    walk leaves more than a probe closes (base above 16)."""
    return chain if lev_cnt <= len(rows) and base_width <= 16 else 1


def plcp_lcp_hybrid(sym: torch.Tensor, sa: torch.Tensor, levels,
                    lev_cnt: int, base_width: int = 4):
    """(lcp int32[N], overflow 0-d bool tensor) of a block text ``sym``
    (int32[N], N a multiple of 16) from its SA and level rows (a list of
    int32 [N] rows or an [L, N] tensor; ``lev_cnt`` rows written; widths
    ``base_width << r``).  A CUDA tensor launches the kernels, a CPU
    tensor runs the plain version."""
    if sym.device.type == "cpu":
        return plcp_lcp_hybrid_plain(sym, sa, levels, lev_cnt, base_width)
    rows = list(levels)
    _check(sym, sa, rows, "cuda")
    n = sym.shape[0]
    text, sphi, S, counters, lcp = _outputs(n, sym.device)
    lib = kernels.cuda_lib()
    with kernels.launch_on(sym.device) as stream:
        table = _row_table(rows, sym.device)
        err = lib.andix_plcp_hybrid(
            sym.data_ptr(), sa.data_ptr(), table.data_ptr(), len(rows),
            lev_cnt, base_width, ctypes.c_int64(n),
            _chain(rows, lev_cnt, base_width, CHAIN), TRIES,
            text.data_ptr(), sphi.data_ptr(), S.data_ptr(),
            counters.data_ptr(), lcp.data_ptr(), stream)
    kernels.check(err, "plcp_lcp_hybrid")
    kernels.count_launch("plcp_lcp_hybrid", sym.device)
    return lcp, counters[:2].sum() > 0


def plcp_lcp_hybrid_cpu_twin(sym: torch.Tensor, sa: torch.Tensor, levels,
                             lev_cnt: int, base_width: int = 4,
                             tiny: bool = False, runs=None):
    """The kernels' per-entry bodies (``plcp_lane.cuh``) built for the host
    with g++ and run entry after entry, with the kernels' sample runs,
    (``tiny``) runs of 2 samples and 1 probe, or ``runs`` = (samples a
    run, probes; at most LADDER_PRE): (lcp, overflow, counters)."""
    rows = list(levels)
    _check(sym, sa, rows, "cpu")
    n = sym.shape[0]
    text, sphi, S, counters, lcp = _outputs(n, sym.device)
    table = _row_table(rows, sym.device)
    chain, tries = runs or ((TINY_CHAIN, TINY_TRIES) if tiny
                            else (CHAIN, TRIES))
    if not (chain >= 1 and 0 <= tries <= LADDER_PRE):
        raise ValueError(f"plcp: runs of {chain} samples, {tries} probes")
    kernels.cpu_twin().andix_plcp_hybrid_cpu(
        sym.data_ptr(), sa.data_ptr(), table.data_ptr(), len(rows), lev_cnt,
        base_width, ctypes.c_int64(n),
        _chain(rows, lev_cnt, base_width, chain), tries, text.data_ptr(),
        sphi.data_ptr(), S.data_ptr(), counters.data_ptr(), lcp.data_ptr())
    return lcp, counters[:2].sum() > 0, counters


def packed_reads_cpu_twin(sym: torch.Tensor):
    """The kernels' pack body and probe read built with g++: (the packed
    text int64 [N/16 + TEXT_PAD], the word a probe reads at every
    position int64 [N], ``w16``'s)."""
    n = sym.shape[0]
    if n % 16 or sym.dtype != torch.int32 or not sym.is_contiguous():
        raise ValueError("plcp: sym must be contiguous int32 [16 k]")
    text = torch.empty(n // 16 + TEXT_PAD, dtype=torch.int64)
    words = torch.empty(n, dtype=torch.int64)
    lib = kernels.cpu_twin()
    lib.andix_plcp_pack_cpu(sym.data_ptr(), None, ctypes.c_int64(n),
                            text.data_ptr(), None)
    lib.andix_plcp_read_cpu(text.data_ptr(), ctypes.c_int64(n),
                            words.data_ptr())
    return text, words
