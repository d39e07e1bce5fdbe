"""Suffix array and adjacent LCP by prefix doubling with ``torch.sort``
(counterpart of ``andix/esa/doubling.py``: ``sa_lcp_device``, its loop
``_sa_loop_traced`` and their helpers).

* **Wide initial ranks.**  Under the block-text contract (``packed=True``)
  the first sort already ranks ``base``-symbol prefixes: 12 symbols for
  up to 22 segments (``wide_base_width``), through one int64 key of
  dense symbol codes (``_initial_ranks``); width 4 through a clamped key
  where the alphabet check fails, width 1 for arbitrary texts.
* **Bucket-head ranks.**  A suffix's rank is the SA slot of the first
  member of its group, so "equal rank at width w" means "equal w-prefix",
  and splitting a group renumbers nothing outside it.
* **Tied-only tail rounds.**  Full-size rounds sort every position by
  (rank, rank k places on) while more than a quarter of the suffixes are
  tied; then only the tied SA slots are gathered, sorted and scattered
  back (``_bucketed_round``), until no tie is left.  The loop is driven
  from the host, with one readback of the tied count per round, so the
  tail buffer is cut to the exact tied count each round where ``andix``'s
  device loop keeps static power-of-two tiers (``_tail_tiers``); the
  rounds, ranks and SA are the same.
* **The capped level buffer.**  Every rank array that still has ties is
  kept as a row of the level buffer (``push``), at most L rows: L is what
  the text can need (``levels_needed``) cut by the caller's level budget.
  Rows are allocated as the rounds produce them, so a text that needs few
  levels holds few.  An input that needs more rows raises the overflow
  flag, the sorting goes on (the SA stays exact), and the caller takes
  the LCP on the host (``native.lcp_from_sa``).  ``andix`` caps the
  hybrid buffer at 14 rows to fit a TPU's HBM at 100M-symbol blocks; the
  port keeps no such cap (pass ``max_levels=14`` for ``andix``'s).
* **The LCP** (``sa_lcp_device``): ``hybrid`` (the block alphabet holds)
  walks the levels for the stride-16 PLCP samples only and fills every
  position from them (``esa.plcp``, a hand CUDA kernel); ``levels`` walks
  the levels for every position (``_lcp_from_level_buffer``).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import plcp

BASE_WIDTH = 4  # initial prefix width of the clamped packed key

# Contract for packed=True (the block texts): every non-padding symbol lies
# in [1, PACK_CLAMP - 2] (bytes 33..255 plus separators 256+seg, seg < ~760),
# and padding symbols are >= 2^20, strictly increasing, and form the text
# tail.  Arbitrary alphabets must use packed=False.
PACK_CLAMP = 1023
PAD_BASE = 1 << 20

# switch to tied-only rounds when the tied fraction falls below this
_BUCKET_FRAC = 0.25


def _fill_forward(changed: torch.Tensor, values: torch.Tensor):
    """out[t] = values[s] for the last s <= t with changed[s] (changed[0]
    is True), and the group number cumsum(changed) - 1 of each entry.
    ``andix`` takes a cummax of ``where(changed, values, ...)`` over
    ascending values; a cumsum and two index passes give the same
    without a sequential 1-D scan."""
    n = changed.shape[0]
    group = torch.cumsum(changed, 0, dtype=torch.int32) - 1
    firsts = torch.empty(n + 1, dtype=values.dtype, device=values.device)
    firsts[torch.where(changed, group, n)] = values  # slot n: a dump
    return firsts[group], group


def _tied_mask(same_prev: torch.Tensor) -> torch.Tensor:
    """Members of groups of two or more, from "equal to the previous"."""
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    return same_prev | same_next


def _heads_and_tied(sorted_keys: torch.Tensor, order: torch.Tensor):
    """Text-order bucket-head ranks and the tied count from sorted keys
    and their positions."""
    n = sorted_keys.shape[0]
    changed = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    changed[1:] = sorted_keys[1:] != sorted_keys[:-1]
    iota = torch.arange(n, dtype=torch.int32, device=order.device)
    head, _ = _fill_forward(changed, iota)
    tied = int(_tied_mask(~changed).sum())
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    rank[order] = head
    return rank, tied


def wide_base_width(nseg: int, alphabet_ok: bool) -> int:
    """Initial-rank width of the dense-code key: the block alphabet
    {!,#,;,A,C,G,T} maps to codes 1..7, separators 256+g to 8+g, padding
    to the reserved top code, so a symbol needs ceil(log2(nseg + 10))
    bits and floor(62/bits) of them fill one positive int64 key.  Capped
    at 12 — the level-walk remainder is closed by two 6-symbol packed-word
    probes (``_lcp_from_level_buffer``).  BASE_WIDTH when the alphabet
    check fails."""
    if not alphabet_ok:
        return BASE_WIDTH
    bits = max(4, (nseg + 9).bit_length())
    return max(BASE_WIDTH, min(62 // bits, 12))


def _initial_ranks(sym: torch.Tensor, packed: bool = False,
                   base: int = BASE_WIDTH):
    """Initial prefix ranks: width 1 (exact, any alphabet), width
    BASE_WIDTH via one clamped int64 key (packed, base == BASE_WIDTH), or
    width ``base`` in 5..12 via the dense-code key (packed, block
    alphabet; ``wide_base_width``).

    Clamped key: the full symbol (separators and the increasing padding
    stay exactly ordered) above the next three symbols clamped to 10
    bits; clamping only merges orders of tail padding, whose windows are
    unique per position.  Dense-code key: real symbols map injectively
    and in order to small codes, ``base`` of them packed big-endian;
    padding positions take a disjoint upper band ordered by position.
    Two real windows that reach the padding hold the text's final unique
    separator at different offsets, so no false tie exists.

    Returns (rank int32 text order, tied count, order int32 = the SA
    sorted by the prefix)."""
    s = sym.to(torch.int64)
    n = s.shape[0]
    if not packed:
        key = s
    elif base > BASE_WIDTH:
        bits = 62 // base
        maxcode = (1 << bits) - 1
        c = torch.where(s == 65, 4, 0)
        for byte, code in ((67, 5), (71, 6), (84, 7), (33, 1), (35, 2),
                           (59, 3)):
            c = torch.where(s == byte, code, c)
        c = torch.where(s >= 256, (8 + (s - 256)).clamp(max=maxcode), c)
        key = c.clone()
        for j in range(1, base):
            key = (key << bits) | plcp.shift_read(c, j)
        del c
        idx = torch.arange(n, dtype=torch.int64, device=s.device)
        key = torch.where(s >= PAD_BASE, (1 << 62) + idx, key)
        del idx
    else:
        key = s << 30
        for j, shift in ((1, 20), (2, 10), (3, 0)):
            key |= plcp.shift_read(s, j).clamp(max=PACK_CLAMP) << shift
    del s
    sorted_keys, order = torch.sort(key)
    del key
    rank, tied = _heads_and_tied(sorted_keys, order)
    return rank, tied, order.to(torch.int32)


def _doubling_round(rank: torch.Tensor, k: int):
    """Full-size round: sort every position by (rank, rank at +k; -1 past
    the end), both bucket-head ranks below n, packed into one int64 key.
    Returns (new_rank, tied, order int32)."""
    n = rank.shape[0]
    key = rank.to(torch.int64) * (n + 1)
    key2 = torch.zeros(n, dtype=torch.int64, device=rank.device)
    key2[: n - k] = rank[k:].to(torch.int64) + 1  # -1 + 1 past the end
    key += key2
    del key2
    sorted_keys, order = torch.sort(key)
    del key
    new_rank, tied = _heads_and_tied(sorted_keys, order)
    return new_rank, tied, order.to(torch.int32)


def _extract_tied(rank: torch.Tensor, sa: torch.Tensor):
    """The tied SA slots (ascending, int64) and their suffixes."""
    head = rank[sa]
    same_prev = torch.zeros_like(head, dtype=torch.bool)
    same_prev[1:] = head[1:] == head[:-1]
    slots = _tied_mask(same_prev).nonzero().squeeze(1)
    return slots, sa[slots]


def _bucketed_round(rank: torch.Tensor, sa: torch.Tensor,
                    slots: torch.Tensor, sa_vals: torch.Tensor, k: int):
    """One tail round over the tied slots only: sort them by (head, rank
    at +k), scatter the permutation into ``sa`` and the split groups'
    heads (the slot of each subgroup's first member) into ``rank``, both
    in place; then keep the still-tied subset.  Returns (tied, slots',
    sa_vals')."""
    n = rank.shape[0]
    head = rank[sa_vals]
    shifted = sa_vals + k
    key2 = torch.where(shifted < n, rank[shifted.clamp(max=n - 1)], -1)
    key = head.to(torch.int64) * (n + 1) + (key2.to(torch.int64) + 1)
    del head, shifted, key2
    sorted_keys, perm = torch.sort(key)
    del key
    sav_s = sa_vals[perm]
    changed = torch.ones_like(sorted_keys, dtype=torch.bool)
    changed[1:] = sorted_keys[1:] != sorted_keys[:-1]
    new_head, _ = _fill_forward(changed, slots.to(torch.int32))
    sa[slots] = sav_s
    rank[sav_s] = new_head
    same_prev = torch.zeros_like(changed)
    same_prev[1:] = new_head[1:] == new_head[:-1]
    keep = _tied_mask(same_prev).nonzero().squeeze(1)
    return keep.shape[0], slots[keep], sav_s[keep]


def levels_needed(length: int, packed: bool = False,
                  base: int | None = None) -> int:
    """Level-buffer rows that can never overflow: the initial width-base
    level plus one per doubling round until the width covers the text."""
    if base is None:
        base = BASE_WIDTH if packed else 1
    lv = 1
    w = base
    while w < length:
        w *= 2
        lv += 1
    return lv


def sa_loop(sym: torch.Tensor, packed: bool, L: int, base: int):
    """The doubling loop (``_sa_loop_traced``): full rounds while more
    than a quarter of the suffixes are tied, then tied-only rounds;
    every round's ranks go to row min(count, L - 1) of the level buffer,
    and a round that leaves ties counts a level, flagging the overflow
    once the count reaches L.  Returns (sa int32, levels: a list of at
    most L int32 [N] rows, level count, overflow); the rows below the
    level count are ``andix``'s, and a row the count never reaches (the
    last round's, which has no ties) is not kept."""
    n = sym.shape[0]
    thr0 = int(n * _BUCKET_FRAC)
    rank, tied, sa = _initial_ranks(sym, packed,
                                    base if packed else BASE_WIDTH)
    levels = [rank.clone()]
    lev_idx = 1
    ovf = False
    k = base

    def push(rank, tied):
        nonlocal lev_idx, ovf
        row = min(lev_idx, L - 1)
        if row < len(levels):
            levels[row].copy_(rank)
        elif tied > 0:
            levels.append(rank.clone())
        if tied > 0:
            ovf |= lev_idx >= L
            lev_idx += 1

    while tied > thr0 and k < n:
        rank, tied, sa = _doubling_round(rank, min(k, n))
        push(rank, tied)
        k = min(k * 2, 1 << 30)
    if tied > 0 and k < n:
        slots, sa_vals = _extract_tied(rank, sa)
        while tied > 0 and k < n:
            tied, slots, sa_vals = _bucketed_round(rank, sa, slots, sa_vals,
                                                   min(k, n))
            push(rank, tied)
            k = min(k * 2, 1 << 30)
    return sa, levels, lev_idx, ovf


def _lcp_from_level_buffer(sa, levels, lev_count, sym, base: int,
                           packed: bool = False) -> torch.Tensor:
    """Adjacent LCP from the level buffer, every position: top-down
    compare-and-advance per level (width base << r; rows at or above
    ``lev_count`` are skipped), then the sub-width remainder: two probes
    of a 6-symbol packed word (10-bit fields, symbols clamped to
    PACK_CLAMP) when packed, single-symbol compares otherwise.  Pad-vs-pad
    entries may differ from the true LCP (the clamp), and are never
    read."""
    n = sa.shape[0]
    a = torch.cat([sa[:1], sa[:-1]])
    b = sa
    h = torch.zeros(n, dtype=torch.int32, device=sa.device)

    def advance(rows):
        ai = a + h
        bi = b + h
        ok = (ai < n) & (bi < n)
        ra = rows[ai.clamp(max=n - 1)]
        rb = rows[bi.clamp(max=n - 1)]
        return ok, ra, rb

    # packed: the remainder's two 6-symbol probes cover 12 symbols, so
    # level 0 (width base) is skipped while 2 * base <= 12
    bottom = 1 if (packed and base <= 6) else 0
    for r in range(len(levels) - 1, bottom - 1, -1):
        if r < lev_count:
            ok, ra, rb = advance(levels[r])
            h = torch.where(ok & (ra == rb), h + (base << r), h)
    if packed:
        c = sym.clamp(max=PACK_CLAMP).to(torch.int64)
        w6 = torch.zeros(n, dtype=torch.int64, device=sym.device)
        for j in range(6):
            w6 |= plcp.shift_read(c, j) << (10 * (5 - j))
        for _ in range(2):  # remainder < 8 <= 6 + 6
            ok, wa, wb = advance(w6)
            lead = (plcp.clz64(wa ^ wb) - 4) // 10  # 6 when equal
            h = torch.where(ok, h + lead.clamp(max=6).to(torch.int32), h)
    else:
        for _ in range(base - 1):
            ok, ea, eb = advance(sym)
            h = torch.where(ok & (ea == eb), h + 1, h)
    h[0] = 0
    return h


def plan_levels(length: int, packed: bool, base: int,
                max_levels: int | None, want_lcp: bool,
                lcp_mode: str) -> tuple[int, bool]:
    """(L, may_overflow): the level buffer's rows, ``levels_needed`` cut
    by ``max_levels`` (in hybrid mode None or 0 means no cut), and whether
    the overflow flag can fire (always in hybrid mode, as in ``andix``:
    the PLCP kernels report entries they leave open)."""
    needed = levels_needed(length, packed, base)
    if want_lcp and lcp_mode == "hybrid":
        return max(1, min(needed, max_levels) if max_levels else needed), True
    L = min(needed, max_levels) if max_levels is not None else needed
    if not want_lcp:
        L = 1  # levels unused; keep the buffer at one row
    L = max(L, 1)
    return L, L < needed


def sa_lcp_device(sym: torch.Tensor, packed: bool = False,
                  max_levels: int | None = None, want_lcp: bool = True,
                  lcp_mode: str = "levels", base_width: int | None = None,
                  on_sa: Callable[[int, int], None] | None = None):
    """Suffix array + adjacent LCP of an int32 text on its device.

    ``lcp_mode="hybrid"`` (block texts with the block alphabet only, see
    ``esa.plcp``) takes the sampled-PLCP LCP over the level buffer;
    ``"levels"`` walks every position.  The buffer holds at most
    ``max_levels`` rows (the caller's level budget).
    ``on_sa(level count, L)`` is called between the two stages.

    Returns (sa, lcp, overflow, may_overflow): ``overflow`` is a 0-d bool
    tensor on the text's device — when True the input needed more levels
    than the buffer holds (or, in hybrid mode, the PLCP caps were hit):
    the SA is exact and the LCP must not be used (the caller takes the
    host LCP).  ``may_overflow`` False guarantees it cannot fire.  After
    an overflow of the SA loop itself the LCP stage is skipped (all
    zero)."""
    n = sym.shape[0]
    dev = sym.device
    if lcp_mode not in ("hybrid", "levels"):
        raise ValueError(f"lcp_mode {lcp_mode!r}: hybrid or levels")
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, torch.zeros((), dtype=torch.bool, device=dev), False
    base = base_width if (packed and base_width) else (
        BASE_WIDTH if packed else 1)
    L, may_overflow = plan_levels(n, packed, base, max_levels, want_lcp,
                                  lcp_mode)
    sa, levels, lev_count, ovf = sa_loop(sym, packed, L, base)
    if on_sa is not None:
        on_sa(lev_count, L)
    ovf_d = torch.tensor(ovf, device=dev)
    if not want_lcp:
        lcp = torch.zeros(0, dtype=torch.int32, device=dev)
    elif ovf:
        lcp = torch.zeros(n, dtype=torch.int32, device=dev)
    elif lcp_mode == "hybrid":
        lcp, ovf2 = plcp.plcp_lcp_hybrid(sym, sa, levels, lev_count, base)
        ovf_d = ovf_d | ovf2
    else:
        lcp = _lcp_from_level_buffer(sa, levels, lev_count, sym, base,
                                     packed)
    return sa, lcp, ovf_d, may_overflow
