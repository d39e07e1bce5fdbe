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
* **The kernels.**  On a card every round is three or four calls:
  ``sa_keys`` (``csrc/doubling.cu``: the int64 keys and each entry's int32
  suffix in one pass; the initial keys from one read of the text; a tail
  round's from the head carried beside each tied suffix and one gather),
  CUB's radix sort of the pairs over the keys' bits (``csrc/sa_sort.cu``,
  the one library call, where ``andix`` has ``lax.sort``), ``sa_rerank``
  (one pass with a decoupled look-back: the bucket heads, SA, the tied
  count, a full round's changed bits, and in the tail rounds the
  still-tied entries compacted in order with their heads; the rank
  scatter direct, or on large texts binned by destination part into the
  sort's dead key buffer) and then ``sa_pair_scatter`` (the binned pairs
  into rank, a window that L2 holds at a time; ``_scatter_plan`` is the
  rule).  ``_extract_tied`` compacts the tied entries from the last full
  round's changed bits and SA, with no read of rank.  A full round
  writes the new ranks and SA over the old.  The ``*_plain`` functions
  are the torch version the CPU runs; ``Kernels(twin=True)`` runs the
  kernels' host twin (g++) on the CPU.
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

import ctypes
from contextlib import contextmanager
from typing import Callable

import torch

from .. import kernels, spans
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
    tied = int(spans.readback(_tied_mask(~changed).sum()))
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


def _initial_keys_plain(sym: torch.Tensor, packed: bool = False,
                        base: int = BASE_WIDTH) -> torch.Tensor:
    """The int64 initial sort keys (the plain version of the sa_keys
    kernel's initial modes): the symbol (width 1, exact, any alphabet),
    the clamped key (packed, base == BASE_WIDTH), or the dense-code key
    (packed, base 5..12, block alphabet; ``wide_base_width``).

    Clamped key: the full symbol (separators and the increasing padding
    stay exactly ordered) above the next three symbols clamped to 10
    bits; clamping only merges orders of tail padding, whose windows are
    unique per position.  Dense-code key: real symbols map injectively
    and in order to small codes, ``base`` of them packed big-endian;
    padding positions take a disjoint upper band ordered by position.
    Two real windows that reach the padding hold the text's final unique
    separator at different offsets, so no false tie exists."""
    s = sym.to(torch.int64)
    n = s.shape[0]
    if not packed:
        return s
    if base > BASE_WIDTH:
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
        return torch.where(s >= PAD_BASE, (1 << 62) + idx, key)
    key = s << 30
    for j, shift in ((1, 20), (2, 10), (3, 0)):
        key |= plcp.shift_read(s, j).clamp(max=PACK_CLAMP) << shift
    return key


def _initial_ranks_plain(sym: torch.Tensor, packed: bool = False,
                         base: int = BASE_WIDTH):
    """Initial prefix ranks: width 1, width BASE_WIDTH or width ``base``
    in 5..12 (``_initial_keys_plain``).  Returns (rank int32 text order,
    tied count, order int32 = the SA sorted by the prefix)."""
    key = _initial_keys_plain(sym, packed, base)
    sorted_keys, order = torch.sort(key)
    del key
    rank, tied = _heads_and_tied(sorted_keys, order)
    return rank, tied, order.to(torch.int32)


def _doubling_round_plain(rank: torch.Tensor, k: int):
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


def _extract_tied_plain(rank: torch.Tensor, sa: torch.Tensor):
    """The tied SA slots (ascending, int64) and their suffixes."""
    head = rank[sa]
    same_prev = torch.zeros_like(head, dtype=torch.bool)
    same_prev[1:] = head[1:] == head[:-1]
    slots = _tied_mask(same_prev).nonzero().squeeze(1)
    return slots, sa[slots]


def _bucketed_round_plain(rank: torch.Tensor, sa: torch.Tensor,
                          slots: torch.Tensor, sa_vals: torch.Tensor,
                          k: int):
    """One tail round over the tied slots only: sort them by (head, rank
    at +k), scatter the permutation into ``sa`` and the split groups'
    heads (the slot of each subgroup's first member) into ``rank``, both
    in place; then keep the still-tied subset.  Returns (tied, slots',
    sa_vals')."""
    n = rank.shape[0]
    head = rank[sa_vals]
    shifted = sa_vals.to(torch.int64) + k  # int32 would wrap above 2^31
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


# sa_keys and sa_rerank modes (csrc/doubling_tile.cuh)
_KEY_WIDTH1, _KEY_CLAMPED, _KEY_WIDE, _KEY_FULL, _KEY_TAIL = range(5)
_RR_FULL, _RR_TAIL, _RR_EXTRACT = range(3)

# The partitioned rank scatter (csrc/doubling.cu): a part's window of rank
# is 2^_WINDOW_SHIFT int32, 8 MB of the H100's 50 MB L2 (windows of 2^19
# to 2^22 gave the same loop at 100,663,296 suffixes, 2^23 a slower one:
# ``bench_kernels.py --what sa --windows``).  A rank of one window takes
# the direct scatter.  So does a tail round over a rank of 2^24 or fewer
# suffixes (64 MB, most of it in L2 for a tail's scatter; partitioned,
# its tails were slower) or with fewer tied entries than one in
# _TAIL_DIRECT_SPARSER suffixes (at 100,663,296 the two ways met near
# one in 30).
_WINDOW_SHIFT = 21
_TAIL_DIRECT_MAX_N = 1 << 24
_TAIL_DIRECT_SPARSER = 16
_MAX_PARTS = 1024  # SD_MAX_PARTS


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _round_end_bit(n: int) -> int:
    """Bits of a round's largest key, (n - 1) (n + 1) + n."""
    return max(1, (n * n + n - 1).bit_length())


_INITIAL_END_BIT = 63  # the initial keys are non-negative int64


def _scatter_plan(n: int, m: int, tail: bool,
                  parts: int | None = None) -> tuple[int, int]:
    """(shift, parts) of the rank scatter of m entries into n suffixes:
    parts of 2^shift suffixes, or (0, 0) for the direct scatter.  The
    rule: windows of 2^_WINDOW_SHIFT where rank holds more than one and,
    in a tail round, more than _TAIL_DIRECT_MAX_N suffixes and at least
    n / _TAIL_DIRECT_SPARSER entries.  ``parts``
    (the tests, ``bench_kernels.py``) forces at most that many parts in
    every round, 0 the direct scatter."""
    if parts is None:
        shift = _WINDOW_SHIFT
        if n <= 1 << shift or tail and (n <= _TAIL_DIRECT_MAX_N or
                                        m * _TAIL_DIRECT_SPARSER < n):
            return 0, 0
    elif parts == 0:
        return 0, 0
    else:
        if parts > _MAX_PARTS:
            raise ValueError(f"doubling kernels: {parts} parts, at most "
                             f"{_MAX_PARTS}")
        shift = (-(-n // parts) - 1).bit_length()
    return shift, -(-n >> shift)


def _bit_words(n: int) -> int:
    return -(-n // 32)


def changed_bits_plain(rank: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """The bits a full rerank leaves for the extract, from the ranks and
    SA it wrote: entry t (bit t % 32 of int32 word t // 32) set where t ==
    0 or rank[sa[t]] != rank[sa[t - 1]]."""
    head = rank[sa.long()]
    n = head.shape[0]
    changed = torch.zeros(_bit_words(n) * 32, dtype=torch.int64,
                          device=rank.device)
    changed[0] = 1
    changed[1:n] = (head[1:] != head[:-1]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=rank.device)
    words = (changed.view(-1, 32) << shifts).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


class Kernels:
    """The doubling loop's hand kernels (``csrc/doubling.cu``) and its
    library sort (``csrc/sa_sort.cu``, CUB's radix sort of (key, int32
    suffix) pairs over the key's bits): ``keys`` (sa_keys: one int64 sort
    key and the entry's suffix an entry), ``sort``, ``rerank`` (sa_rerank:
    heads, tied count, the changed bits or the in-order compaction, and
    the rank scatter, direct or binned into pairs by part) and ``scatter``
    (sa_pair_scatter: the binned pairs into rank).  Launched on the
    tensors' card, or, with ``twin``, the kernels' host twin
    (``doubling_cpu.cpp``, g++) on CPU tensors, at the kernel's tiles or
    (``tiny``) at tiles of 64, with ``torch.sort``.

    A route carries what one loop passes between its rounds: ``bits``, the
    last full rerank's changed bits, which the extract reads, and
    ``heads``, the heads of the tied suffixes the last extract or tail
    round compacted, which the next tail round's keys read.  ``parts``
    forces the partitioned scatter's part count (``_scatter_plan``);
    ``bin_order`` (the twin) bins and writes the pairs as they come (0),
    reversed (1) or shuffled (2).

    ``trace``, a list, receives one dict a round: its kind (initial, full,
    extract, tail), its entries, the tied count after it, and on the card
    the ms of its key build, sort, rerank and pair scatter from CUDA
    events (``chip_smoke.py`` prints them; 0 for the twin)."""

    def __init__(self, twin: bool = False, tiny: bool = False,
                 trace: list | None = None, parts: int | None = None,
                 bin_order: int = 0):
        self.twin = twin
        self.tiny = tiny
        self.trace = trace
        self.parts = parts
        self.bin_order = bin_order
        self.bits: torch.Tensor | None = None
        self.heads: torch.Tensor | None = None

    def _check(self, *tensors: torch.Tensor | None) -> None:
        """Every tensor given (None skipped): contiguous, on one device
        (the card, or the CPU for the twin), int64 keys or int32
        otherwise, fewer than 2^31 entries."""
        want = "cpu" if self.twin else "cuda"
        dev = next(t for t in tensors if t is not None).device
        for t in tensors:
            if t is None:
                continue
            if t.device.type != want or t.device != dev:
                raise ValueError(f"doubling kernels: a tensor on {t.device} "
                                 f"where they take {want} ({dev})")
            if t.dtype not in (torch.int32, torch.int64) or \
                    not t.is_contiguous():
                raise ValueError("doubling kernels: contiguous int32 or "
                                 "int64 tensors only")
            if t.numel() >= 1 << 31:
                raise ValueError("doubling kernels: 2^31 or more entries")

    def plan(self, n: int, m: int, tail: bool) -> tuple[int, int]:
        return _scatter_plan(n, m, tail, self.parts)

    def keys(self, mode: int, src: torch.Tensor, sa_vals, m: int, k: int = 0,
             base: int = 1, heads: torch.Tensor | None = None,
             hist: torch.Tensor | None = None, plan=(0, 0)):
        """The int64 keys of m entries and their int32 suffixes: of the
        int32 text ``src`` (the initial modes), of the rank ``src`` at
        every suffix (a full round) or at ``sa_vals``, whose heads are
        ``heads`` (a tail round), offset k.  A tail round partitioned by
        ``plan`` counts its suffixes by part into ``hist``."""
        self._check(src, sa_vals, heads, hist)
        if any(t is not None and t.dtype != torch.int32
               for t in (src, sa_vals, heads, hist)):
            raise ValueError("sa_keys: int32 text, ranks, suffixes, heads")
        if mode == _KEY_TAIL and (heads is None or sa_vals is None or
                                  heads.shape != sa_vals.shape):
            raise ValueError("sa_keys: a tail round takes the heads of its "
                             "suffixes")
        if hist is not None and (mode != _KEY_TAIL or
                                 hist.numel() < plan[1]):
            raise ValueError("sa_keys: part counts of a tail round, one a "
                             "part")
        key = torch.empty(m, dtype=torch.int64, device=src.device)
        vals = torch.empty(m, dtype=torch.int32, device=src.device)
        args = (mode, src.data_ptr(), _ptr(sa_vals), _ptr(heads), m,
                src.shape[0], k, base, key.data_ptr(), vals.data_ptr(),
                _ptr(hist), plan[0], plan[1])
        if self.twin:
            kernels.cpu_twin().andix_sa_keys_cpu(*args)
        elif m:
            with kernels.launch_on(src.device) as stream:
                err = kernels.cuda_lib().andix_sa_keys(*args, stream)
            kernels.check(err, "sa_keys")
            kernels.count_launch("sa_keys", src.device)
        return key, vals

    def sort(self, key: torch.Tensor, vals: torch.Tensor, end_bit: int):
        """(key, vals) sorted by the key's bits below ``end_bit``, and a
        dead int64 buffer of m entries: CUB's radix sort on the card, over
        ``key`` and ``vals`` themselves and a second buffer of each (the
        dead one is the key buffer CUB's selector left unused);
        ``torch.sort`` and a gather for the twin (the dead one is ``key``).
        The inputs are not to be used afterwards."""
        if self.twin:
            sorted_keys, perm = torch.sort(key)
            return sorted_keys, vals[perm], key
        m = key.shape[0]
        if m < 2:
            return key, vals, torch.empty_like(key)
        lib = kernels.cuda_lib()
        key_alt, vals_alt = torch.empty_like(key), torch.empty_like(vals)
        nbytes = lib.andix_sa_sort_temp_bytes(m, end_bit)
        temp = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                           device=key.device)
        selector = ctypes.c_int(0)
        with kernels.launch_on(key.device) as stream:
            err = lib.andix_sa_sort(
                key.data_ptr(), key_alt.data_ptr(), vals.data_ptr(),
                vals_alt.data_ptr(), m, end_bit, temp.data_ptr(), nbytes,
                ctypes.byref(selector), stream)
        kernels.check(err, "sa_sort")
        if selector.value:
            return key_alt, vals_alt, key
        return key, vals, key_alt

    def rerank(self, mode: int, m: int, keys=None, order=None, slots=None,
               rank=None, sa=None, out=None, pairs=None, hist=None,
               plan=(0, 0)) -> torch.Tensor:
        """One rerank pass over m entries (the pointers each mode takes
        are in ``doubling_tile.cuh``'s SdArgs).  A full rerank writes
        ``bits``; the extract reads them.  ``out`` is the (slots,
        suffixes, heads) the tied entries are compacted into.  With
        ``plan`` partitioned, the ranks go as (suffix, head) pairs into
        ``pairs`` (an int64 buffer of m or more) for ``scatter``, by the
        part counts ``hist`` in a tail round.  Returns the tied count, an
        int32 [1] on the tensors' device."""
        outs = tuple(out) if out is not None else (None,) * 3
        if mode == _RR_FULL:
            words = _bit_words(m)
            if self.bits is None or self.bits.shape[0] != words or \
                    self.bits.device != keys.device:
                self.bits = torch.empty(words, dtype=torch.int32,
                                        device=keys.device)
        elif mode == _RR_EXTRACT and (self.bits is None or
                                      self.bits.shape[0] != _bit_words(m)):
            raise ValueError("sa_rerank: the extract reads a full round's "
                             "changed bits over its entries")
        bits = self.bits if mode != _RR_TAIL else None
        self._check(rank, keys, order, slots, sa, *outs, pairs, hist, bits)
        if keys is not None and keys.dtype != torch.int64 or any(
                t is not None and t.dtype != torch.int32
                for t in (order, slots, rank, sa, *outs, hist, bits)):
            raise ValueError("sa_rerank: int64 keys, int32 otherwise")
        parts = plan[1] if pairs is not None else 0
        if parts and pairs.numel() < m:
            raise ValueError("sa_rerank: a pair buffer of fewer than m")
        if parts and mode == _RR_TAIL and (hist is None or
                                           hist.numel() < parts):
            raise ValueError("sa_rerank: a partitioned tail takes its part "
                             "counts")
        dev = next(t for t in (rank, sa, keys) if t is not None).device
        if not m:
            return torch.zeros(1, dtype=torch.int32, device=dev)
        tied = torch.empty(1, dtype=torch.int32, device=dev)
        args = [mode, m] + [_ptr(t) for t in (keys, order, slots, rank, sa,
                                               bits, *outs, tied, pairs)]
        args += [plan[0], parts, _ptr(hist)]
        if self.twin:
            kernels.cpu_twin().andix_sa_rerank_cpu(*args, int(self.tiny),
                                                   self.bin_order)
            return tied
        lib = kernels.cuda_lib()
        scratch = torch.empty(
            max(lib.andix_sa_rerank_scratch_ints(m, parts), 4),
            dtype=torch.int32, device=dev)
        with kernels.launch_on(dev) as stream:
            err = lib.andix_sa_rerank(*args, scratch.data_ptr(), stream)
        kernels.check(err, "sa_rerank")
        kernels.count_launch("sa_rerank", dev)
        return tied

    def scatter(self, pairs: torch.Tensor, m: int, rank: torch.Tensor):
        """rank[suffix] = head for the first m (suffix, head) pairs a
        partitioned rerank left in ``pairs``."""
        self._check(rank, pairs)
        if rank.dtype != torch.int32 or pairs.numel() < m:
            raise ValueError("sa_pair_scatter: int32 rank, m pairs")
        if self.twin:
            kernels.cpu_twin().andix_sa_pair_scatter_cpu(
                pairs.data_ptr(), m, rank.data_ptr(), self.bin_order)
        elif m:
            with kernels.launch_on(rank.device) as stream:
                err = kernels.cuda_lib().andix_sa_pair_scatter(
                    pairs.data_ptr(), m, rank.data_ptr(), stream)
            kernels.check(err, "sa_pair_scatter")
            kernels.count_launch("sa_pair_scatter", rank.device)

    def rank_pass(self, mode: int, m: int, clock, keys, order,
                  slots=None, rank=None, sa=None, out=None, dead=None,
                  hist=None, plan=(0, 0)) -> int:
        """The rerank of a full or tail round and, when ``plan``
        partitions it, the pair scatter through ``dead`` (the sort's dead
        key buffer); marks the clock after each.  Returns the tied
        count."""
        tied = self.rerank(mode, m, keys, order, slots, rank, sa, out,
                           dead if plan[1] else None, hist, plan)
        clock.mark("rerank")
        if plan[1]:
            self.scatter(dead, m, rank)
            clock.mark("scatter")
        return int(spans.readback(tied))

    @contextmanager
    def round(self, kind: str, entries: int):
        """Times one round for ``trace``: the step marks the clock after
        each pass, and sets ``clock.tied``."""
        clock = _RoundClock(self.trace is not None and not self.twin)
        yield clock
        if self.trace is not None:
            self.trace.append(dict(kind=kind, entries=entries,
                                   tied=clock.tied, **clock.read()))


class _RoundClock:
    """CUDA events at a round's start and after each of its passes, each
    named by the pass it ends (keys, sort, rerank, scatter)."""

    PASSES = ("keys", "sort", "rerank", "scatter")

    def __init__(self, on: bool):
        self.events = []
        self.on = on
        self.tied = 0
        self.mark("start")

    def mark(self, name: str):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((name, ev))

    def read(self) -> dict[str, float]:
        out = {f"{p}_ms": 0.0 for p in self.PASSES}
        if not self.on:
            return out
        self.events[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[f"{name}_ms"] += a.elapsed_time(b)
        return out


_PLAIN = object()  # the route of the plain version, on any device


def _route(t: torch.Tensor, route):
    """The route of a step: the one given, else the card's kernels for a
    CUDA tensor and the plain version for a CPU tensor."""
    if route is not None:
        return route
    return _PLAIN if t.device.type == "cpu" else Kernels()


def _initial_ranks(sym: torch.Tensor, packed: bool = False,
                   base: int = BASE_WIDTH, route=None):
    """``_initial_ranks_plain`` through the kernels (a CUDA tensor, or the
    twin's route): the keys, the sort, one full rerank.  The symbols must
    be non-negative (the texts' are)."""
    route = _route(sym, route)
    if route is _PLAIN:
        return _initial_ranks_plain(sym, packed, base)
    n = sym.shape[0]
    mode = (_KEY_WIDTH1 if not packed
            else _KEY_WIDE if base > BASE_WIDTH else _KEY_CLAMPED)
    with route.round("initial", n) as clock:
        key, vals = route.keys(mode, sym.to(torch.int32).contiguous(), None,
                               n, base=base)
        clock.mark("keys")
        key, vals, dead = route.sort(key, vals, _INITIAL_END_BIT)
        clock.mark("sort")
        rank = torch.empty(n, dtype=torch.int32, device=sym.device)
        sa = torch.empty_like(rank)
        clock.tied = route.rank_pass(_RR_FULL, n, clock, key, vals,
                                     rank=rank, sa=sa, dead=dead,
                                     plan=route.plan(n, n, False))
    return rank, clock.tied, sa


def _doubling_round(rank: torch.Tensor, sa: torch.Tensor, k: int,
                    route=None):
    """``_doubling_round_plain`` through the kernels, writing the new
    ranks and SA over ``rank`` and ``sa`` (both dead once the keys are
    built).  Returns (rank, tied, sa)."""
    route = _route(rank, route)
    if route is _PLAIN:
        return _doubling_round_plain(rank, k)
    n = rank.shape[0]
    with route.round("full", n) as clock:
        key, vals = route.keys(_KEY_FULL, rank, None, n, k)
        clock.mark("keys")
        key, vals, dead = route.sort(key, vals, _round_end_bit(n))
        clock.mark("sort")
        clock.tied = route.rank_pass(_RR_FULL, n, clock, key, vals,
                                     rank=rank, sa=sa, dead=dead,
                                     plan=route.plan(n, n, False))
    return rank, clock.tied, sa


def _extract_tied(rank: torch.Tensor, sa: torch.Tensor, tied: int,
                  route=None, bits: torch.Tensor | None = None):
    """``_extract_tied_plain`` through the kernels: the tied slots
    (int32, ascending) and their suffixes, compacted from SA and the
    changed bits of the full rerank that wrote it (the route's, or
    ``bits``: ``changed_bits_plain``), with no read of ``rank``; the
    ``tied`` entries' heads go to ``route.heads``."""
    route = _route(rank, route)
    if route is _PLAIN:
        return _extract_tied_plain(rank, sa)
    if bits is not None:
        route.bits = bits
    n = sa.shape[0]
    out = tuple(torch.empty(tied, dtype=torch.int32, device=sa.device)
                for _ in range(3))
    with route.round("extract", n) as clock:
        route.rerank(_RR_EXTRACT, n, sa=sa, out=out)
        clock.mark("rerank")
        clock.tied = tied
    route.heads = out[2]
    return out[0], out[1]


def _bucketed_round(rank: torch.Tensor, sa: torch.Tensor,
                    slots: torch.Tensor, sa_vals: torch.Tensor, k: int,
                    route=None):
    """``_bucketed_round_plain`` through the kernels: the tail keys (from
    the heads the route carries beside ``sa_vals``), the sort, one rerank
    that scatters into ``sa`` and ``rank`` in place (partitioned by the
    route's plan: the keys count the parts) and compacts the still-tied
    entries in order: their slots into a new buffer, their suffixes and
    heads over ``sa_vals`` and the carried heads."""
    route = _route(rank, route)
    if route is _PLAIN:
        return _bucketed_round_plain(rank, sa, slots, sa_vals, k)
    m = slots.shape[0]
    n = rank.shape[0]
    heads = route.heads
    if heads is None or heads.shape != sa_vals.shape:
        raise ValueError("tail round: the route carries no heads of these "
                         "suffixes (run the extract or the round before "
                         "through it)")
    plan = route.plan(n, m, True)
    hist = (torch.empty(plan[1], dtype=torch.int32, device=rank.device)
            if plan[1] else None)
    with route.round("tail", m) as clock:
        key, vals = route.keys(_KEY_TAIL, rank, sa_vals, m, k, heads=heads,
                               hist=hist, plan=plan)
        clock.mark("keys")
        key, vals, dead = route.sort(key, vals, _round_end_bit(n))
        clock.mark("sort")
        out = (torch.empty_like(slots), sa_vals, heads)
        tied = route.rank_pass(_RR_TAIL, m, clock, key, vals, slots, rank,
                               sa, out, dead, hist, plan)
        clock.tied = tied
    route.heads = heads[:tied]
    return tied, out[0][:tied], sa_vals[:tied]


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


def sa_loop(sym: torch.Tensor, packed: bool, L: int, base: int,
            route=None):
    """The doubling loop (``_sa_loop_traced``): full rounds while more
    than a quarter of the suffixes are tied, then tied-only rounds;
    every round's ranks go to row min(count, L - 1) of the level buffer,
    and a round that leaves ties counts a level, flagging the overflow
    once the count reaches L.  A CUDA text runs the kernels (``route``
    may carry a trace), a CPU text the plain version.  Returns (sa int32,
    levels: a list of at most L int32 [N] rows, level count, overflow);
    the rows below the level count are ``andix``'s, and a row the count
    never reaches (the last round's, which has no ties) is not kept."""
    route = _route(sym, route)
    n = sym.shape[0]
    thr0 = int(n * _BUCKET_FRAC)
    rank, tied, sa = _initial_ranks(sym, packed,
                                    base if packed else BASE_WIDTH, route)
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
        rank, tied, sa = _doubling_round(rank, sa, min(k, n), route)
        push(rank, tied)
        k = min(k * 2, 1 << 30)
    if tied > 0 and k < n:
        slots, sa_vals = _extract_tied(rank, sa, tied, route)
        while tied > 0 and k < n:
            tied, slots, sa_vals = _bucketed_round(rank, sa, slots, sa_vals,
                                                   min(k, n), route)
            push(rank, tied)
            k = min(k * 2, 1 << 30)
    return sa, levels, lev_idx, ovf


def sa_loop_plain(sym: torch.Tensor, packed: bool, L: int, base: int):
    """``sa_loop`` with the plain version on the text's device (the card
    too: ``chip_smoke.py`` holds the kernels to it)."""
    return sa_loop(sym, packed, L, base, _PLAIN)


def sa_loop_cpu_twin(sym: torch.Tensor, packed: bool, L: int, base: int,
                     tiny: bool = False, parts: int | None = None):
    """``sa_loop`` with the kernels' host twin (g++) on a CPU text
    (``parts``: the rank scatter partitioned into at most that many parts
    in every round)."""
    return sa_loop(sym, packed, L, base, Kernels(twin=True, tiny=tiny,
                                                 parts=parts))


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
    ovf_d = torch.full((), ovf, dtype=torch.bool, device=dev)
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
