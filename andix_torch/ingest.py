"""Genome texts made on the card: the CLI's FASTA read where the backend
is a card, the joint block's text and each subject index's text.

``read`` takes every named regular file that starts with ``>`` on the
card (``card``: the backend resolves to a card).  The files of a call are
read whole into one pinned host buffer, each followed by a ``\\n``, and
uploaded once; one launch of ``csrc/ingest.cu`` parses, normalizes and
counts them and writes every record's RS (``revcomp + '#' + forward``,
then a 0) into one buffer, which comes back to pinned host memory in one
copy.  In join mode (``-j``) the RS pass writes one RS a file instead, its
records joined by ``'!'`` as ``fasta.read_fasta_join`` joins them, in the
bytes its records' RS take otherwise, and the file's sequence is named
after the file as there.  ``IngestSeq.data`` and ``IngestSeq.rs`` are
views into the buffer, and ``subject`` makes each subject from them and
the G+C count, as ``sequence.subject_init`` does.  The card's buffers are
freed before ``read`` returns.

A file takes that path only where the card's record table proves it
exact (``_accepted``): it starts with ``>``; every header line starts
with ``>`` at column 0, has a non-whitespace byte after it and ends in
``\\n``; every record has a sequence byte; every byte outside header lines
is a letter, ``-``, ``*`` or whitespace.  On such a file ``fasta.
FastaStream``'s records are: the header's first word (the name), the rest
of its line after the word's end (the comment), and the non-whitespace
bytes up to the next header (the sequence).  Every other file, stdin and
the CPU backend go to ``fasta.read_fasta`` (``read_fasta_join`` in join
mode) as they are, with their messages; nothing the card computed for a
refused file is used.  The files of each path are counted
(``ingest.device_files``, ``ingest.host_files``).  In join mode the
card's read of the files it joins is one ``ingest.join`` span
(``_read_join_card``), which counts them in ``join.device_files``; each
file joined on the host is one more (``_read_join``), and each subject
one ``subjects.host`` span.

``block_layout`` is ``joint.build_block``'s layout without its zeroed
copy: a view of the RS buffer where the block's subjects lie back to back
there (the whole family in one block, or one subject of a subject index,
``subject_pipeline._index_text``), else one copy into pinned memory;
``block_text`` widens a block's uint8 text on its device to
``backend.pad_symbols(layout.sym, padded_n)`` (``csrc/ingest.cu``'s
``block_text_kernel``), and ``device_text`` uploads a layout's text and
widens and checks it there.

Each kernel has its plain PyTorch version here (the CPU's route) and its
host twin (``csrc/ingest_cpu.cpp``); ``tests/test_torch_ingest.py`` holds
them to one another and ``read`` to ``fasta.read_fasta`` +
``subject_init``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import stat

import numpy as np
import torch

from . import _distributed, fasta, kernels, spans
from .device import DeviceError, resolve_devices
from .esa.joint import SEPARATOR_BASE, BlockLayout
from .runtime import Context
from .sequence import (_REVCOMP, BANG, Seq, Subject, min_anchor_length,
                       subject_init)

# raw bytes a launch reads at most, so that every count and position of
# the record table fits an int32; a larger file goes to the host
BATCH_BYTES = 1 << 30
REC = 6  # record row: header position, header line end, K, G, R, V
_WS = re.compile(rb"[\t\n\v\f\r ]")


@dataclasses.dataclass
class IngestSeq(Seq):
    """A record read on the card: ``data`` is the forward half of ``rs``
    (``sequence.catcomp``'s layout), both views into one pinned buffer;
    ``gc_count`` is its G+C count."""

    rs: np.ndarray = None
    gc_count: int = 0
    joined: bool = False  # a file's records joined (join mode)


def subject(seq: Seq, anchor_p_value: float) -> Subject:
    """``sequence.subject_init(seq, anchor_p_value)``, from the card's RS
    and G+C count for an ``IngestSeq``.  A subject the host makes is one
    ``subjects.host`` span (``symbols``: its length) and one count of
    ``subjects.host_rs``; one from the card counts ``subjects.device_rs``,
    and a joined one is a ``subjects.host`` span too (the host's part:
    its G+C share and threshold), so that join mode's subjects are timed
    on either read."""
    if not isinstance(seq, IngestSeq):
        with spans.span("subjects.host", symbols=len(seq.data)):
            spans.count("subjects.host_rs")
            return subject_init(seq, anchor_p_value)
    spans.count("subjects.device_rs")
    if seq.joined:
        with spans.span("subjects.host", symbols=len(seq.data)):
            return _card_subject(seq, anchor_p_value)
    return _card_subject(seq, anchor_p_value)


def _card_subject(seq: IngestSeq, anchor_p_value: float) -> Subject:
    gc = seq.gc_count / len(seq.data)
    return Subject(rs=seq.rs, gc=gc, threshold=min_anchor_length(
        anchor_p_value, gc, len(seq.rs)))


def card(ctx: Context) -> torch.device | None:
    """The card this process reads its files on, in join mode as without
    it: None where ``--backend`` resolves to no card (the CLI reports that
    later, where it always has).  Before a process group is joined,
    torchrun's rank takes its own card, as ``device.resolve_devices`` will
    give it."""
    try:
        devices = resolve_devices(ctx.backend)
    except DeviceError:
        return None
    if devices[0].type != "cuda":
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return torch.device(
            "cuda", _distributed.local_rank() % torch.cuda.device_count())
    return devices[0]


def read(file_names: list[str], ctx: Context,
         device: torch.device | None) -> list[Seq]:
    """Every file's sequences in order: the card's for the files it takes
    on ``device`` (None: none; in join mode one joined sequence a file),
    ``fasta.read_fasta`` (``read_fasta_join`` in join mode) for the
    others."""
    if device is None:
        taken = {}
    elif ctx.join:
        taken = _read_join_card(file_names, device)
    else:
        taken = read_records(file_names, device)
    seqs: list[Seq] = []
    for k, name in enumerate(file_names):
        if k in taken:
            spans.count("ingest.device_files")
            recs = taken[k]
            if any(r.non_acgt for r in recs):
                ctx.non_acgt = True
            seqs.extend(IngestSeq(data=r.data, name=r.name, rs=r.rs,
                                  gc_count=r.gc, joined=ctx.join)
                        for r in recs)
        else:
            spans.count("ingest.host_files")
            seqs.extend(_read_join(name, ctx) if ctx.join
                        else fasta.read_fasta(name, ctx))
    return seqs


def _read_join_card(file_names: list[str], device: torch.device
                    ) -> dict[int, list[Record]]:
    """``read_records(file_names, device, True)`` in one ``ingest.join``
    span: the card's read of the files it joins, with their ``records``
    and joined ``bytes``, counted in ``join.device_files``,
    ``join.records`` and ``join.joiners`` as ``_read_join`` counts a
    file joined on the host."""
    with spans.span("ingest.join") as sp:
        taken = read_records(file_names, device, True)
        if sp:
            recs = [r for k in sorted(taken) for r in taken[k]]
            records = sum(r.records for r in recs)
            sp.set(records=records, bytes=sum(len(r.data) for r in recs))
            spans.count("join.device_files", len(recs))
            spans.count("join.records", records)
            spans.count("join.joiners", records - len(recs))
    return taken


def _read_join(name: str, ctx: Context) -> list[Seq]:
    """``fasta.read_fasta_join(name, ctx)`` in one ``ingest.join`` span
    with the file's ``records`` and the joined ``bytes``, counted in
    ``join.records`` and ``join.joiners`` too.  The joiners are the
    joined sequence's '!' bytes, one a record after the first where the
    records hold none (nucleotide FASTA does not)."""
    with spans.span("ingest.join") as sp:
        got = fasta.read_fasta_join(name, ctx)
        if sp and got:
            joiners = int(np.count_nonzero(got[0].data == BANG))
            sp.set(records=joiners + 1, bytes=len(got[0].data))
            spans.count("join.records", joiners + 1)
            spans.count("join.joiners", joiners)
    return got


@dataclasses.dataclass
class Record:
    name: str
    comment: str
    data: np.ndarray  # the normalized sequence (a view into the RS buffer)
    rs: np.ndarray
    gc: int
    non_acgt: bool
    records: int = 1  # the file's records joined into it (join mode)


def _join_name(path: str) -> str:
    """A joined file's sequence name, as ``fasta.read_fasta_join`` cuts
    it: the basename up to its first ``.``."""
    return os.path.basename(path).split(".", 1)[0]


def _regular_size(name: str) -> int:
    """The size of a named regular file that may start with ``>``; 0 for
    anything else."""
    if name == "-":
        return 0
    try:
        st = os.stat(name)
    except OSError:
        return 0
    return st.st_size if stat.S_ISREG(st.st_mode) else 0


def _batches(file_names: list[str]) -> list[list[tuple[int, int]]]:
    """The candidate files as (index, size), in order, cut into batches of
    at most BATCH_BYTES bytes (each file and its ``\\n``)."""
    out: list[list[tuple[int, int]]] = []
    cur, total = [], 0
    for k, name in enumerate(file_names):
        size = _regular_size(name)
        if not 0 < size < BATCH_BYTES:
            continue
        if cur and total + size + 1 > BATCH_BYTES:
            out.append(cur)
            cur, total = [], 0
        cur.append((k, size))
        total += size + 1
    if cur:
        out.append(cur)
    return out


def _read_whole(name: str, size: int, view: np.ndarray) -> bool:
    """Reads the file into ``view`` (``size`` bytes); False if it cannot
    be read, is not that size, or does not start with ``>``."""
    try:
        with open(name, "rb", buffering=0) as f:
            got = 0
            mv = memoryview(view)
            while got < size:
                n = f.readinto(mv[got:])
                if not n:
                    return False
                got += n
            if f.read(1):
                return False
    except OSError:
        return False
    return view[0] == ord(">")


def host_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 host buffer, pinned (under ``device``'s context) where
    ``device`` is a card."""
    if device.type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    with torch.cuda.device(device):
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def read_records(file_names: list[str], device: torch.device,
                 join: bool = False) -> dict[int, list[Record]]:
    """{file index: its records} for the files that ``device`` (a card,
    or the CPU's plain version) takes (``join``: its one joined record,
    named after the file); pinned host buffers for a card."""
    taken: dict[int, list[Record]] = {}
    for batch in _batches(file_names):
        host = host_buffer(sum(size + 1 for _, size in batch), device)
        buf = host.numpy()
        files, m = [], 0
        for k, size in batch:
            if _read_whole(file_names[k], size, buf[m: m + size]):
                buf[m + size] = ord("\n")
                files.append((k, m, m + size))
                m += size + 1
        if files:
            got = _ingest_batch(host[:m], files, device, join)
            if join:
                for k, recs in got.items():
                    recs[0].name = _join_name(file_names[k])
            taken.update(got)
    return taken


def _ingest_batch(raw: torch.Tensor, files, device: torch.device,
                  join: bool = False) -> dict[int, list[Record]]:
    """The records of the files in ``raw`` (a host uint8 tensor: each file
    at ``[start, end)`` of ``files``' (index, start, end), then a ``\\n``;
    pinned for a card) that ``_accepted`` takes, by file index; with
    ``join``, each file's records joined into one, unnamed
    (``read_records`` names it)."""
    m = raw.shape[0]
    dev_raw = spans.upload(raw, device)
    starts = None
    if join:
        starts = spans.upload(torch.tensor([s for _, s, _ in files],
                                           dtype=torch.int64), device)
    cap = max(64, m >> 12)
    while True:
        seq, rec, rs = scan(dev_raw, cap, starts)
        table = spans.readback(rec).numpy()
        nh = int(table[cap, 0])
        if nh <= cap:
            break
        cap = nh  # more headers than rows: once more with room for all
    del dev_raw, seq, starts
    rows = table[:nh].astype(np.int64)
    tot = table[cap].astype(np.int64)
    k0 = rows[:, 2]
    nxt = np.append(rows[1:, 2:], tot[None, 2:], axis=0)
    length, gc, nonws, bad = (nxt - rows[:, 2:]).T
    rs_off = 2 * k0 + 2 * np.arange(nh)
    total = int(2 * tot[2] + 2 * nh)
    rs_host = host_buffer(total, device)
    spans.readback(rs[:total], out=rs_host)
    del rs, rec
    rs_buf = rs_host.numpy()
    raw_np = raw.numpy()

    out: dict[int, list[Record]] = {}
    starts = np.array([s for _, s, _ in files], dtype=np.int64)
    owner = np.searchsorted(starts, rows[:, 0], side="right") - 1
    for f, (k, _, end) in enumerate(files):
        mine = np.nonzero(owner == f)[0]
        if not _accepted(rows[mine], nonws[mine], bad[mine], end):
            continue
        if join:
            # the file's RS starts where its first record's would
            off = int(rs_off[mine[0]])
            n = int(length[mine].sum()) + len(mine) - 1
            out[k] = [Record(
                name="", comment="",
                data=rs_buf[off + n + 1: off + 2 * n + 1],
                rs=rs_buf[off: off + 2 * n + 1], gc=int(gc[mine].sum()),
                non_acgt=bool((nonws[mine] > length[mine]).any()),
                records=len(mine))]
            continue
        recs = []
        for r in mine:
            name, comment = _header(raw_np[rows[r, 0] + 1: rows[r, 1]])
            off, n = int(rs_off[r]), int(length[r])
            recs.append(Record(
                name=name, comment=comment,
                data=rs_buf[off + n + 1: off + 2 * n + 1],
                rs=rs_buf[off: off + 2 * n + 1], gc=int(gc[r]),
                non_acgt=bool(nonws[r] > n)))
        out[k] = recs
    return out


def _accepted(rows: np.ndarray, nonws: np.ndarray, bad: np.ndarray,
              end: int) -> bool:
    """The gate, on a file's records (its first starts at the file's
    first byte, a ``>``: ``_read_whole``): no record holds a refused byte
    or an empty name (``bad``), every record has a sequence byte, and
    every header line ends before the file does (its ``\\n`` is not the
    one after the file)."""
    return (not bad.any() and bool((nonws > 0).all())
            and bool((rows[:, 1] < end).all()))


def _header(line: np.ndarray) -> tuple[str, str]:
    """Name and comment of a header line (without its ``>`` and ``\\n``),
    as ``fasta.FastaStream`` cuts them: the name up to the first
    whitespace, the comment after that byte."""
    b = line.tobytes()
    ws = _WS.search(b)
    if ws is None:
        return b.decode("utf-8", errors="replace"), ""
    k = ws.start()
    return (b[:k].decode("utf-8", errors="replace"),
            b[k + 1:].decode("utf-8", errors="replace"))


# ---- the ingest kernel and its plain version --------------------------

def scan(raw: torch.Tensor, cap: int, starts: torch.Tensor | None = None):
    """(seq, rec, rs) of ``raw`` (uint8 [m]) with a record table of
    ``cap`` rows (``csrc/ingest_tile.cuh``): seq [m] holds the K kept
    bytes first; rec int32 [cap + 1, 6] the rows (header position, its
    line's end, K, G, R, V before it) and the totals row (headers, 0, K,
    G, R, V); rs [2 m] the 2 K + 2 headers bytes of the records' RS, when
    the headers fit ``cap``.  With ``starts`` (int64, ascending, on
    ``raw``'s device: each file's first byte) the RS bytes are one RS a
    file, its records joined by '!' (join mode).  The kernels on a card,
    the plain version on the CPU."""
    if raw.dtype != torch.uint8 or raw.dim() != 1 or \
            not raw.is_contiguous():
        raise ValueError("ingest: raw must be contiguous 1-D uint8")
    if starts is not None and (
            starts.dtype != torch.int64 or starts.dim() != 1
            or not starts.is_contiguous() or starts.device != raw.device
            or starts.shape[0] == 0):
        raise ValueError("ingest: starts must be contiguous 1-D int64 on "
                         "raw's device")
    if raw.device.type == "cpu":
        return scan_plain(raw, cap, starts)
    return _scan_cuda(raw, cap, starts)


def _excl(mask: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(mask.to(torch.int64), 0)
    return c - mask.to(torch.int64)


def scan_plain(raw: torch.Tensor, cap: int,
               starts: torch.Tensor | None = None):
    """The plain PyTorch version of ``scan``, on ``raw``'s device."""
    m, dev = raw.shape[0], raw.device
    x = raw.to(torch.int64)
    nl = x == 10
    true = torch.ones(1, dtype=torch.bool, device=dev)
    head = (x == 62) & torch.cat([true, nl[:-1]])
    ws = (x == 32) | ((x >= 9) & (x <= 13))
    event = head | nl
    last = torch.cummax(torch.where(
        event, torch.arange(m, device=dev), -1), 0).values
    hdr_after = torch.where(last >= 0, head[last.clamp(min=0)], False)
    hdr_before = torch.cat([~true, hdr_after[:-1]])
    region = ~(head | hdr_before) & ~ws
    low = x | 32
    keep = region & ((low == 97) | (low == 99) | (low == 103) | (low == 116))
    gc = region & ((low == 99) | (low == 103))
    allowed = ((low >= 97) & (low <= 122)) | (x == 45) | (x == 42)
    bad = (region & ~allowed) | (head & torch.cat([ws[1:], true]))

    hpos = torch.nonzero(head).flatten()
    nh = hpos.shape[0]
    ends = torch.nonzero(nl & hdr_before).flatten()
    cols = [_excl(v)[hpos] for v in (keep, gc, region, bad)]
    rec = torch.zeros((cap + 1, REC), dtype=torch.int32, device=dev)
    rows = min(nh, cap)
    rec[:rows, 0] = hpos[:rows].to(torch.int32)
    e = min(rows, ends.shape[0])
    rec[:e, 1] = ends[:e].to(torch.int32)
    for c, v in enumerate(cols, 2):
        rec[:rows, c] = v[:rows].to(torch.int32)
    totals = torch.stack([v.sum() for v in (keep, gc, region, bad)])
    rec[cap, 0] = nh
    rec[cap, 2:] = totals.to(torch.int32)

    kept = (x[keep] & ~32).to(torch.uint8)
    seq = torch.zeros(m, dtype=torch.uint8, device=dev)
    seq[: kept.shape[0]] = kept
    rs = torch.zeros(2 * m, dtype=torch.uint8, device=dev)
    if 0 < nh <= cap:
        k0 = cols[0]
        length = torch.cat([k0[1:], totals[:1]]) - k0
        off = 2 * k0 + 2 * torch.arange(nh, device=dev)
        total = 2 * kept.shape[0] + 2 * nh
        if starts is not None:
            rs[:total] = _join_rs_plain(kept, hpos, off, length, starts)
            return seq, rec, rs
        o = torch.arange(total, device=dev)
        q = (torch.searchsorted(off, o, right=True) - 1).clamp(min=0)
        local = o - off[q]
        n, base = length[q], k0[q]
        rev = (local >= 0) & (local < n)
        fwd = (local > n) & (local <= 2 * n)
        table = torch.from_numpy(_REVCOMP).to(dev)
        rs[:total][rev] = table[kept[(base + n - 1 - local)[rev]].long()]
        rs[:total][local == n] = ord("#")
        rs[:total][fwd] = kept[(base + local - n - 1)[fwd]]
    return seq, rec, rs


def _join_rs_plain(kept: torch.Tensor, hpos: torch.Tensor,
                   off: torch.Tensor, length: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """The RS bytes of ``scan_plain`` in join mode: file f's records
    (headers ``hpos`` from ``starts[f]`` on, the first file's from 0)
    joined by '!' as one RS in the bytes their RS ``off`` take."""
    dev, nh = kept.device, off.shape[0]
    bounds = torch.cat([off, off.new_tensor([2 * kept.shape[0] + 2 * nh])])
    first = torch.cat([off.new_zeros(1), torch.searchsorted(hpos,
                                                            starts[1:])])
    u = bounds[first]
    unext = bounds[torch.cat([first[1:], off.new_tensor([nh])])]
    u, unext = u[unext > u], unext[unext > u]  # files with records
    o = torch.arange(int(bounds[-1]), device=dev)
    f = (torch.searchsorted(u, o, right=True) - 1).clamp(min=0)
    local, j, h0 = o - u[f], (unext[f] - u[f]) // 2 - 1, u[f] // 2
    rev = (local >= 0) & (local < j)
    fwd = (local > j) & (local <= 2 * j)
    h = torch.where(rev, h0 + j - 1 - local, h0 + local - j - 1)
    q = (torch.searchsorted(off // 2, h, right=True) - 1).clamp(min=0)
    lh = h - off[q] // 2
    inner = (rev | fwd) & (lh < length[q])
    sym = torch.full_like(o, BANG, dtype=torch.uint8)
    sym[inner] = kept[(off[q] // 2 - q + lh)[inner]]
    table = torch.from_numpy(_REVCOMP).to(dev)
    out = torch.zeros(o.shape[0], dtype=torch.uint8, device=dev)
    out[rev] = table[sym[rev].long()]
    out[local == j] = ord("#")
    out[fwd] = sym[fwd]
    return out


def _scan_cuda(raw: torch.Tensor, cap: int,
               starts: torch.Tensor | None = None):
    m = raw.shape[0]
    dev = raw.device
    if raw.data_ptr() % 16:
        raise ValueError("ingest: raw must be 16-byte aligned")
    lib = kernels.cuda_lib()
    scratch = torch.empty(max(int(lib.andix_ingest_scratch_ints(m)), 4),
                          dtype=torch.int32, device=dev)
    seq = torch.empty(max(m, 1), dtype=torch.uint8, device=dev)
    rec = torch.empty((cap + 1, REC), dtype=torch.int32, device=dev)
    rs = torch.empty(max(2 * m, 16), dtype=torch.uint8, device=dev)
    with kernels.launch_on(dev) as stream:
        err = lib.andix_ingest(
            raw.data_ptr(), ctypes.c_int64(m), cap, scratch.data_ptr(),
            seq.data_ptr(), rec.data_ptr(), rs.data_ptr(),
            ctypes.c_int64(rs.shape[0]),
            None if starts is None else starts.data_ptr(),
            0 if starts is None else starts.shape[0], stream)
    kernels.check(err, "ingest")
    kernels.count_launch("ingest", dev)
    return seq[:m], rec, rs


def scan_cpu_twin(raw: torch.Tensor, cap: int, tiny: bool = False,
                  agg_only: torch.Tensor | None = None,
                  starts: torch.Tensor | None = None):
    """The kernels' bodies (``ingest_tile.cuh``) built for the host with
    g++, the scan's tiles in counter order: (seq, rec, rs, status), status
    being each tile's final status word (1 aggregate, 2 inclusive).
    ``tiny`` takes tiles of 256 bytes instead of the kernel's 16384;
    ``agg_only``, a bool [tiles] tensor (``scan_cpu_tiles``), marks tiles
    that publish only their aggregate; ``starts`` as ``scan``'s."""
    m = raw.shape[0]
    tiles = scan_cpu_tiles(m, tiny)
    if agg_only is not None and (agg_only.dtype != torch.bool
                                 or agg_only.shape != (tiles,)):
        raise ValueError(f"scan_cpu_twin: agg_only must be bool [{tiles}]")
    raw = raw.contiguous()
    seq = torch.zeros(m, dtype=torch.uint8)
    rec = torch.zeros((cap + 1, REC), dtype=torch.int32)
    rs = torch.zeros(2 * m, dtype=torch.uint8)
    status = torch.zeros(tiles, dtype=torch.int32)
    kernels.cpu_twin().andix_ingest_cpu(
        raw.data_ptr(), ctypes.c_int64(m), cap,
        None if agg_only is None else agg_only.contiguous().data_ptr(),
        int(tiny), seq.data_ptr(), rec.data_ptr(), rs.data_ptr(),
        ctypes.c_int64(rs.shape[0]),
        None if starts is None else starts.contiguous().data_ptr(),
        0 if starts is None else starts.shape[0], status.data_ptr())
    return seq, rec, rs, status


def scan_cpu_tiles(m: int, tiny: bool = False) -> int:
    """Tiles of the host twin's scan of m bytes."""
    return int(kernels.cpu_twin().andix_ingest_cpu_tiles(m, int(tiny)))


# ---- the joint block's text -------------------------------------------

def pad_base(n_segments: int) -> int:
    """``backend.pad_symbols``'s first padding symbol for a block of
    ``n_segments`` separators (its largest real symbol is the last
    separator, ``SEPARATOR_BASE + n_segments - 1``)."""
    return max(1 << 20, SEPARATOR_BASE + n_segments)


def block_text(text: torch.Tensor, ends: torch.Tensor, padded_n: int):
    """(sym, counts): the int32 [padded_n] symbols of a block whose uint8
    text ``text`` holds a 0 at each separator position ``ends`` (int64,
    ascending, on the text's device), which must equal
    ``backend.pad_symbols(layout.sym, padded_n)``; counts int32 [2]: the
    text's 0 bytes, and those at no separator.  The kernel on a card, the
    plain version on the CPU."""
    n, nseg = text.shape[0], ends.shape[0]
    if padded_n < n:
        raise ValueError(f"block_text: padded_n {padded_n} < n {n}")
    if text.device.type == "cpu":
        return block_text_plain(text, ends, padded_n)
    if text.dtype != torch.uint8 or ends.dtype != torch.int64 or \
            ends.device != text.device or not text.is_contiguous() or \
            not ends.is_contiguous() or text.data_ptr() % 16:
        raise ValueError("block_text: text must be aligned contiguous "
                         "uint8 and ends contiguous int64 on its device")
    sym = torch.empty(padded_n, dtype=torch.int32, device=text.device)
    counts = torch.empty(2, dtype=torch.int32, device=text.device)
    lib = kernels.cuda_lib()
    with kernels.launch_on(text.device) as stream:
        err = lib.andix_block_text(
            text.data_ptr(), ctypes.c_int64(n), ends.data_ptr(), nseg,
            pad_base(nseg), ctypes.c_int64(padded_n), sym.data_ptr(),
            counts.data_ptr(), stream)
    kernels.check(err, "block_text")
    kernels.count_launch("block_text", text.device)
    return sym, counts


def block_text_plain(text: torch.Tensor, ends: torch.Tensor,
                     padded_n: int):
    """The plain PyTorch version of ``block_text``."""
    n, nseg = text.shape[0], ends.shape[0]
    sym = torch.empty(padded_n, dtype=torch.int32, device=text.device)
    sym[:n] = text
    sym[ends] = SEPARATOR_BASE + torch.arange(
        nseg, dtype=torch.int32, device=text.device)
    sym[n:] = pad_base(nseg) + torch.arange(
        padded_n - n, dtype=torch.int32, device=text.device)
    zeros = (text == 0).sum()
    counts = torch.stack([zeros, zeros - (text[ends] == 0).sum()])
    return sym, counts.to(torch.int32)


def device_text(layout: BlockLayout, padded_n: int, device, span: str):
    """(sym, text) on ``device``: the int32 [padded_n] symbols
    ``backend.pad_symbols(layout.sym, padded_n)`` and the layout's uint8
    text they were widened from.  The text and its separators' ends are
    uploaded (``span`` names the host side), widened by ``block_text``,
    and the zero counts read back: every 0 byte must be a separator.  The
    joint block (``backend.prepare_block``) and each subject index
    (``subject_pipeline._index_text``) take this route."""
    with spans.span(span):
        u8 = torch.from_numpy(layout.u8)
        ends = layout.seg_start[1:] - 1
    text = spans.upload(u8, device)
    sym, zeros = block_text(text, spans.upload(ends, device), padded_n)
    zeros, stray = (int(z) for z in spans.readback(zeros))
    nseg = len(layout.genome_ids)
    if stray or zeros != nseg:
        raise ValueError(f"block text: {zeros} zero bytes for {nseg} "
                         "separators (a real symbol is 0)")
    return sym, text


def block_text_cpu_twin(text: torch.Tensor, ends: torch.Tensor,
                        padded_n: int):
    """``block_text``'s kernel body built for the host with g++."""
    sym = torch.empty(padded_n, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    text, ends = text.contiguous(), ends.contiguous()
    kernels.cpu_twin().andix_block_text_cpu(
        text.data_ptr(), ctypes.c_int64(text.shape[0]), ends.data_ptr(),
        ends.shape[0], pad_base(ends.shape[0]), ctypes.c_int64(padded_n),
        sym.data_ptr(), counts.data_ptr())
    return sym, counts


def _root(a: np.ndarray) -> np.ndarray:
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


def _address(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def _back_to_back(pieces: list[np.ndarray]) -> np.ndarray | None:
    """The view of one buffer that holds ``pieces`` in order, each followed
    by a 0 byte, or None where they do not lie so."""
    base = _root(pieces[0])
    if base.dtype != np.uint8 or base.ndim != 1 or \
            not base.flags.c_contiguous:
        return None
    b0 = _address(base)
    start = pos = _address(pieces[0]) - b0
    for p in pieces:
        if (_root(p) is not base or p.ndim != 1 or not p.flags.c_contiguous
                or _address(p) - b0 != pos):
            return None
        pos += len(p) + 1
    if pos > len(base):
        return None
    view = base[start:pos]
    ends = np.cumsum([len(p) + 1 for p in pieces]) - 1
    return None if view[ends].any() else view


def block_layout(subject_rs: dict[int, np.ndarray],
                 query_seqs: dict[int, np.ndarray],
                 device: torch.device) -> BlockLayout:
    """``joint.build_block(subject_rs, query_seqs)``'s layout.  Its text
    is a view where the pieces lie back to back, each followed by a 0
    (the RS buffer ``read`` leaves, when a block holds consecutive
    subjects and no other query), else one copy of the pieces into a new
    buffer (``host_buffer``: pinned where ``device`` is a card)."""
    pieces = [*subject_rs.values(), *query_seqs.values()]
    lens = np.array([len(p) for p in pieces], dtype=np.int64)
    seg_start = np.concatenate([[0], np.cumsum(lens + 1)]).astype(np.int64)
    u8 = _back_to_back(pieces) if pieces else None
    if u8 is None:
        total = int(seg_start[-1])
        u8 = host_buffer(total, device).numpy()
        for p, a in zip(pieces, seg_start[:-1]):
            u8[a: a + len(p)] = p
        u8[seg_start[1:] - 1] = 0
    ns = len(subject_rs)
    return BlockLayout(
        u8=u8, seg_start=seg_start,
        genome_ids=np.array([*subject_rs, *query_seqs], dtype=np.int32),
        is_subject=np.arange(len(pieces)) < ns,
        seq_lens=np.concatenate([(lens[:ns] - 1) // 2, lens[ns:]]).astype(
            np.int64))
