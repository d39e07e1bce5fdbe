"""Distance-matrix pipeline (counterpart of ``andix/pipeline.py``).

Two schedules with byte-identical output, picked by ``ANDIX_INDEX``
(``auto``, ``subject`` or ``joint``):

* the joint schedule: subjects are grouped into *blocks*; per block (and
  per query chunk) one joint suffix array over the block's subject
  strings and the remaining query strings is built on the device, every
  subject's matching statistics come from flag scans over it, and the
  anchor chains are walked per (subject, query-segment) lane;
* the subject-index schedule (``subject_pipeline``): one index per
  subject, every query streamed past it through the search walk.

``auto`` keeps ``andix``'s rule: the subject index when the joint plan
has more than one block or chunks its queries, in a single-process run.
Rows the subject index cannot finish go to the joint schedule.
Low-memory mode (``-l``) is single-subject blocks or index groups.

With more than one worker (several devices, or several processes under
torchrun) the joint schedule runs ``andix``'s sharded grid
(``_process_sharded``): subject rows in contiguous shares, one per worker,
each run on its device through ``_process_block``; the subject-index
schedule runs one worker per device over round-robin groups.  The output
is byte for byte the one-device output.

Checkpoint rows (``TileCheckpoint``) keep ``andix``'s format 3 and
fingerprint, so a row written by either package resumes under the other.
Under a process group rank 0 alone reads and writes them.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

from . import _distributed, ingest, parallel, spans
from .device import memory_budget, ranks_on
from .model import CountMatrix
from .output import ProgressMeter
from .runtime import Context
from .sequence import Seq, Subject


def make_blocks(
    subjects: list[Subject],
    block_syms: int,
    low_memory: bool,
    query_base: int | None = None,
) -> list[list[int]]:
    """Greedy-pack subject indices into blocks bounded by ``block_syms``
    joint-text symbols.  ``query_base`` is the query-symbol load a block
    text carries (the full query total, or the chunk bound when queries are
    chunked)."""
    n = len(subjects)
    if low_memory:
        return [[i] for i in range(n)]
    query_total = sum((s.len - 1) // 2 + 1 for s in subjects)
    if query_base is None:
        query_base = query_total
    query_base = min(query_base, query_total)
    blocks: list[list[int]] = []
    cur: list[int] = []
    cur_syms = query_base
    for i in range(n):
        need = subjects[i].len + 1
        if cur and cur_syms + need > block_syms:
            blocks.append(cur)
            cur = []
            cur_syms = query_base
        cur.append(i)
        cur_syms += need
    if cur:
        blocks.append(cur)
    return blocks


# Peak device bytes per PADDED block symbol of the joint schedule, rounded
# up from chip_smoke.py's CLI runs on an H100 80GB HBM3 (700 W; PERF.md):
# 118.63 at 8 x 1 Mbp (2^24 padded symbols), 118.44 at 8 x 5 Mbp, and
# 118.44 for the repeat family (8 x 5 Mbp with g1 = g0), whose SA build
# keeps 20 level rows (80 B): the peak comes after the build, in the block
# tables.  Level rows beyond what a block's budget holds are not kept
# (``esa.backend.level_budget``); the LCP then comes from the host.
BYTES_PER_PADDED_SYM = 128


def worker_memory(devices: list[torch.device]) -> tuple[list[int], int]:
    """Per worker of ``devices`` (a device listed k times carries k
    workers), the workers of this host that split its device's memory:
    this process's workers on the device times the processes on it
    (``device.ranks_on``); and the budget every worker plans with, the
    smallest worker's, so that all workers make the same plan."""
    shares = [devices.count(d) * ranks_on(d) for d in devices]
    return shares, min(memory_budget(d, s) for d, s in zip(devices, shares))


def device_plan(
    block_syms: int, subjects: list[Subject], budget: int
) -> tuple[int, int]:
    """Memory-aware (block_syms, max_query_syms).  Blocks are capped at the
    largest shape bucket whose padded footprint (BYTES_PER_PADDED_SYM per
    padded symbol) fits ``budget`` bytes; when the query total no longer
    fits alongside a subject, queries are chunked at half the cap.
    ANDIX_MAX_QUERY_SYMS overrides the chunk bound."""
    from .esa.backend import bucket

    largest = max(s.len + 1 for s in subjects)
    query_total = sum((s.len - 1) // 2 + 1 for s in subjects)
    budget_syms = budget // BYTES_PER_PADDED_SYM
    cap = b = 1 << 16
    while True:
        for cand in (b + b // 2, b * 2):
            if cand <= budget_syms:
                cap = cand
        b *= 2
        if b > budget_syms:
            break
    if bucket(largest) > cap:
        raise MemoryError(
            f"a single subject ({largest} symbols) does not fit the "
            f"device memory budget of {budget_syms} padded symbols"
        )
    eff_block = min(block_syms, cap)

    env = os.environ.get("ANDIX_MAX_QUERY_SYMS")
    if env:
        return eff_block, int(env)
    if query_total + largest <= eff_block:
        return eff_block, query_total + 1
    return eff_block, max(eff_block // 2, 1 << 20)


def _query_chunks(
    block: list[int], n: int, seqs: list[Seq], max_query_syms: int
) -> list[list[int]]:
    """Split the out-of-block query genomes into chunks bounded by
    ``max_query_syms`` symbols.  One chunk for the common case."""
    out_of_block = [j for j in range(n) if j not in set(block)]
    total = sum(seqs[j].len + 1 for j in out_of_block)
    if total <= max_query_syms:
        return [out_of_block]
    chunks: list[list[int]] = []
    cur: list[int] = []
    cur_syms = 0
    for j in out_of_block:
        need = seqs[j].len + 1
        if cur and cur_syms + need > max_query_syms:
            chunks.append(cur)
            cur = []
            cur_syms = 0
        cur.append(j)
        cur_syms += need
    if cur:
        chunks.append(cur)
    return chunks


CHECKPOINT_FORMAT = 3


def checkpoint_fingerprint(seqs: list[Seq], ctx: Context) -> str:
    """Run fingerprint stored in every checkpoint row: anything that changes
    the 16-cell counts (model exactness, anchor p-value, the input sequences
    and their order) must invalidate stale rows."""
    import hashlib

    h = hashlib.sha256()
    h.update(f"v{CHECKPOINT_FORMAT};{ctx.model.value};{ctx.anchor_p_value!r};".encode())
    for s in seqs:
        h.update(f"{s.name}\x00{s.len};".encode())
        h.update(np.ascontiguousarray(s.data).tobytes())
    return h.hexdigest()


class TileCheckpoint:
    """Row-tile checkpoint/resume.  One .npz per subject row holding the
    16-cell counts and seq_len of every pair in that row; rows found on
    disk are served without recomputation.  Every row carries the run
    fingerprint; rows from a different configuration are refused loudly
    and recomputed."""

    def __init__(self, directory: str, fingerprint: str = ""):
        self.dir = directory
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)

    def _path(self, i: int) -> str:
        return os.path.join(self.dir, f"row_{i}.npz")

    def load_row(self, i: int, n: int):
        path = self._path(i)
        if not os.path.exists(path):
            return None
        try:
            data = np.load(path)
            fp = str(data["fingerprint"]) if "fingerprint" in data else ""
            counts = data["counts"]
            seq_len = data["seq_len"]
        except (OSError, ValueError, KeyError, EOFError) as e:
            print(
                f"andix: checkpoint row {path} is unreadable ({e}); "
                f"recomputing.",
                file=sys.stderr,
            )
            return None
        if fp != self.fingerprint:
            print(
                f"andix: checkpoint row {path} was written by a different "
                f"run configuration (model/p-value/inputs changed); "
                f"recomputing.",
                file=sys.stderr,
            )
            return None
        if counts.shape != (n, 16):
            return None
        return {
            j: CountMatrix(counts[j].copy(), int(seq_len[j]))
            for j in range(n)
            if j != i
        }

    def save_row(self, i: int, n: int, row: dict[int, CountMatrix]) -> None:
        counts = np.zeros((n, 16), dtype=np.int64)
        seq_len = np.zeros(n, dtype=np.int64)
        for j, cm in row.items():
            counts[j] = cm.counts
            seq_len[j] = cm.seq_len
        tmp = self._path(i) + ".tmp.npz"
        np.savez(
            tmp, counts=counts, seq_len=seq_len, fingerprint=self.fingerprint
        )
        os.replace(tmp, self._path(i))


def _process_block(
    block: list[int],
    seqs: list[Seq],
    subjects: list[Subject],
    ctx: Context,
    backend,
    M,
    progress,
    max_query_syms: int,
    ckpt: "TileCheckpoint | None" = None,
    qchunks: list[list[int]] | None = None,
    replay: str | None = None,
) -> None:
    """One joint block's rows, query chunk by query chunk.  ``qchunks``
    (the sharded grid's chunks of all genomes) replaces the block's own
    chunking; the block's genomes are dropped from them.  ``replay``
    (``events`` or ``loop``; ``None``: ``ANDIX_REPLAY``) goes to the
    backend's ``subject_group_counts``."""
    n = len(seqs)
    row_acc: dict[int, dict[int, CountMatrix]] = {i: {} for i in block}
    if qchunks is None:
        qchunks = _query_chunks(block, n, seqs, max_query_syms)
    else:
        in_block = set(block)
        qchunks = [c for c in ([j for j in chunk if j not in in_block]
                               for chunk in qchunks) if c] or [[]]

    for chunk_idx, qchunk in enumerate(qchunks):
        subject_rs = {i: subjects[i].rs for i in block}
        query_seqs = {j: seqs[j].data for j in qchunk}
        layout = ingest.block_layout(subject_rs, query_seqs, backend.device)
        bctx = backend.prepare_block(layout)
        # in-block queries ride along in every chunk (they live inside the
        # RS strings); publish them only once
        wanted = set(qchunk)
        if chunk_idx == 0:
            wanted |= set(block)

        group = backend.replay_group(len(block), bctx.tq.shape[0])
        for gs in range(0, len(block), group):
            gset = block[gs : gs + group]
            rows = backend.subject_group_counts(
                bctx, gset, {i: subjects[i] for i in gset}, ctx.model,
                replay=replay,
            )
            for i in gset:
                done = 0
                for j, cm in rows[i].items():
                    if j in wanted and j != i:
                        M[i][j] = cm
                        row_acc[i][j] = cm
                        done += 1
                if progress is not None and done:
                    progress.advance(done)
        del bctx

    if ckpt is not None:
        for i in block:
            ckpt.save_row(i, n, row_acc[i])


def calculate_matrix(
    seqs: list[Seq],
    ctx: Context,
    devices: list[torch.device],
    block_syms: int | None = None,
    progress: ProgressMeter | None = None,
) -> list[list[CountMatrix]]:
    """Fill the full n×n count-matrix grid (reference
    ``calculate_distances`` compute phase, src/process.c:230-251) on
    ``devices``, the devices this process runs workers on
    (``device.resolve_devices``); a device listed k times carries k
    workers, which split its memory (``worker_memory``).  Under a process
    group (``_distributed``) rank 0's grid is complete; the other ranks'
    hold the rows they computed."""
    from .esa.backend import TorchBackend

    block_syms = block_syms if block_syms is not None else ctx.block_syms
    n = len(seqs)
    devices = list(devices)
    world = _distributed.world_size()
    with spans.span("subjects"):
        subjects = [ingest.subject(s, ctx.anchor_p_value) for s in seqs]
    shares, budget = worker_memory(devices)
    block_syms, max_query_syms = device_plan(block_syms, subjects, budget)

    M: list[list[CountMatrix]] = [[None] * n for _ in range(n)]  # type: ignore
    for i in range(n):
        diag = CountMatrix.zero(seq_len=9)
        diag.counts[0] = 9
        M[i][i] = diag

    # tile-level resume: rows already on disk skip recomputation; rank 0
    # alone reads and writes them, and its rows left to do hold everywhere
    ckpt_dir = ctx.checkpoint_dir or os.environ.get("ANDIX_CHECKPOINT_DIR")
    ckpt = (
        TileCheckpoint(ckpt_dir, checkpoint_fingerprint(seqs, ctx))
        if ckpt_dir and _distributed.rank() == 0
        else None
    )
    todo = list(range(n))
    if ckpt is not None:
        remaining = []
        for i in todo:
            row = ckpt.load_row(i, n)
            if row is None:
                remaining.append(i)
            else:
                for j, cm in row.items():
                    M[i][j] = cm
                if progress is not None:
                    progress.advance(n - 1)
        todo = remaining
    todo = parallel.broadcast(todo)
    if not todo:
        return M

    mode = os.environ.get("ANDIX_INDEX", "auto")
    if mode == "auto":
        # andix's rule, with its process term: several processes keep the
        # joint schedule (every process would run every subject-index row)
        probe_blocks = make_blocks(
            [subjects[i] for i in todo], block_syms, False,
            query_base=max_query_syms,
        )
        query_total = sum(s.len + 1 for s in seqs)
        use_sx = ((len(probe_blocks) > 1 or query_total > max_query_syms)
                  and world == 1)
    else:
        use_sx = mode == "subject"
    if use_sx:
        from .subject_pipeline import process_subject_index

        todo = process_subject_index(todo, seqs, subjects, ctx, M, progress,
                                     ckpt, devices)
        if not todo:
            return M

    worker_counts = parallel.all_gather(len(devices))
    if (
        sum(worker_counts) > 1
        and not ctx.low_memory
        and len(todo) > 1
        and os.environ.get("ANDIX_SHARDED", "1") != "0"
    ):
        _process_sharded(todo, seqs, subjects, ctx, M, progress, ckpt,
                         devices, shares, budget, worker_counts, block_syms,
                         max_query_syms)
        return M

    backend = TorchBackend(devices[0], ctx.threads, share=shares[0],
                           budget=budget)
    blocks = [
        [todo[k] for k in blk]
        for blk in make_blocks(
            [subjects[i] for i in todo], block_syms, ctx.low_memory,
            query_base=max_query_syms,
        )
    ]
    for block in blocks:
        _process_block(
            block, seqs, subjects, ctx, backend, M, progress,
            max_query_syms, ckpt=ckpt,
        )
    return M


# one line per worker of the last sharded grid: its rows and wall seconds
LAST_BALANCE: list[str] = []


def _process_sharded(todo, seqs, subjects, ctx: Context, M, progress, ckpt,
                     devices, shares, budget: int, worker_counts,
                     block_syms: int, max_query_syms: int) -> None:
    """The sharded pair grid (``andix``'s ``_process_sharded``): the rows
    in ``todo`` split into contiguous shares, one per worker of the global
    worker list (ranks in order, each rank's ``devices`` in order), and
    query chunks cut from all genomes, as every share's chunks in
    ``andix``.  Each worker runs its share on its device through
    ``_process_block``, split further by ``make_blocks`` where the share
    does not fit one block of the plan; a worker without rows does
    nothing.  Under a process group rank 0 gathers every rank's rows and
    alone writes their checkpoint rows.  ``shares`` is each worker's split
    of its device's memory and ``budget`` the bytes every worker plans
    with (``worker_memory``)."""
    from .esa.backend import TorchBackend

    n = len(seqs)
    first = sum(worker_counts[:_distributed.rank()])
    rows_of = [
        [todo[k] for k in blk]
        for blk in parallel.round_robin_blocks(len(todo), sum(worker_counts))
    ][first: first + len(devices)]
    qchunks = _query_chunks([], n, seqs, max_query_syms)
    processes = len(worker_counts)
    # andix's sharded step reads its own replay mode (parallel.py:345-350)
    replay = os.environ.get("ANDIX_SHARDED_REPLAY",
                            os.environ.get("ANDIX_REPLAY", "events"))
    meter = parallel.LockedProgress(progress) if progress is not None else None

    def work(device, share, rows):
        backend = TorchBackend(device, ctx.threads, share=share,
                               budget=budget)
        for blk in make_blocks([subjects[i] for i in rows], block_syms,
                               False, query_base=max_query_syms):
            _process_block([rows[k] for k in blk], seqs, subjects, ctx,
                           backend, M, meter, max_query_syms,
                           ckpt=ckpt if processes == 1 else None,
                           qchunks=qchunks, replay=replay)

    jobs = [(first + w, d, s, r)
            for w, (d, s, r) in enumerate(zip(devices, shares, rows_of)) if r]
    parallel.load_libraries(devices)
    walls = parallel.run_workers([functools.partial(work, d, s, r)
                                  for _, d, s, r in jobs],
                                 [d for _, d, _, _ in jobs])
    LAST_BALANCE[:] = [
        f"worker {w} on {d}: rows {r[0]}..{r[-1]}, {wall:.3f} s"
        for (w, d, _, r), wall in zip(jobs, walls)
    ]
    if processes == 1:
        return
    mine = {i for rows in rows_of for i in rows}
    rows = parallel.gather_rows(
        {i: {j: M[i][j] for j in range(n) if j != i} for i in mine}, n)
    if rows is None:
        return
    for i, row in rows.items():
        for j, cm in row.items():
            M[i][j] = cm
        if progress is not None and i not in mine:
            progress.advance(len(row))
        if ckpt is not None:
            ckpt.save_row(i, n, row)
