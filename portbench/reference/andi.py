"""A plain PyTorch reference of andi's distance matrix (``-m JC``).

Written from andi's published semantics, independent of the program under
test: it imports nothing of it and takes only the genomes' bytes.  The
statistics of the anchor length (``min_anchor_length`` and its helpers)
are frozen copies of andi's formulas, ``src/sequence.c:196-373``.

A genome is ACGT, or in join mode (``-j``, ``read_join``) a file's
records joined with '!' (``dsa_join``, ``src/sequence.c:78-125``).  The
joiners count in the genome's length, its G+C share's denominator and its
anchor threshold, as andi's do; ``revcomp`` turns each into ';'
(``src/sequence.c:143-166``).  '!' and ';' are symbols of the text like
any other, each one code for every genome, so a query's '!' extends a
match through a subject's '!' as andi's byte comparison does; the counts
skip them in the gaps as ``model_count`` skips every byte below 'A'.

What it computes, for every ordered pair (subject i, query j), i != j:

* the subject string ``RS_i = revcomp(g_i) + '#' + g_i`` and andi's
  minimum anchor length for it;
* at each query position p the match statistics: the longest prefix of
  ``g_j[p:]`` that occurs in ``RS_i``, whether exactly one suffix of
  ``RS_i`` gives it, and that suffix's position.  They come from one
  suffix array of all subject strings, each ending in a separator of its
  own (prefix doubling with ``torch.sort``), its adjacent LCP array (from
  the doubling's rank levels) and a sparse table of range minima.  They
  are made for a block of subjects at a time, whose pairs are walked and
  counted before the next block's are made;
* andi's anchor walk (``dist_anchor``, ``src/process.c:141-214``): lucky
  anchors on the last anchor's diagonal, unique anchors of at least the
  threshold, the advance by the attempted match's length plus one.  The
  walk is sequential, so each query is cut into segments that are walked
  at once, each from a state with no last anchor; a segment's walk goes
  on past its end until it records an anchor that the next segments'
  walks also record at the same query position, after which the two
  walks are one (their state is that anchor);
* the 16-cell counts of the anchors and the gaps between paired anchors
  (``model_count_equal`` and ``model_count``, ``src/model.c:246-337``,
  the JC model's split of an anchor over the diagonal cells);
* each pair's JC distance, unrounded, from both ordered pairs' counts,
  and the PHYLIP matrix as andi prints it (``src/io.c:246-322``).

``forward_only`` searches the subject's forward strand alone, which
breaks andi's use of both strands; the benchmark's control uses it.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

# A C G T as 0 1 2 3, andi's contig joiner '!' as 4 and its reverse
# complement ';' as 5; every other separator has a code of its own from 6 up
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT!"):
    _CODE[_b] = _i
JOINER = 4
_REVCOMP = np.array([3, 2, 1, 0, 5], dtype=np.uint8)  # by code: T G C A ;
# what andi's ``normalize`` keeps of a record's bytes (src/sequence.c:260-282)
_KEEP = np.zeros(256, dtype=np.uint8)
for _b in b"ACGT!":
    _KEEP[_b] = _b
for _lo, _up in zip(b"acgt", b"ACGT"):
    _KEEP[_lo] = _up
SNP_CELLS = [1, 2, 3, 4, 6, 7, 8, 9, 11, 12, 13, 14]


# --- andi's minimum anchor length (src/sequence.c:196-373), frozen copy -----


def gc_content(seq: np.ndarray) -> float:
    gc = np.count_nonzero((seq == ord("G")) | (seq == ord("C")))
    return int(gc) / len(seq)


def _shustring_cum_prob(x: int, p: float, ell: int) -> float:
    xx = float(x)
    ll = float(ell)
    s = 0.0
    for k in range(0, x + 1):
        kk = float(k)
        t = math.pow(p, kk) * math.pow(0.5 - p, xx - kk)
        s += (math.pow(2.0, xx) * (t * math.pow(1.0 - t, ll))
              * float(math.comb(x, k)))
        if s >= 1.0:
            return 1.0
    return s


def min_anchor_length(p_value: float, gc: float, rs_len: int) -> int:
    x = 1
    while _shustring_cum_prob(x, gc / 2.0, rs_len) < 1.0 - p_value:
        x += 1
    return x


# --- suffix array, LCP and range minima of the joint text -------------------


class JointText:
    """All subject strings in one text: for genome g, ``RS_g`` (its
    reverse complement, a separator in the place of andi's '#', the
    genome) and a second separator.  Query position p of genome g is text
    position ``qoff[g] + p``; subject position s of ``RS_g`` is
    ``off[g] + s``."""

    def __init__(self, genomes: list[np.ndarray], device: torch.device):
        self.device = device
        self.lens = [len(g) for g in genomes]
        parts, off, sep = [], [], 6
        pos = 0
        for g in genomes:
            code = _CODE[g]
            if (code > JOINER).any():
                raise ValueError("the reference takes genomes of ACGT and "
                                 "andi's contig joiner '!' only")
            off.append(pos)
            parts += [_REVCOMP[code][::-1], np.array([sep], np.uint8), code,
                      np.array([sep + 1], np.uint8)]
            sep += 2
            pos += 2 * len(g) + 2
        self.n_codes = sep
        self.off = np.array(off, dtype=np.int64)
        self.qoff = self.off + np.array(self.lens, dtype=np.int64) + 1
        host = np.concatenate(parts)
        self.n = len(host)
        if self.n >= 1 << 31:  # ranks, LCPs and statistics are int32
            raise ValueError("the reference takes under 2^31 positions")
        self.code = torch.from_numpy(host.astype(np.int64)).to(device)
        self._suffix_array()
        self._lcp()
        self._range_min_table()

    def _suffix_array(self) -> None:
        n, dev = self.n, self.device
        bits = max(1, math.ceil(math.log2(self.n_codes)))
        k = 62 // bits
        padded = torch.cat([self.code, torch.zeros(k, dtype=torch.int64,
                                                  device=dev)])
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        for t in range(k):
            key = (key << bits) | padded[t:t + n]
        levels = []  # (h, rank of the h-prefix at each position, from 1)
        h = k
        while True:
            sorted_key, order = torch.sort(key)
            new = torch.ones(n, dtype=torch.int64, device=dev)
            new[1:] = (sorted_key[1:] != sorted_key[:-1]).long()
            rank = torch.empty(n, dtype=torch.int64, device=dev)
            rank[order] = torch.cumsum(new, 0)
            levels.append((h, rank.to(torch.int32)))
            del sorted_key, new
            if int(rank[order[-1]]) == n:
                break
            nxt = torch.zeros(n, dtype=torch.int64, device=dev)
            if h < n:
                nxt[:n - h] = rank[h:]
            key = (rank << 32) | nxt
            del rank, nxt, order
            h *= 2
        sa = torch.empty(n, dtype=torch.int64, device=dev)
        sa[levels[-1][1].long() - 1] = torch.arange(n, device=dev)
        self.sa = sa
        self.isa = (levels[-1][1].long() - 1)
        self.levels = levels
        self.k = k

    def _lcp(self) -> None:
        """lcp[r] = lcp(SA[r - 1], SA[r]); lcp[0] = 0."""
        n, dev = self.n, self.device
        x, y = self.sa[:-1], self.sa[1:]
        ell = torch.zeros(n - 1, dtype=torch.int64, device=dev)
        for h, rank in reversed(self.levels):
            xi, yi = x + ell, y + ell
            ok = (xi < n) & (yi < n)
            same = rank[xi.clamp(max=n - 1)] == rank[yi.clamp(max=n - 1)]
            ell += torch.where(ok & same, h, 0)
        live = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for _ in range(self.k - 1):
            xi, yi = x + ell, y + ell
            ok = (xi < n) & (yi < n)
            same = (self.code[xi.clamp(max=n - 1)]
                    == self.code[yi.clamp(max=n - 1)])
            live &= ok & same
            ell += live.long()
        self.levels = None
        self.lcp = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              ell]).to(torch.int32)

    def _range_min_table(self) -> None:
        n = self.n
        rows = n.bit_length()  # 2^(rows - 1) <= n
        self.table = torch.empty((rows, n), dtype=torch.int32,
                                 device=self.device)
        self.table[0] = self.lcp
        self.lcp = None
        for j in range(1, rows):
            span = 1 << (j - 1)
            prev, row = self.table[j - 1], self.table[j]
            row.copy_(prev)
            torch.minimum(prev[:n - span], prev[span:], out=row[:n - span])

    def range_min(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """min(lcp[lo..hi]) for lo <= hi, elementwise (int64)."""
        width = (hi - lo + 1).clamp(min=1)
        j = torch.floor(torch.log2(width.double())).long()
        # the largest j with 2^j <= width, whatever log2 rounded to
        j = torch.where((1 << (j + 1)) <= width, j + 1, j)
        j = torch.where((1 << j) > width, j - 1, j)
        a = self.table[j, lo]
        b = self.table[j, hi - (1 << j) + 1]
        return torch.minimum(a, b).long()

    def lcp_at(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The longest common prefix of the suffixes at text positions x and
        y (x != y elementwise)."""
        rx, ry = self.isa[x], self.isa[y]
        return self.range_min(torch.minimum(rx, ry) + 1, torch.maximum(rx, ry))


# --- match statistics --------------------------------------------------------


def match_statistics(jt: JointText, i: int, forward_only: bool, out):
    """Writes into ``out`` (length int32, unique bool, subject position
    int32) against ``RS_i`` at every query position of every genome, in
    ``jt.qoff`` order (genome g's block is ``[sum(lens[:g]),
    sum(lens[:g + 1]))``).

    At a query suffix of rank r, the suffixes of ``RS_i`` nearest to it in
    the suffix array are the inside ranks just below and just above r; the
    match is the longer of the two LCPs with them, and it is unique when
    the next inside suffix beyond shares less of it.  The inside ranks are
    sorted once and searched a query genome at a time, so nothing is kept
    over the whole text but the index."""
    n, dev = jt.n, jt.device
    lo = int(jt.qoff[i]) if forward_only else int(jt.off[i])
    hi = int(jt.off[i]) + 2 * jt.lens[i] + 1
    inside = torch.sort(jt.isa[lo:hi]).values
    m = inside.numel()
    # adj[k]: the LCP of the inside suffixes of ranks inside[k - 1] and
    # inside[k]; 0 before the first and past the last
    adj = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    adj[1:m] = jt.range_min(inside[:-1] + 1, inside[1:])
    length, unique, pos = out
    start = 0
    for g, ln in enumerate(jt.lens):
        r = jt.isa[int(jt.qoff[g]):int(jt.qoff[g]) + ln]
        kp = torch.searchsorted(inside, r) - 1  # the inside rank below r
        kn = torch.searchsorted(inside, r, right=True)  # and above it
        has_a, has_b = kp >= 0, kn < m
        a = torch.where(has_a, inside[kp.clamp(min=0)], 0)
        b = torch.where(has_b, inside[kn.clamp(max=m - 1)], n - 1)
        u = torch.where(has_a, jt.range_min(torch.where(has_a, a + 1, r), r),
                        0)
        r1 = (r + 1).clamp(max=n - 1)
        d = torch.where(has_b, jt.range_min(r1, torch.where(has_b, b, r1)),
                        0)
        up_a = adj[kp.clamp(min=0)]
        dn_b = adj[(kn + 1).clamp(max=m)]
        unique[start:start + ln] = torch.where(
            u > d, up_a < u, torch.where(d > u, dn_b < d, False))
        length[start:start + ln] = torch.maximum(u, d)
        pos[start:start + ln] = (torch.where(u > d, jt.sa[a], jt.sa[b])
                                 - int(jt.off[i]))
        start += ln


# --- the anchor walk ---------------------------------------------------------


class _Pairs:
    """The fixed data of the ordered pairs whose subject is one of
    ``subjects``, one entry a pair; ``subj`` is the subject's place in
    ``subjects``, which is its statistics' place in the block."""

    def __init__(self, jt: JointText, thresholds: list[int],
                 subjects: range):
        n = len(jt.lens)
        self.pairs = [(i, j) for i in subjects for j in range(n) if i != j]
        dev = jt.device
        qstart = np.concatenate([[0], np.cumsum(jt.lens)[:-1]])
        cols = list(zip(*[(i - subjects.start, jt.lens[j], thresholds[i],
                           2 * jt.lens[i] + 1,
                           jt.lens[i], int(jt.off[i]), int(jt.qoff[j]),
                           int(qstart[j]))
                          for i, j in self.pairs]))
        (self.subj, self.qlen, self.thr, self.rs_len, self.border,
         self.rs_off, self.q_off, self.ms_off) = (
            torch.tensor(c, dtype=torch.int64, device=dev) for c in cols)


def _walk(jt, pp: _Pairs, ms, seg: int):
    """Every pair's anchors (pair, q, s, len), in walk order."""
    dev = jt.device
    ms_len, ms_uniq, ms_pos, total_q = ms
    n_seg = (pp.qlen + seg - 1) // seg
    lane_pair = torch.repeat_interleave(
        torch.arange(len(pp.pairs), device=dev), n_seg)
    first = torch.cumsum(n_seg, 0) - n_seg
    lane_k = torch.arange(lane_pair.shape[0], device=dev) - first[lane_pair]
    start = lane_k * seg
    end = torch.minimum(start + seg, pp.qlen[lane_pair])
    last = lane_k == n_seg[lane_pair] - 1
    cold = lane_k > 0
    # the true start (no anchor yet, andi's zeros) or a cold one whose
    # last anchor lies past the subject's end, so no lucky anchor is tried
    p = start.clone()
    lq = torch.where(cold, start, 0)
    ls = torch.where(cold, pp.rs_len[lane_pair], 0)
    ll = torch.zeros_like(p)

    def step(lanes, p, lq, ls, ll):
        pr = lane_pair[lanes]
        adv = p - lq
        gap = adv - ll
        try_s = ls + adv
        lucky = (try_s < pp.rs_len[pr]) & (gap >= 0) & (gap <= pp.thr[pr])
        lucky_len = torch.zeros_like(p)
        if lucky.any():
            li = lucky.nonzero().squeeze(1)
            lucky_len[li] = jt.lcp_at(pp.q_off[pr[li]] + p[li],
                                      pp.rs_off[pr[li]] + try_s[li])
        hit = lucky & (lucky_len >= pp.thr[pr])
        at = pp.subj[pr] * total_q + pp.ms_off[pr] + p
        m_len, m_uniq = ms_len[at].long(), ms_uniq[at]
        m_pos = ms_pos[at].long()
        length = torch.where(hit, lucky_len, m_len)
        s = torch.where(hit, try_s, m_pos)
        found = hit | (m_uniq & (m_len >= pp.thr[pr]))
        return found, s, length

    # phase A: each lane walks its segment
    events_a = []
    act = torch.arange(lane_pair.shape[0], device=dev)
    act = act[p[act] < end[act]]
    while act.numel():
        found, s, length = step(act, p[act], lq[act], ls[act], ll[act])
        f = act[found]
        events_a.append(torch.stack([f, p[f], s[found], length[found]]))
        lq[f], ls[f], ll[f] = p[f], s[found], length[found]
        p[act] += length + 1
        act = act[p[act] < end[act]]
    ev_a = (torch.cat(events_a, 1) if events_a
            else torch.zeros(4, 0, dtype=torch.int64, device=dev))
    # phase A's anchors by (pair, q), for the look-up of phase B
    key_a = lane_pair[ev_a[0]] * (1 << 32) + ev_a[1]
    key_a, order = torch.sort(key_a)
    ev_a = ev_a[:, order]

    # phase B: each lane but a query's last goes on until one of its
    # anchors is one that phase A recorded, or to the query's end
    conv = pp.qlen[lane_pair].clone()  # no convergence: the walk ran out
    events_b = []
    act = (~last).nonzero().squeeze(1)
    act = act[p[act] < pp.qlen[lane_pair[act]]]
    while act.numel():
        found, s, length = step(act, p[act], lq[act], ls[act], ll[act])
        key = lane_pair[act] * (1 << 32) + p[act]
        j = torch.searchsorted(key_a, key).clamp(max=max(key_a.numel() - 1,
                                                        0))
        same = found & (key_a.numel() > 0)
        if key_a.numel():
            same &= ((key_a[j] == key) & (ev_a[2, j] == s)
                     & (ev_a[3, j] == length))
        conv[act[same]] = p[act][same]
        keep = found & ~same
        f = act[keep]
        events_b.append(torch.stack([f, p[f], s[keep], length[keep]]))
        lq[f], ls[f], ll[f] = p[f], s[keep], length[keep]
        p[act] += length + 1
        act = act[~same & (p[act] < pp.qlen[lane_pair[act]])]
    ev_b = (torch.cat(events_b, 1) if events_b
            else torch.zeros(4, 0, dtype=torch.int64, device=dev))

    # the walk of each query: lane 0, then the lane whose phase A holds
    # the anchor its continuation met, from that anchor on
    n_lanes = lane_pair.shape[0]
    used = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    from_q = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    cur = first.clone()
    while cur.numel():
        used[cur] = True
        q_next = conv[cur]
        pr = lane_pair[cur]
        more = q_next < pp.qlen[pr]
        cur, q_next, pr = cur[more], q_next[more], pr[more]
        nxt = first[pr] + q_next // seg
        from_q[nxt] = q_next
        cur = nxt
    keep_a = used[ev_a[0]] & (ev_a[1] >= from_q[ev_a[0]])
    keep_b = used[ev_b[0]]
    ev = torch.cat([ev_a[:, keep_a], ev_b[:, keep_b]], 1)
    pair = lane_pair[ev[0]]
    order = torch.argsort(pair * (1 << 32) + ev[1])
    return pair[order], ev[1][order], ev[2][order], ev[3][order]


# --- counts ------------------------------------------------------------------


def _counts(jt, pp: _Pairs, pair, q, s, length) -> torch.Tensor:
    """[pairs, 16] int64: andi's JC counts from each pair's anchors."""
    dev = jt.device
    n_pairs = len(pp.pairs)
    counts = torch.zeros(n_pairs * 16, dtype=torch.int64, device=dev)
    thr, border, qlen = pp.thr[pair], pp.border[pair], pp.qlen[pair]
    head = torch.ones_like(pair, dtype=torch.bool)
    head[1:] = pair[1:] != pair[:-1]
    pq = torch.where(head, 0, torch.roll(q, 1))
    ps = torch.where(head, 0, torch.roll(s, 1))
    pl = torch.where(head, 0, torch.roll(length, 1))
    end_q, end_s = pq + pl, ps + pl
    right = ((s > end_s) & (q - end_q == s - end_s)
             & ((s < border) == (ps < border)))
    prev_right = torch.where(head, False, torch.roll(right, 1))
    # the last anchor before each one is counted whole when it pairs
    # with this one, when the one before it paired, or when it is long
    equal = torch.where(right | prev_right | (pl >= 2 * thr), pl, 0)
    # each pair's last anchor, after the walk (src/process.c:199-211)
    tail = torch.ones_like(head)
    tail[:-1] = pair[1:] != pair[:-1]
    whole = tail & (length >= qlen)
    trail = torch.where(whole, qlen,
                        torch.where(tail & (right | (length >= 2 * thr)),
                                    length, 0))
    for lens in (equal, trail):
        quarter = lens // 4
        for cell, extra in ((0, 0), (5, 0), (10, 0), (15, 1)):
            counts.index_add_(0, pair * 16 + cell,
                              quarter + (lens & 3) * extra)
    # the gaps between paired anchors, site by site
    g = right.nonzero().squeeze(1)
    gap_len = q[g] - end_q[g]
    csum = torch.cumsum(gap_len, 0)
    lo, done = 0, 0
    while lo < g.numel():
        # some 2^26 sites at a time
        hi = int(torch.searchsorted(csum, done + (1 << 26), right=True))
        hi = max(hi, lo + 1)
        gg = g[lo:hi]
        glen = gap_len[lo:hi]
        site_pair = torch.repeat_interleave(pair[gg], glen)
        base_s = torch.repeat_interleave(pp.rs_off[pair[gg]] + end_s[gg], glen)
        base_q = torch.repeat_interleave(pp.q_off[pair[gg]] + end_q[gg], glen)
        first = torch.cumsum(glen, 0) - glen
        t = (torch.arange(int(glen.sum()), device=dev)
             - torch.repeat_interleave(first, glen))
        cs, cq = jt.code[base_s + t], jt.code[base_q + t]
        ok = (cs < 4) & (cq < 4)
        counts.index_add_(0, (site_pair * 16 + cs * 4 + cq)[ok],
                          torch.ones(int(ok.sum()), dtype=torch.int64,
                                     device=dev))
        lo, done = hi, int(csum[hi - 1])
    return counts.view(n_pairs, 16)


def read_join(path: str) -> tuple[str, np.ndarray]:
    """A FASTA file read as andi's join mode reads it (``read_fasta_join``,
    ``src/io.c:159-189``): each record normalized (ACGT and '!' kept, acgt
    upper-cased, every other byte dropped), the records joined in file
    order with '!', the genome named after the file's basename cut at its
    first '.'."""
    with open(path, "rb") as f:
        text = f.read()
    records = []
    for chunk in text.split(b"\n>"):
        lines = chunk.lstrip(b">").split(b"\n")
        kept = _KEEP[np.frombuffer(b"".join(lines[1:]), dtype=np.uint8)]
        records.append(kept[kept != 0].tobytes())
    name = os.path.basename(path).split(".", 1)[0]
    return name, np.frombuffer(b"!".join(records), dtype=np.uint8)


class Reference:
    """andi's ``-m JC`` counts for a family of genomes (ACGT bytes, and
    '!' where a genome joins contigs).

    The pairs are walked a block of subjects at a time, each block's match
    statistics freed before the next: ``block`` subjects, or by default as
    many as ``STATS_BYTES`` of statistics hold (9 B a query position a
    subject).  The counts do not depend on the block."""

    STATS_BYTES = 8 << 30

    def __init__(self, genomes: list[np.ndarray], p_value: float = 0.025,
                 device: str | torch.device = "cpu", segment: int = 4096,
                 block: int | None = None):
        self.genomes = [np.asarray(g, dtype=np.uint8) for g in genomes]
        self.thresholds = [min_anchor_length(p_value, gc_content(g),
                                             2 * len(g) + 1)
                           for g in self.genomes]
        self.jt = JointText(self.genomes, torch.device(device))
        self.segment = segment
        total_q = sum(self.jt.lens)
        self.block = block or min(len(genomes), max(
            1, self.STATS_BYTES // (9 * total_q)))

    def counts(self, forward_only: bool = False):
        """(counts [n, n, 16] int64, seq_len [n, n] int64), with the
        diagonal's sentinel (9 AtoA of 9, ``src/dist_hack.h:62``)."""
        jt, n, dev = self.jt, len(self.genomes), self.jt.device
        total_q = sum(jt.lens)
        counts = np.zeros((n, n, 16), dtype=np.int64)
        seq_len = np.zeros((n, n), dtype=np.int64)
        for first in range(0, n, self.block):
            subjects = range(first, min(first + self.block, n))
            pp = _Pairs(jt, self.thresholds, subjects)
            size = len(subjects) * total_q
            ms = (torch.empty(size, dtype=torch.int32, device=dev),
                  torch.empty(size, dtype=torch.bool, device=dev),
                  torch.empty(size, dtype=torch.int32, device=dev))
            for k, i in enumerate(subjects):
                match_statistics(jt, i, forward_only, tuple(
                    t[k * total_q:(k + 1) * total_q] for t in ms))
            walk = _walk(jt, pp, (*ms, total_q), self.segment)
            del ms
            per_pair = _counts(jt, pp, *walk).cpu().numpy()
            del walk
            for k, (i, j) in enumerate(pp.pairs):
                counts[i, j] = per_pair[k]
                seq_len[i, j] = len(self.genomes[j])
        for i in range(n):
            counts[i, i, 0] = 9
            seq_len[i, i] = 9
        return counts, seq_len


# --- JC and the PHYLIP matrix ------------------------------------------------


def jc_distance(counts: np.ndarray, dtype=np.float64) -> float:
    """andi's JC estimate (src/model.c:81-106) in ``dtype``."""
    nucl = int(counts.sum())
    if nucl <= 3:
        return float("nan")
    p = dtype(int(counts[SNP_CELLS].sum())) / dtype(nucl)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = float(dtype(-0.75) * np.log(dtype(1.0) - dtype(4.0 / 3.0) * p))
    return 0.0 if d <= 0.0 else d


def distances(counts: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Every pair's JC distance, unrounded, from both ordered pairs'
    counts together (``src/io.c:254-262``); 0 on the diagonal."""
    n = len(counts)
    dist = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                dist[i, j] = jc_distance(counts[i, j] + counts[j, i], dtype)
    return dist


def phylip(names: list[str], counts: np.ndarray, seq_len: np.ndarray,
           dtype=np.float64) -> tuple[str, int]:
    """The matrix andi prints for these counts, and its exit code (1 when a
    distance is nan or a pair's coverage is under 0.2)."""
    n = len(names)
    dist = distances(counts, dtype)
    soft_error = bool(np.isnan(dist).any())
    for i in range(n):
        for j in range(i + 1, n):
            if not (math.isnan(dist[i, j]) or math.isnan(dist[j, i])):
                cov = [counts[a, b].sum() / seq_len[a, b]
                       for a, b in ((i, j), (j, i))]
                soft_error |= min(cov) < 0.2
    sci = bool(((dist > 0.0) & (dist < 0.001)).any())
    fmt = "{:1.4e}" if sci else "{:1.4f}"
    lines = [str(n)] + [" ".join([f"{names[i]:<10s}"]
                                 + [fmt.format(d) for d in dist[i]])
                        for i in range(n)]
    return "\n".join(lines) + "\n", int(soft_error)
