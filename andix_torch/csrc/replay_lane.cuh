// Per-lane bodies of the count-in-loop replay, shared by the CUDA kernels
// (replay.cu, one warp per sublane, then one warp per lane) and their host
// twin (replay_cpu.cpp, built with g++ for the tests, one thread).
//
// Semantics are those of andix/chain/replay_device.py:replay_rows_device
// (the anchor scan dist_anchor with its counting, src/process.c:141-214):
// a lane is one (subject row, query) pair, walked from position 0 to the
// query's end with the flat walk's probe step (walk_probe, walk_lane.cuh),
// and instead of recording anchors it counts the 16 substitution cells:
// * a found anchor on the last anchor's diagonal (paired, with the border
//   test of src/process.c:160-189) counts the gap between them, text byte
//   against text byte (model_count, src/model.c:309-337); a site counts
//   where both bytes are nucleotides (at least 'A': separators are 0 and
//   the contig joins '!', ';', '#' lie below);
// * the previous anchor counts as equal sites when it is paired, was
//   paired, or is at least twice the threshold long (count_last);
// * at the chain's end, the identical-sequence case or the trailing
//   anchor (src/process.c:199-211).
// Equal sites count as andix's model_count_equal does: len / 4 on each
// diagonal cell and len % 4 on TtoT (fast), or byte by byte on the
// diagonal cell of the byte (exact: LogDet and ANI).  andix queues the
// intervals and drains them over later iterations of its lock-step loop;
// a lane here counts each interval in the probe that makes it due, and
// the sums are the same integers.
//
// Segmented lanes, reconciled exactly (andix's chain/segmented.py argument,
// with the one bit the counting adds).  A lane's query is cut into K
// segments [j * ceil(qlen / K), (j + 1) * ceil(qlen / K)) (plan_segments).
// Segment j holds the probe calls of the unsegmented walk that start at a
// position inside it: a call may hop and probe past the segment's end (the
// stop of walk_probe is the query's end), so the calls, their anchors and
// the probe-step tally are the unsegmented walk's, cut where a call
// starts.
// * Pass 1 (replay_cold): every segment walked at once.  Segment 0 starts
//   from the lane's true state (pos = lq = ls = ll = 0), so its walk is the
//   true one and it counts everything.  Segment j >= 1 starts cold, from
//   the canonical state of a gap past the threshold (pos = start, lq = ls
//   = start - thr - 2, ll = 0: _canon / _entry_arrays).  It records its
//   first M + 1 anchors a_0..a_M with the probe step that found each (the
//   trail), counts only the events at a_i with i >= M + 1 (C_j), and
//   leaves its exit state, anchor count and probe steps; in exact mode
//   also its query segment's nucleotides, whose sum is an identical
//   pair's equal count (its one anchor is the whole query).
// * Pass 2 (replay_splice): one walker a lane takes the segments in order.
//   An accepted anchor (q, s, len) forces the state (pos = q + len + 1, lq,
//   ls, ll) whatever came before, so the true walk entering segment j
//   (the repair) and the cold walk are identical from the first anchor a_m
//   both accept, except for last_right at a_m, which only the event at
//   a_m+1 reads.  The event at a_i reads a_i-2..a_i alone.  So the repair
//   counts its own events up to the merge at a_m (m <= M - 1), the events
//   at a_m+1..a_M from the trail (the first with the repair's last_right),
//   then adds C_j, and the cold exit becomes the true exit (its last_right
//   the repair's when a_m is the segment's last anchor).  Probe steps: the
//   repair's up to the merge, plus the cold walk's after a_m.  A repair
//   that finds no trail anchor before a_M walks the whole segment and
//   drops C_j: exact, and at worst the unsegmented walk.
//
// The code is written for THREADS threads that hold the same lane state
// and take the same branches (as walk_lane.cuh): 32 on the card, where the
// threads read an interval's bytes coalesced and each keeps its own column
// of the walker's 16 x THREADS counters in shared memory; 1 in the twin.

#pragma once

#include "walk_lane.cuh"

#define REPLAY_A_BYTE 65

// per-lane counters written beside the counts, for the kernel's bound
#define REPLAY_STATS 3  // probe steps, gap sites, exact-mode equal sites
// per-lane counters of the splice
#define REPLAY_SPLICE 3  // merges, fallbacks (no merge), repair steps

// a sublane's workspace, in ints: what pass 1 leaves for pass 2
#define REPLAY_SEG_CELLS 0   // [16] cells of the events at a_M+1 on
#define REPLAY_SEG_GAP 16    // their gap sites
#define REPLAY_SEG_EQ 17     // their exact-mode equal sites
#define REPLAY_SEG_EXIT 18   // [5] exit pos, lq, ls, ll, last_right
#define REPLAY_SEG_N 23      // anchors accepted
#define REPLAY_SEG_STEPS 24  // probe steps taken
#define REPLAY_SEG_NUC 25    // [4] exact mode: the segment's A, C, T, G
#define REPLAY_SEG_TRAIL 29  // [M + 1][4] the first anchors' q, s, len, step

WALK_HD int replay_seg_ints(int m) { return REPLAY_SEG_TRAIL + 4 * (m + 1); }

struct ReplayLane {
  int row;    // subject row of the tables
  int qoff;   // the query's offset in the blob
  int qs;     // the query's text offset
  int ss;     // the subject RS's text offset
  int rl;     // RS length
  int thr;    // anchor threshold
  int qlen;   // query length (0: the lane does nothing)
};

// [start, end) of segment j of k of a query of qlen symbols (empty past
// the query's end)
WALK_HD void replay_segment(int qlen, int k, int j, int& start, int& end) {
  const long long step = qlen > 0 ? ((long long)qlen + k - 1) / k : 1;
  start = (int)(j * step < qlen ? j * step : qlen);
  end = (int)((j + 1) * step < qlen ? (j + 1) * step : qlen);
}

// A -> 0, C -> 1, G -> 2, T -> 3 (nucl2bit, src/model.c:295-299)
WALK_HD int replay_nucl2bit(int c) {
  c &= 6;
  c ^= c >> 1;
  return c >> 1;
}

// exact-mode equal intervals at least this long are read in 16-byte
// chunks
#define REPLAY_CHUNKED_MIN 256

WALK_HD int replay_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The equal sites among four text bytes, by (s >> 1) & 3 of the bytes at
// least 'A': n[0] A (cell AtoA), n[1] C (CtoC), n[2] T (TtoT), n[3] G
// (GtoG).  Each byte's tests land on its high bit: no borrow or carry
// crosses a byte.
WALK_HD void replay_equal_word(unsigned x, int* n) {
  const unsigned hi = 0x80808080u;
  const unsigned nuc = (((x | hi) - 0x41414141u) | x) & hi;  // s >= 'A'
  const unsigned b1 = (x << 6) & hi;                         // bit 1 of s
  const unsigned b2 = (x << 5) & hi;                         // bit 2 of s
  n[0] += replay_popc(nuc & ~b1 & ~b2);
  n[1] += replay_popc(nuc & b1 & ~b2);
  n[2] += replay_popc(nuc & ~b1 & b2);
  n[3] += replay_popc(nuc & b1 & b2);
}

// the 16 bytes at p (16-byte aligned) as four words
WALK_HD void replay_load16(const unsigned char* p, unsigned* w) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
#else
  for (int k = 0; k < 4; ++k)
    w[k] = (unsigned)p[4 * k] | (unsigned)p[4 * k + 1] << 8 |
           (unsigned)p[4 * k + 2] << 16 | (unsigned)p[4 * k + 3] << 24;
#endif
}

template <int THREADS>
struct ReplayCounter {
  const unsigned char* text;
  long long n;
  int* hist;  // [16, THREADS] this walker's counters
  int tid;
  int* err;   // intervals that did not lie inside the text
  int gap_sites = 0, eq_sites = 0;
  int diag_quarters = 0, tt_rest = 0;  // fast-mode equal counts

  WALK_HD void add(int cell) { hist[cell * THREADS + tid] += 1; }

  // adds a sublane's 16 cells and sites (each thread its own cells)
  WALK_HD void add_cells(const int* c) {
    for (int cell = tid; cell < 16; cell += THREADS)
      hist[cell * THREADS + tid] += c[cell];
    gap_sites += c[16];
    eq_sites += c[17];
  }

  // an interval's bytes all lie in the text (they lie in one segment);
  // a violation is reported, not clamped
  WALK_HD bool inside(long long start, int len) {
    if (start >= 0 && start + len <= n) return true;
#ifdef __CUDA_ARCH__
    if (tid == 0) atomicAdd(err, 1);
#else
    *err += 1;
#endif
    return false;
  }

  // the substitution counts of the gap text[s0, s0 + len) against
  // text[q0, q0 + len)
  WALK_HD void gap(long long s0, long long q0, int len) {
    if (len <= 0 || !inside(s0, len) || !inside(q0, len)) return;
    gap_sites += len;
#pragma unroll 4
    for (int i = tid; i < len; i += THREADS) {
      const int s = text[s0 + i], q = text[q0 + i];
      if (s >= REPLAY_A_BYTE && q >= REPLAY_A_BYTE)
        add((replay_nucl2bit(s) << 2) | replay_nucl2bit(q));
    }
  }

  // equal sites text[b, b + len) of an anchor (model_count_equal)
  WALK_HD void equal(long long b, int len, bool exact) {
    if (len <= 0) return;
    if (!exact) {
      diag_quarters += len >> 2;
      tt_rest += len & 3;
      return;
    }
    if (!inside(b, len)) return;
    eq_sites += len;
    int nuc[4] = {0, 0, 0, 0};
    composition(b, len, nuc);
    add_nuc(nuc);
  }

  // adds nucleotide counts (replay_equal_word's order) to their cells
  WALK_HD void add_nuc(const int* nuc) {
    hist[tid] += nuc[0];
    hist[5 * THREADS + tid] += nuc[1];
    hist[15 * THREADS + tid] += nuc[2];
    hist[10 * THREADS + tid] += nuc[3];
  }

  // this thread's share of the nucleotide counts of text[b, b + len),
  // which lies in the text, added to nuc: short intervals a byte a thread
  // (the loads of 4 rounds in flight); long ones (an identical pair's
  // anchor is the whole query) a 16-byte chunk a thread between the first
  // and the last 16-byte boundary, and the edge bytes in one round
  WALK_HD void composition(long long b, int len, int* nuc) const {
    const unsigned char* p = text + b;
    if (len < REPLAY_CHUNKED_MIN) {
#pragma unroll 4
      for (int i = tid; i < len; i += THREADS) replay_equal_word(p[i], nuc);
      return;
    }
    const int head = (int)((16 - ((unsigned long long)p & 15)) & 15);
    const int chunks = (len - head) >> 4;
    const int edges = len - 16 * chunks;  // head + tail < 32
    for (int i = tid; i < edges; i += THREADS)
      replay_equal_word(p[i < head ? i : i + 16 * chunks], nuc);
#pragma unroll 4
    for (int c = tid; c < chunks; c += THREADS) {
      unsigned w[4];
      replay_load16(p + head + 16 * c, w);
      for (int k = 0; k < 4; ++k) replay_equal_word(w[k], nuc);
    }
  }
};

// the sum of x over the lane's threads (a warp on the card)
WALK_HD int replay_lane_sum(int x) {
#ifdef __CUDA_ARCH__
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(WALK_FULL_MASK, x, o);
#endif
  return x;
}

// The event at an accepted anchor (q, s, len) after the state w: the
// previous anchor's equal sites and the gap between them (when `count`),
// then the anchor becomes the state's.  The caller moves w.pos.
template <int THREADS>
WALK_HD void replay_event(const ReplayLane& r, WalkLane& w, bool& last_right,
                          int q, int s, int len, bool exact, bool count,
                          ReplayCounter<THREADS>& cnt) {
  const int border = r.rl / 2;
  const int end_s = w.ls + w.ll, end_q = w.lq + w.ll;
  const bool paired = s > end_s && q - end_q == s - end_s &&
                      ((s < border) == (w.ls < border));
  if (count) {
    if (paired || last_right || w.ll >= 2 * r.thr)
      cnt.equal((long long)r.qs + w.lq, w.ll, exact);
    if (paired)
      cnt.gap((long long)r.ss + end_s, (long long)r.qs + end_q, q - end_q);
  }
  w.lq = q;
  w.ls = s;
  w.ll = len;
  last_right = paired;
}

// Pass 1: walks segment j of k of lane r (not empty) from its entry and
// fills its workspace `seg` (replay_seg_ints(m) ints) but the 16 cells
// and sites, which the caller writes from cnt (zeroed by the caller).
// Thread 0 writes.
template <int ROW_WIN, int DIAG_WIN, int THREADS>
WALK_HD void replay_cold(const WalkTables& t, const ReplayLane& r, int k,
                         int j, int m, bool exact, int chase,
                         ReplayCounter<THREADS>& cnt, int* seg) {
  int start, end;
  replay_segment(r.qlen, k, j, start, end);
  const int cold = j == 0 ? 0 : start - r.thr - 2;
  WalkLane w{r.row, r.qoff, r.qs, r.ss, r.rl, r.thr, r.qlen,
             start, cold, cold, 0, false};
  WalkWindows<ROW_WIN, DIAG_WIN, 1, THREADS> win(t, w, nullptr, cnt.tid);
  const bool leader = cnt.tid == 0;
  int* trail = seg + REPLAY_SEG_TRAIL;
  bool last_right = false;
  int probes = 0, n = 0;
  while (w.pos < end) {
    const WalkProbe p = walk_probe(win, w, r.qlen, chase);
    ++probes;
    if (p.pos_qj >= r.qlen) {  // the chain ends
      w.pos = p.pos_qj;
      break;
    }
    if (p.found) {
      if (n <= m && leader) {
        trail[4 * n] = p.pos_qj;
        trail[4 * n + 1] = p.this_s;
        trail[4 * n + 2] = p.this_len;
        trail[4 * n + 3] = probes;
      }
      replay_event(r, w, last_right, p.pos_qj, p.this_s, p.this_len, exact,
                   j == 0 || n > m, cnt);
      ++n;
    }
    w.pos = p.pos_qj + p.this_len + 1;
  }
  // exact mode: the query segment's nucleotides, which pass 2 sums for
  // an identical pair (its one anchor spans the query)
  if (exact && cnt.inside((long long)r.qs + start, end - start)) {
    int nuc[4] = {0, 0, 0, 0};
    cnt.composition((long long)r.qs + start, end - start, nuc);
    for (int c = 0; c < 4; ++c) {
      const int sum = replay_lane_sum(nuc[c]);
      if (leader) seg[REPLAY_SEG_NUC + c] = sum;
    }
  }
  if (leader) {
    seg[REPLAY_SEG_EXIT] = w.pos;
    seg[REPLAY_SEG_EXIT + 1] = w.lq;
    seg[REPLAY_SEG_EXIT + 2] = w.ls;
    seg[REPLAY_SEG_EXIT + 3] = w.ll;
    seg[REPLAY_SEG_EXIT + 4] = last_right;
    seg[REPLAY_SEG_N] = n;
    seg[REPLAY_SEG_STEPS] = probes;
  }
}

// Pass 2: splices lane r's k segments (their workspaces `segs`, sublane j
// at segs + j * replay_seg_ints(m)) into the true walk, counting into cnt
// (zeroed by the caller); returns the lane's probe steps and adds to
// splice[REPLAY_SPLICE] (thread 0 writes).
template <int ROW_WIN, int DIAG_WIN, int THREADS>
WALK_HD int replay_splice(const WalkTables& t, const ReplayLane& r, int k,
                          int m, const int* segs, bool exact, int chase,
                          ReplayCounter<THREADS>& cnt, int* splice) {
  const int stride = replay_seg_ints(m);
  const int* exit0 = segs + REPLAY_SEG_EXIT;
  WalkLane w{r.row, r.qoff, r.qs, r.ss, r.rl, r.thr, r.qlen,
             exit0[0], exit0[1], exit0[2], exit0[3], false};
  bool last_right = exit0[4] != 0;
  cnt.add_cells(segs);
  int probes = segs[REPLAY_SEG_STEPS];
  int merges = 0, fallbacks = 0, repair_steps = 0;
  WalkWindows<ROW_WIN, DIAG_WIN, 1, THREADS> win(t, w, nullptr, cnt.tid);
  for (int j = 1; j < k; ++j) {
    int start, end;
    replay_segment(r.qlen, k, j, start, end);
    if (w.pos >= end) continue;  // empty, or passed over by the true walk
    const int* seg = segs + (long long)j * stride;
    const int* trail = seg + REPLAY_SEG_TRAIL;
    const int n = seg[REPLAY_SEG_N];
    const int nt = n < m + 1 ? n : m + 1;  // trail anchors
    int tp = 0, merged = -1;
    // the repair: the true walk from the true entry until it accepts a
    // trail anchor a_tp with tp <= m - 1, or leaves the segment
    while (w.pos < end) {
      const WalkProbe p = walk_probe(win, w, r.qlen, chase);
      ++probes;
      ++repair_steps;
      if (p.pos_qj >= r.qlen) {
        w.pos = p.pos_qj;
        break;
      }
      w.pos = p.pos_qj + p.this_len + 1;
      if (!p.found) continue;
      replay_event(r, w, last_right, p.pos_qj, p.this_s, p.this_len, exact,
                   true, cnt);
      while (tp < nt && trail[4 * tp] < p.pos_qj) ++tp;
      if (tp < m && tp < nt && trail[4 * tp] == p.pos_qj &&
          trail[4 * tp + 1] == p.this_s && trail[4 * tp + 2] == p.this_len) {
        merged = tp;
        break;
      }
    }
    if (merged < 0) {  // walked the whole segment: its true exit is w
      ++fallbacks;
      continue;
    }
    ++merges;
    // the events at a_m+1..a_M from the trail, then C_j
    for (int i = merged + 1; i < nt; ++i)
      replay_event(r, w, last_right, trail[4 * i], trail[4 * i + 1],
                   trail[4 * i + 2], exact, true, cnt);
    cnt.add_cells(seg);
    probes += seg[REPLAY_SEG_STEPS] - trail[4 * merged + 3];
    const int* ex = seg + REPLAY_SEG_EXIT;
    w.pos = ex[0];
    w.lq = ex[1];
    w.ls = ex[2];
    w.ll = ex[3];
    if (n > nt) last_right = ex[4] != 0;  // the segment's last anchor is
                                          // past the trail
  }
  if (w.ll >= r.qlen && exact) {
    // identical sequences: the query's equal sites are the sum of its
    // segments' nucleotides (pass 1 read them in parallel)
    int nuc[4] = {0, 0, 0, 0};
    for (int j = 0; j < k; ++j) {
      int start, end;
      replay_segment(r.qlen, k, j, start, end);
      if (start >= end) continue;
      for (int c = 0; c < 4; ++c)
        nuc[c] += segs[(long long)j * stride + REPLAY_SEG_NUC + c];
    }
    cnt.eq_sites += r.qlen;
    if (cnt.tid == 0) cnt.add_nuc(nuc);
  } else if (w.ll >= r.qlen) {
    cnt.equal(r.qs, r.qlen, exact);  // identical sequences
  } else if (last_right || w.ll >= 2 * r.thr) {
    cnt.equal((long long)r.qs + w.lq, w.ll, exact);  // the trailing anchor
  }
  if (cnt.tid == 0) {
    splice[0] += merges;
    splice[1] += fallbacks;
    splice[2] += repair_steps;
  }
  return probes;
}
