// Per-lane body of the count-in-loop replay, shared by the CUDA kernel
// (replay.cu, one warp per lane) and its host twin (replay_cpu.cpp, built
// with g++ for the tests, one thread per lane).
//
// Semantics are those of andix/chain/replay_device.py:replay_rows_device
// (the anchor scan dist_anchor with its counting, src/process.c:141-214):
// a lane is one (subject row, query) pair, walked unsegmented from
// position 0 to the query's end with the flat walk's probe step
// (walk_probe, walk_lane.cuh), and instead of recording anchors it counts
// the 16 substitution cells as it goes:
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
// diagonal cell of the byte (exact: LogDet and ANI).
//
// andix queues the gap and equal intervals and drains them over later
// iterations of its lock-step loop, promoting the trailing interval into
// the equal slot; a lane here counts each interval at once, in the probe
// that makes it due, and the sums are the same integers.
//
// The code is written for THREADS threads that hold the same lane state
// and take the same branches (as walk_lane.cuh): 32 on the card, where the
// threads read an interval's bytes coalesced and each keeps its own column
// of the lane's 16 x THREADS counters in shared memory; 1 in the twin.

#pragma once

#include "walk_lane.cuh"

#define REPLAY_A_BYTE 65

// per-lane counters written beside the counts, for the kernel's bound
#define REPLAY_STATS 3  // probe steps, gap sites, exact-mode equal sites

struct ReplayLane {
  int row;    // subject row of the tables
  int qoff;   // the query's offset in the blob
  int qs;     // the query's text offset
  int ss;     // the subject RS's text offset
  int rl;     // RS length
  int thr;    // anchor threshold
  int qlen;   // query length (0: the lane does nothing)
};

// A -> 0, C -> 1, G -> 2, T -> 3 (nucl2bit, src/model.c:295-299)
WALK_HD int replay_nucl2bit(int c) {
  c &= 6;
  c ^= c >> 1;
  return c >> 1;
}

template <int THREADS>
struct ReplayCounter {
  const unsigned char* text;
  long long n;
  int* hist;  // [16, THREADS] this lane's counters
  int tid;
  int* err;   // intervals that did not lie inside the text
  int gap_sites = 0, eq_sites = 0;
  int diag_quarters = 0, tt_rest = 0;  // fast-mode equal counts

  WALK_HD void add(int cell) { hist[cell * THREADS + tid] += 1; }

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
#pragma unroll 4
    for (int i = tid; i < len; i += THREADS) {
      const int s = text[b + i];
      // (s >> 1) & 3: A -> 0, C -> 1, T -> 2, G -> 3; cells AtoA CtoC
      // TtoT GtoG, packed as nibbles
      if (s >= REPLAY_A_BYTE) add((0xAF50 >> (4 * ((s >> 1) & 3))) & 15);
    }
  }
};

// Replays lane r and accumulates its counts into hist (zeroed by the
// caller); returns the probe steps it took.  Every thread of the lane
// calls it with the same arguments but its own counter column.
template <int ROW_WIN, int DIAG_WIN, int THREADS>
WALK_HD int replay_lane(const WalkTables& t, const ReplayLane& r, bool exact,
                        int chase, ReplayCounter<THREADS>& cnt) {
  WalkLane w{r.row, r.qoff, r.qs, r.ss, r.rl, r.thr, r.qlen, 0, 0, 0, 0,
             false};
  WalkWindows<ROW_WIN, DIAG_WIN, 1, THREADS> win(t, w, nullptr, cnt.tid);
  const int border = r.rl / 2;
  const long long qs = r.qs, ss = r.ss;
  bool last_right = false;
  int probes = 0;
  while (w.pos < r.qlen) {
    const WalkProbe p = walk_probe(win, w, r.qlen, chase);
    ++probes;
    if (p.pos_qj >= r.qlen) break;
    if (p.found) {
      const int end_s = w.ls + w.ll, end_q = w.lq + w.ll;
      const bool paired = p.this_s > end_s &&
                          p.pos_qj - end_q == p.this_s - end_s &&
                          ((p.this_s < border) == (w.ls < border));
      if (paired || last_right || w.ll >= 2 * r.thr)
        cnt.equal(qs + w.lq, w.ll, exact);
      if (paired) cnt.gap(ss + end_s, qs + end_q, p.pos_qj - end_q);
      w.lq = p.pos_qj;
      w.ls = p.this_s;
      w.ll = p.this_len;
      last_right = paired;
    }
    w.pos = p.pos_qj + p.this_len + 1;
  }
  if (r.qlen > 0) {
    if (w.ll >= r.qlen)
      cnt.equal(qs, r.qlen, exact);  // identical sequences
    else if (last_right || w.ll >= 2 * r.thr)
      cnt.equal(qs + w.lq, w.ll, exact);  // the trailing anchor
  }
  return probes;
}
