// Per-lane body of the search-in-the-loop chain walk, shared by the CUDA
// kernel (walk_sx.cu, one thread per lane) and its host twin
// (walk_sx_cpu.cpp, built with g++ for the tests).
//
// Semantics are those of andix/chain/walk_sx.py:chain_walk_flat_sx: the
// anchor scan dist_anchor (src/process.c:141-214) where each probe's match
// statistics come from a bisection over the lane's subject suffix array,
// seeded by the k-mer cache bracket, with 16-symbol packed-word compares.
// A lane is a state machine over four phases (P_FIRST probe start,
// P_LUCKY lucky-anchor extension, P_BIS bisection compare, P_AB both
// boundary extensions); one call of sx_iteration is one iteration of the
// JAX loop body for one lane, with the same order of updates:
//   * probe-start control runs before the compares, and the first
//     bisection mid uses the lo/hi it has just set;
//   * the bisection's mid uses lo/hi from before its own update;
//   * the late seek after a failed lucky anchor or a bisection step sets
//     the next mid or the boundary pair in the same iteration;
//   * the uniqueness test reads LCP[ipv - 1] / LCP[ipv + 1] of the
//     boundary pair it finishes.
//
// The JAX loop runs all lanes in lock-step, in super-steps of `unroll`
// iterations, and counts whole super-steps.  Here a lane runs until it
// finishes or reaches max_iters rounded up to a multiple of `unroll`, and
// reports its own count rounded up the same way; the caller takes the
// maximum over lanes, which is the lock-step loop's count.
//
// Words are uint64_t: a word whose top nibble is the separator (8) or
// padding (9) code is a negative int64, and shifting a negative int64 left
// is undefined in C++.  The masks of _combine_window stay (they make the
// logical and arithmetic right shifts agree), and r == 0 never shifts
// by 64.
//
// Before including this header define SX_ATOMIC_ADD(ptr, v): it must
// return the old value of *ptr and add v.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SX_HD __host__ __device__ __forceinline__
#else
#define SX_HD inline
#endif

#define SX_FIRST 0
#define SX_LUCKY 1
#define SX_BIS 2
#define SX_AB 3

struct SxIndex {
  const int* salcp;       // [S, 2, lp]: [:, 0] suffix array, [:, 1] LCP
  const uint64_t* sw;     // [S, lp / 16] subject packed words
  const int* cache2;      // [S, n_cache] k-mer insertion points
  const int* nreal;       // [S] real text length per subject
  const uint64_t* qw;     // [n_qw] query packed words
  long long lp;           // padded index length (row stride of salcp)
  long long n_qw;
  long long n_cache;      // 4^cache_k + 1
  int cache_k;
};

struct SxLane {
  int row, qwb, rl, thr, seg_end;  // geometry
  int pos, lq, ls, ll;             // chain state
  bool fin;
};

struct SxEvents {
  int* lane;
  int* q;
  int* s;
  int* len;
  int* count;  // total found, may exceed cap
  int cap;
};

SX_HD long long sx_clip(long long c, long long last) {
  return c < 0 ? 0 : (c > last ? last : c);
}

// 16-symbol window starting r nibbles into w0 (0 <= r <= 15)
SX_HD uint64_t sx_window(uint64_t w0, uint64_t w1, int r) {
  if (r == 0) return w0;
  return (w0 << (4 * r)) |
         ((w1 >> (4 * (16 - r))) & ((1ull << (4 * r)) - 1ull));
}

// agreeing symbols between two windows (16 iff equal): clz(a ^ b) >> 2
SX_HD int sx_word_lcp(uint64_t a, uint64_t b) {
  const uint64_t x = a ^ b;
#ifdef __CUDA_ARCH__
  return __clzll((long long)x) >> 2;  // __clzll(0) == 64
#else
  return x ? __builtin_clzll(x) >> 2 : 16;
#endif
}

SX_HD int sx_nibble(uint64_t w, int i) {
  return (int)((w >> (4 * (15 - i))) & 15ull);
}

// the window of the packed words `w` (length n) at symbol position p;
// word indices are clamped to the last word, as the JAX gathers are
SX_HD uint64_t sx_fetch(const uint64_t* w, long long n, long long p) {
  const long long j = p >> 4;
  const long long last = n - 1;
  return sx_window(w[j < last ? j : last], w[j + 1 < last ? j + 1 : last],
                   (int)(p & 15));
}

// reference lucky-anchor precondition (src/process.c:82-100,156): within
// the threshold of the last anchor, projected onto its diagonal
SX_HD bool sx_lucky(const SxLane& w, int* try_s) {
  const int advance = w.pos - w.lq;
  const int gap = advance - w.ll;
  *try_s = w.ls + advance;
  return !w.fin && w.pos < w.seg_end && *try_s < w.rl && gap >= 0 &&
         gap <= w.thr;
}

// Walks lane `lane` from its entry state; returns its iteration count,
// rounded up to a multiple of `unroll` (0 for a lane finished at entry).
// Events are recorded in chain order.
SX_HD int sx_walk_lane(const SxIndex& x, int lane, SxLane& w, int max_iters,
                       int max_events, int unroll, const SxEvents& ev) {
  const int nr = x.nreal[w.row];
  const int* sa = x.salcp + (long long)w.row * 2 * x.lp;
  const int* lcp = sa + x.lp;
  const long long last = x.lp - 1;
  const long long nw = x.lp / 16;
  const uint64_t* sw = x.sw + (long long)w.row * nw;
  const int* cache = x.cache2 + (long long)w.row * x.n_cache;

  w.fin = (w.pos >= w.seg_end) || (0 >= max_events);
  int try_s;
  int spA = sx_lucky(w, &try_s) ? try_s : 0;
  if (w.fin) return 0;
  const long long cap =
      max_iters <= 0 ? 0
                     : ((long long)max_iters + unroll - 1) / unroll * unroll;
  int evn = 0, ph = SX_FIRST, h = 0, spB = 0, lo = 0, hi = 0, llo = 0,
      lhi = 0, ipv = 0, aa = -1, bb = -1;
  long long it = 0;
  while (!w.fin && it < cap) {
    ++it;
    const uint64_t wq = sx_fetch(x.qw, x.n_qw, (long long)w.qwb + w.pos + h);

    // ---- probe-start control: k-mer code + cache bracket + seek ----
    if (ph == SX_FIRST) {
      int code = 0;
      bool valid = true;
      for (int i = 0; i < x.cache_k; ++i) {
        const int nib = sx_nibble(wq, i);
        valid = valid && nib >= 4 && nib <= 7;
        const int c = nib - 4;
        code = (code << 2) | (c < 0 ? 0 : (c > 3 ? 3 : c));
      }
      lo = valid ? cache[code] : 0;
      hi = valid ? cache[code + 1] : nr;
      llo = 0;
      lhi = 0;
      if (sx_lucky(w, &try_s)) {
        ph = SX_LUCKY;  // spA already holds try_s (set at the probe end)
      } else if (lo < hi) {
        spA = sa[sx_clip(((long long)lo + hi) >> 1, last)];
        ph = SX_BIS;
      } else {
        ipv = lo;
        spA = sa[sx_clip((long long)ipv - 1, last)];
        spB = sa[sx_clip(ipv, last)];
        ph = SX_AB;
      }
    }

    // ---- compares (A slot: lucky/bis/left boundary; B slot: right) ----
    const bool in_lucky = ph == SX_LUCKY;
    const bool in_bis = ph == SX_BIS;
    const bool in_ab = ph == SX_AB;
    const bool a_act = in_lucky || in_bis || (in_ab && aa < 0 && ipv > 0);
    const bool b_act = in_ab && bb < 0 && ipv < nr;
    uint64_t wsA = 0;
    int mA = 16, mB = 16;
    if (a_act) {
      wsA = sx_fetch(sw, nw, (long long)spA + h);
      mA = sx_word_lcp(wq, wsA);
    }
    if (b_act) mB = sx_word_lcp(wq, sx_fetch(sw, nw, (long long)spB + h));
    const bool mmA = mA < 16, mmB = mB < 16;
    const int lcpA = h + mA, lcpB = h + mB;

    // lucky resolution
    const bool l_done = in_lucky && mmA;
    const bool l_acc = l_done && lcpA >= w.thr;
    const bool l_fail = l_done && !l_acc;

    // bisection resolution (mid from the lo/hi before this update)
    const bool b_done = in_bis && mmA;
    if (b_done) {
      const int mid = (int)(((long long)lo + hi) >> 1);
      const int mi = mA < 15 ? mA : 15;
      if (sx_nibble(wq, mi) < sx_nibble(wsA, mi)) {
        hi = mid;
        lhi = lcpA;
      } else {
        lo = mid + 1;
        llo = lcpA;
      }
    }

    // boundary resolutions
    if (in_ab && a_act && mmA) aa = lcpA;
    if (in_ab && b_act && mmB) bb = lcpB;
    const bool ab_done =
        in_ab && (aa >= 0 || ipv <= 0) && (bb >= 0 || ipv >= nr);

    // shared-offset advance while anything still extends
    if ((in_lucky && !mmA) || (in_bis && !mmA) ||
        (in_ab && !ab_done && ((a_act && !mmA) || (b_act && !mmB))))
      h += 16;

    // ---- late seek: failed lucky / resolved bisection step ----
    if (l_fail || b_done) {
      if (lo < hi) {
        spA = sa[sx_clip(((long long)lo + hi) >> 1, last)];
        ph = SX_BIS;
      } else {
        ipv = lo;
        spA = sa[sx_clip((long long)ipv - 1, last)];
        spB = sa[sx_clip(ipv, last)];
        ph = SX_AB;
      }
      h = llo < lhi ? llo : lhi;
    }

    // ---- final: stats, chain update, next-probe setup ----
    if (ab_done || l_acc) {
      bool found;
      int this_len, this_s;
      if (l_acc) {
        found = true;
        this_len = lcpA;
        this_s = spA;
      } else {
        const int ml = aa > bb ? (aa > 0 ? aa : 0) : (bb > 0 ? bb : 0);
        const bool use_a = aa >= bb;
        bool unique = false;
        if (ml > 0 && aa != bb) {
          if (use_a) {
            unique = lcp[sx_clip(ipv - 1 > 0 ? ipv - 1 : 0, last)] < aa;
          } else {
            unique = ipv + 1 >= nr ||
                     lcp[sx_clip(ipv + 1 < nr ? ipv + 1 : 0, last)] < bb;
          }
        }
        found = unique && ml >= w.thr;
        this_len = ml;
        this_s = use_a ? spA : spB;
      }
      if (found) {
        const int slot = SX_ATOMIC_ADD(ev.count, 1);
        if (slot < ev.cap) {
          ev.lane[slot] = lane;
          ev.q[slot] = w.pos;
          ev.s[slot] = this_s;
          ev.len[slot] = this_len;
        }
        w.lq = w.pos;
        w.ls = this_s;
        w.ll = this_len;
        ++evn;
      }
      w.pos = w.pos + this_len + 1;
      w.fin = (w.pos >= w.seg_end) || (evn >= max_events);
      ph = SX_FIRST;
      h = 0;
      aa = -1;
      bb = -1;
      spA = sx_lucky(w, &try_s) ? try_s : 0;
    }
  }
  return (int)((it + unroll - 1) / unroll * unroll);
}
