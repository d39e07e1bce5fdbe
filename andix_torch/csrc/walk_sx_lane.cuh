// Per-lane body of the search-in-the-loop chain walk, shared by the CUDA
// kernel (walk_sx.cu, one warp per lane) and its host twin
// (walk_sx_cpu.cpp, built with g++ for the tests, one thread per lane).
//
// Semantics are those of andix/chain/walk_sx.py:chain_walk_flat_sx: the
// anchor scan dist_anchor (src/process.c:141-214) where each probe's match
// statistics come from a bisection over the lane's subject suffix array,
// seeded by the k-mer cache bracket, with 16-symbol packed-word compares.
//
// The JAX loop is a state machine that compares one 16-symbol word per
// iteration.  Here a lane runs one whole probe at a time, and each compare
// takes ROUND words per round (32 on the card, one a thread); the
// iterations the one-word loop would have spent are counted from the
// compare outcomes (SxWalk::walk).  A probe is:
//   * a lucky check when the reference's precondition holds (the
//     extension of the last anchor's diagonal), from offset 0;
//   * unless it is accepted, bisection steps while lo < hi, each a
//     compare of the query against SA[mid] from min(l_lo, l_hi);
//   * unless it was accepted, the boundary pair SA[ip - 1] / SA[ip], both
//     compared from the same offset, then the uniqueness test on LCP.
// A compare from offset h whose first mismatching word is t costs t + 1
// iterations of the one-word loop; the probe-start control runs in the
// first iteration of the first compare, a failed lucky check or a
// bisection step seeks in its last one, and the boundary pair costs 1 +
// the larger of its active slots' t, the final running in that iteration.
// A probe that would end past the lane's iteration cap leaves the lane in
// its state before the probe with the cap spent (the JAX loop's phase,
// offset and bracket are local to a probe, so nothing else is lost).
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
// by 64.  Word indices past an array's end are clamped to its last word,
// as the JAX gathers are.
//
// What a lane reads, it reads in rounds of ROUND words:
// * query words through a window of QWIN consecutive words (the lane's
//   position only rises within a segment, so a window serves many probes);
// * for lucky checks, subject words through a window of DWIN consecutive
//   words of the lane's row (along a homologous stretch the next lucky
//   checks fall in it);
// * for bisection and boundary compares, the subject words directly: two
//   words a compared word, consecutive across the round (the boundary
//   pair's two slots in the same rounds);
// * suffix array, LCP and cache entries one at a time (one address); the
//   cache bracket only when the lucky check does not settle the probe, and
//   the boundary pair's LCP entries together with its suffix array
//   entries, before its compares.
// Accepted anchors are staged STAGE at a time, then one reservation of
// that many consecutive slots on the global counter and one write of the
// batch in chain order (slots at or past the capacity are dropped, the
// counter still counts them).
//
// The code is written for THREADS threads that hold the same lane state
// and take the same branches: 32 on the card (a window fill is one load a
// thread a word slot, a lookup a shuffle, a first mismatch a ballot), 1 in
// the host twin (loops).  The twin is built at the kernel's sizes and at
// tiny ones, so the tests cross every window, round and staging boundary
// many times.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SX_HD __host__ __device__ __forceinline__
#else
#define SX_HD inline
#endif

// the kernel's round, window and staging sizes (the host twin is also
// built at tiny ones)
#define SX_ROUND 32   // words a compare round: one a thread
#define SX_QWIN 64    // query words, 2 a thread
#define SX_DWIN 64    // subject words of the lucky diagonal, 2 a thread
#define SX_STAGE 32
#define SX_FULL_MASK 0xffffffffu

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

SX_HD int sx_min(int a, int b) { return a < b ? a : b; }

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

// The cache code of the window's first k symbols (k <= 15): valid when
// each is a base (codes 4..7), and then the bases' 2-bit values in order.
// Nibbles 4..7 are those whose top two bits are 01; their low two bits
// are packed from 4-bit to 2-bit fields in log steps.
SX_HD bool sx_kmer_code(uint64_t w, int k, int* code) {
  if (k == 0) {
    *code = 0;
    return true;
  }
  const uint64_t x = w >> (64 - 4 * k);
  const uint64_t ones = ~0ull >> (64 - 4 * k);  // k nibbles of 1s
  const bool valid = (x & (ones & 0xCCCCCCCCCCCCCCCCull)) ==
                     (ones & 0x4444444444444444ull);
  uint64_t v = x & 0x3333333333333333ull;
  v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v >> 4)) & 0x00FF00FF00FF00FFull;
  v = (v | (v >> 8)) & 0x0000FFFF0000FFFFull;
  v = (v | (v >> 16)) & 0x00000000FFFFFFFFull;
  *code = (int)v;
  return valid;
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

// N consecutive words of an array (indices clamped to `last`) held by
// THREADS threads: thread tid keeps words base + tid + THREADS * k.
template <int N, int THREADS>
struct SxWordWindow {
  static_assert(N % THREADS == 0, "whole words a thread");
  static constexpr int K = N / THREADS;
  int base;
  uint64_t w[K];

  SX_HD SxWordWindow() : base(-N - 1) {
    for (int k = 0; k < K; ++k) w[k] = 0;
  }

  // makes words [lo, hi] of src (clamped indices, hi - lo < N) available
  SX_HD void cover(const uint64_t* src, int last, int lo, int hi, int tid) {
    if (lo >= base && hi < base + N) return;
    base = lo;
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[k] = src[sx_clip(base + tid + THREADS * k, last)];
  }

  // the word at clamped index j (covered); on the card every thread of
  // the warp calls it, each with its own j
  SX_HD uint64_t at(int j) const {
    const int e = j - base;
#ifdef __CUDA_ARCH__
    uint64_t out = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint64_t x = __shfl_sync(SX_FULL_MASK, w[k], e % THREADS);
      if (e / THREADS == k) out = x;
    }
    return out;
#else
    return w[e];
#endif
  }
};

// The outcome of one compare: the first mismatching word t (from the
// compare's start offset), the agreeing symbols m < 16 in it, and whether
// the query symbol there is below the subject's; t < 0 when no word below
// `limit` mismatches.
struct SxCmp {
  int t;
  int m;
  bool less;
};

// One lane's walk: the windows, the staging of its events and the probe
// loop.  Every thread of the lane builds it with the same arguments but
// its own `tid`; `stage` is the lane's [3, STAGE] staging buffer (shared
// by its threads).
template <int ROUND, int QWIN, int DWIN, int STAGE, int THREADS>
struct SxWalk {
  static_assert(ROUND % THREADS == 0, "whole words a thread a round");
  static_assert(QWIN > ROUND && DWIN > ROUND, "a round's words fit");
  static constexpr int RW = ROUND / THREADS;  // words a thread a round

  const SxIndex& x;
  const int* sa;       // the row's suffix array; its LCP follows at lp
  const uint64_t* sw;  // the row's packed words
  int row, sa_last, sw_last, qw_last;
  int tid;
  SxWordWindow<QWIN, THREADS> qwin;
  SxWordWindow<DWIN, THREADS> dwin;
  int* stage;
  int nst;

  SX_HD SxWalk(const SxIndex& index, int lane_row, int* stage_buf,
               int thread)
      : x(index),
        sa(index.salcp + (long long)lane_row * 2 * index.lp),
        sw(index.sw + (long long)lane_row * (index.lp / 16)),
        row(lane_row),
        sa_last((int)(index.lp - 1)),
        sw_last((int)(index.lp / 16 - 1)),
        qw_last((int)(index.n_qw - 1)),
        tid(thread),
        stage(stage_buf),
        nst(0) {}

  SX_HD int lcp_at(int i) const { return sa[x.lp + sx_clip(i, sa_last)]; }

  // the first mismatch among this thread's words of a round (k order),
  // then the warp's first (ballot); t < 0 where the round has none
  SX_HD SxCmp first_mismatch(int r0, const int* mm, const bool* less,
                             bool want_less) const {
#ifdef __CUDA_ARCH__
    const unsigned hit = __ballot_sync(SX_FULL_MASK, mm[0] < 16);
    if (!hit) return {-1, 16, false};
    const int src = __ffs(hit) - 1;
    return {r0 + src, __shfl_sync(SX_FULL_MASK, mm[0], src),
            want_less && __shfl_sync(SX_FULL_MASK, less[0] ? 1 : 0, src)};
#else
    for (int k = 0; k < RW; ++k)
      if (mm[k] < 16) return {r0 + k, mm[k], want_less && less[k]};
    return {-1, 16, false};
#endif
  }

  // Compares the query from symbol q0 of the blob with the subject row
  // from sA (slot A, when actA) and from sB (slot B, when actB), word
  // after word in rounds of ROUND words, both slots in the same rounds,
  // up to `limit` words (limit >= 1).  A slot's t is -1 when no word
  // below `limit` mismatches.  The lucky check (slot A only) reads the
  // subject through the diagonal window; only a bisection step (slot A
  // only) needs `less`.
  SX_HD void compare(int q0, int sA, bool actA, int sB, bool actB,
                     long long limit, bool lucky, bool want_less, SxCmp& ca,
                     SxCmp& cb) {
    ca = cb = {-1, 16, false};
    const int rq = (int)(q0 & 15), ra = (int)(sA & 15), rb = (int)(sB & 15);
    const int jq = q0 >> 4, ja = sA >> 4, jb = sB >> 4;
    for (int r0 = 0; r0 < limit && (actA || actB); r0 += ROUND) {
      qwin.cover(x.qw, qw_last, sx_min(jq + r0, qw_last),
                 sx_min(jq + r0 + ROUND, qw_last), tid);
      if (lucky)
        dwin.cover(sw, sw_last, sx_min(ja + r0, sw_last),
                   sx_min(ja + r0 + ROUND, sw_last), tid);
      int ma[RW], mb[RW];
      bool la[RW], lb[RW];
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int t = r0 + tid + THREADS * k;
        const uint64_t wq = sx_window(qwin.at(sx_min(jq + t, qw_last)),
                                      qwin.at(sx_min(jq + t + 1, qw_last)),
                                      rq);
        ma[k] = mb[k] = 16;
        la[k] = lb[k] = false;
        if (actA) {
          const int a = sx_min(ja + t, sw_last);
          const int a1 = sx_min(ja + t + 1, sw_last);
          const uint64_t ws = lucky ? sx_window(dwin.at(a), dwin.at(a1), ra)
                                    : sx_window(sw[a], sw[a1], ra);
          ma[k] = sx_word_lcp(wq, ws);
          const int mi = ma[k] < 15 ? ma[k] : 15;
          la[k] = want_less && sx_nibble(wq, mi) < sx_nibble(ws, mi);
        }
        if (actB) {
          const int b = sx_min(jb + t, sw_last);
          const uint64_t ws =
              sx_window(sw[b], sw[sx_min(jb + t + 1, sw_last)], rb);
          mb[k] = sx_word_lcp(wq, ws);
        }
      }
      if (actA) {
        const SxCmp c = first_mismatch(r0, ma, la, want_less);
        if (c.t >= 0) {
          ca = {c.t < limit ? c.t : -1, c.m, c.less};
          actA = false;
        }
      }
      if (actB) {
        const SxCmp c = first_mismatch(r0, mb, lb, false);
        if (c.t >= 0) {
          cb = {c.t < limit ? c.t : -1, c.m, c.less};
          actB = false;
        }
      }
    }
  }

  // reserves slots for the staged events and writes them in chain order
  SX_HD void flush(const SxEvents& ev, int lane) {
    if (nst == 0) return;
    int base = 0;
#ifdef __CUDA_ARCH__
    __syncwarp();
    if (tid == 0) base = atomicAdd(ev.count, nst);
    base = __shfl_sync(SX_FULL_MASK, base, 0);
#else
    base = *ev.count;
    *ev.count = base + nst;
#endif
    for (int k = tid; k < nst; k += THREADS) {
      const int slot = base + k;
      if (slot < ev.cap) {
        ev.lane[slot] = lane;
        ev.q[slot] = stage[k];
        ev.s[slot] = stage[STAGE + k];
        ev.len[slot] = stage[2 * STAGE + k];
      }
    }
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
    nst = 0;
  }

  SX_HD void record(int q, int s, int len, const SxEvents& ev, int lane) {
    if (tid == 0) {
      stage[nst] = q;
      stage[STAGE + nst] = s;
      stage[2 * STAGE + nst] = len;
    }
    if (++nst == STAGE) flush(ev, lane);
  }

  // Walks lane `lane` from its entry state; returns its iteration
  // count, rounded up to a multiple of `unroll` (0 for a lane finished at
  // entry).  Events are recorded in chain order.
  SX_HD int walk(int lane, SxLane& w, int max_iters, int max_events,
                 int unroll, const SxEvents& ev) {
    const int nr = x.nreal[w.row];
    w.fin = (w.pos >= w.seg_end) || (0 >= max_events);
    if (w.fin) return 0;
    const long long cap =
        max_iters <= 0 ? 0
                       : ((long long)max_iters + unroll - 1) / unroll * unroll;
    int evn = 0;
    long long it = 0;
    while (!w.fin && it < cap) {
      const long long budget = cap - it;  // iterations this probe may take
      long long used = 0;
      const int qa = w.qwb + w.pos;

      // probe-start control: k-mer code of the query at the probe (its
      // cache bracket is read only if the lucky check does not settle
      // the probe)
      const int jq0 = sx_min(qa >> 4, qw_last);
      qwin.cover(x.qw, qw_last, jq0, sx_min((qa >> 4) + ROUND, qw_last),
                 tid);
      const uint64_t wq0 = sx_window(
          qwin.at(jq0), qwin.at(sx_min((qa >> 4) + 1, qw_last)),
          (int)(qa & 15));
      int code;
      const bool valid = sx_kmer_code(wq0, x.cache_k, &code);

      bool final_found = false;
      bool done = false;
      int this_len = 0, this_s = 0;
      int try_s;
      SxCmp ca, cb;
      if (sx_lucky(w, &try_s)) {
        compare(qa, try_s, true, 0, false, budget, true, false, ca, cb);
        if (ca.t < 0) break;
        used += ca.t + 1;
        const int lcp_l = (int)(16LL * ca.t + ca.m);
        if (lcp_l >= w.thr) {
          final_found = done = true;
          this_len = lcp_l;
          this_s = try_s;
        }
      }
      int lo = 0, hi = 0, llo = 0, lhi = 0, h = 0;
      if (!done) {
        const int* cache = x.cache2 + (long long)row * x.n_cache;
        lo = valid ? cache[code] : 0;
        hi = valid ? cache[code + 1] : nr;
      }
      bool stopped = false;
      while (!done && lo < hi) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        const int sp = sa[sx_clip(mid, sa_last)];
        compare(qa + h, sp + h, true, 0, false, budget - used, false, true,
                ca, cb);
        if (ca.t < 0) {
          stopped = true;
          break;
        }
        used += ca.t + 1;
        const int l = (int)(h + 16LL * ca.t + ca.m);
        if (ca.less) {
          hi = mid;
          lhi = l;
        } else {
          lo = mid + 1;
          llo = l;
        }
        h = llo < lhi ? llo : lhi;
      }
      if (stopped) break;
      if (!done) {
        // boundary pair SA[ip - 1] (slot A) and SA[ip] (slot B)
        const int ipv = lo;
        const bool a_act = ipv > 0, b_act = ipv < nr;
        const int spA = sa[sx_clip((long long)ipv - 1, sa_last)];
        const int spB = sa[sx_clip(ipv, sa_last)];
        // the uniqueness test's LCP entries, loaded with the pair
        const int lcpA = lcp_at(ipv - 1 > 0 ? ipv - 1 : 0);
        const int lcpB = lcp_at(ipv + 1 < nr ? ipv + 1 : 0);
        const long long room = budget - used;
        if (room < 1) break;
        compare(qa + h, spA + h, a_act, spB + h, b_act, room, false, false,
                ca, cb);
        if ((a_act && ca.t < 0) || (b_act && cb.t < 0)) break;
        const int ta = a_act ? ca.t : 0, tb = b_act ? cb.t : 0;
        const int aa = a_act ? (int)(h + 16LL * ca.t + ca.m) : -1;
        const int bb = b_act ? (int)(h + 16LL * cb.t + cb.m) : -1;
        used += 1 + (ta > tb ? ta : tb);
        const int ml = aa > bb ? (aa > 0 ? aa : 0) : (bb > 0 ? bb : 0);
        const bool use_a = aa >= bb;
        bool unique = false;
        if (ml > 0 && aa != bb) {
          unique = use_a ? lcpA < aa : (ipv + 1 >= nr || lcpB < bb);
        }
        final_found = unique && ml >= w.thr;
        this_len = ml;
        this_s = use_a ? spA : spB;
      }
      it += used;
      if (final_found) {
        record(w.pos, this_s, this_len, ev, lane);
        w.lq = w.pos;
        w.ls = this_s;
        w.ll = this_len;
        ++evn;
      }
      w.pos = w.pos + this_len + 1;
      w.fin = (w.pos >= w.seg_end) || (evn >= max_events);
    }
    if (!w.fin && it < cap) it = cap;  // stopped inside a probe
    flush(ev, lane);
    return (int)((it + unroll - 1) / unroll * unroll);
  }
};
