// Per-lane body of the flat chain walk, shared by the CUDA kernel
// (chain_walk.cu, one warp per lane) and its host twin (walk_cpu.cpp,
// built with g++ for the tests, one thread per lane).  Its probe step
// (walk_probe) and windows also carry the count-in-loop replay
// (replay_lane.cuh).
//
// Semantics are those of andix/chain/replay_device.py:chain_walk_flat
// (the anchor scan dist_anchor, src/process.c:141-214, on precomputed
// match statistics): every lane walks its query segment from its entry
// state (pos, lq, ls, ll), probing `unroll` positions per loop iteration;
// a probe whose gap to the last anchor exceeds the threshold first hops
// the pure `pos += matchlen + 1` chain to the next anchor candidate (one
// hop plus `chase` more); lucky anchors extend the last anchor's
// diagonal by the longest common extension (LCE) of the two suffixes.
//
// The JAX loop runs all lanes in lock-step and counts whole iterations;
// here a lane counts the iterations it ran (a lane that finishes in the
// middle of an iteration still counts it), and the caller takes the
// maximum over lanes — the same number the lock-step loop reports.
//
// What a lane reads, it reads through three windows (WalkWindows):
// * the row window: ROW_WIN consecutive entries of the lane's mlun and ps
//   rows, from a position whose table index is a multiple of 4.  Hops,
//   candidate tests and ps reads look it up and refill it only when the
//   position leaves it.
// * the diagonal window: the mismatch mask of DIAG_WIN symbol pairs
//   (text[dq + k], text[ds + k]).  The LCE of (a, b) on that diagonal is
//   the distance from a to the first mismatch at or after it, so the next
//   lucky checks along one homologous stretch cost no load.  The LCE of a
//   suffix array is the literal common prefix, and in the joint text
//   every separator and padding symbol is unique: a pair mismatches where
//   either position is at or past the text's end, holds a separator (byte
//   0) or the bytes differ.  Only when the window holds no mismatch from a
//   on (the LCE reaches past it) does the lane take ISA + range-min, with
//   the ISA pair loaded together with the window.
// * the staging of accepted anchors: STAGE events at a time, then one
//   reservation of that many consecutive slots on the global counter and
//   one write of the batch in chain order (slots at or past the capacity
//   are dropped, the counter still counts them).
//
// The code is written for THREADS threads that hold the same lane state
// and take the same branches: 32 on the card (a fill is one load per
// thread, a lookup a shuffle, a mask a ballot), 1 in the host twin (a fill
// is a loop into arrays, a lookup an index).  The twin is built at the
// kernel's window sizes and at tiny ones, so the tests cross every window
// and staging boundary many times.

#pragma once

#ifdef __CUDACC__
#define WALK_HD __host__ __device__ __forceinline__
#else
#define WALK_HD inline
#endif

// the kernel's window and staging sizes (the host twin is also built at
// tiny ones)
#define WALK_ROW_WIN 256   // 8 entries a thread
#define WALK_DIAG_WIN 256  // 8 pairs a thread
#define WALK_STAGE 32

#define WALK_INF 2147483647
#define WALK_UNIQ_BIT (1 << 30)
#define WALK_FULL_MASK 0xffffffffu
#define RM_FINE 8
#define RM_GROUP 64

// rmq.RangeMin without the element-span rows: same-fine-block queries
// take the masked 8-way min (any exact range minimum is the same number)
struct RangeMinView {
  const int* values;  // [Np] padded with INF
  const int* pref8;   // [Np]
  const int* suff8;   // [Np]
  const int* t8;      // [7, nf]
  const int* prefg;   // [nf]
  const int* suffg;   // [nf]
  const int* tg;      // [lg, ng]
  int nf, ng, lg;
};

WALK_HD int walk_min(int a, int b) { return a < b ? a : b; }
WALK_HD int walk_max(int a, int b) { return a > b ? a : b; }

// floor(log2(max(x, 1))), exact for every int (rmq._ilog2 uses lax.clz)
WALK_HD int walk_ilog2(int x) {
  unsigned u = x < 1 ? 1u : (unsigned)x;
#ifdef __CUDA_ARCH__
  return 31 - __clz(u);
#else
  return 31 - __builtin_clz(u);
#endif
}

// index of the lowest set bit of x != 0
WALK_HD int walk_ctz(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// min(values[lo..hi]) inclusive; INF when lo > hi (rmq.range_min)
WALK_HD int range_min(const RangeMinView& rm, int lo, int hi) {
  if (lo > hi) return WALK_INF;
  const int f1 = lo / RM_FINE, f2 = hi / RM_FINE;
  if (f1 == f2) {
    int out = rm.values[lo];
    for (int d = 1; d < RM_FINE; ++d)
      out = walk_min(out, rm.values[walk_min(lo + d, hi)]);
    return out;
  }
  const int edge = walk_min(rm.suff8[lo], rm.pref8[hi]);
  const int c1 = f1 + 1, c2 = f2 - 1;
  if (c2 < c1) return edge;
  const int span = c2 - c1 + 1;
  int mid;
  if (span <= RM_GROUP) {
    const int k8 = walk_min(walk_ilog2(span), 6);
    const int w8 = 1 << k8;
    const int* row = rm.t8 + (long long)k8 * rm.nf;
    mid = walk_min(row[c1], row[c2 - w8 + 1]);
  } else {
    const int g1 = c1 / RM_GROUP, g2 = c2 / RM_GROUP;
    mid = walk_min(rm.suffg[c1], rm.prefg[c2]);
    const int h1 = g1 + 1, h2 = g2 - 1;
    if (h2 >= h1) {
      const int kg = walk_min(walk_ilog2(h2 - h1 + 1), rm.lg - 1);
      const int wg = 1 << kg;
      const int* row = rm.tg + (long long)kg * rm.ng;
      mid = walk_min(mid, walk_min(row[h1], row[h2 - wg + 1]));
    }
  }
  return walk_min(edge, mid);
}

struct WalkTables {
  const int* isa;             // [Np]
  const unsigned char* text;  // [n] text bytes, 0 at every separator
  long long n;                // real symbols + separators
  RangeMinView rm;            // over the adjacent-LCP array
  const int* mlun;            // [Sg, qb] match length | UNIQ_BIT
  const int* ps;              // [Sg, qb] subject position
  long long qb;               // row stride of mlun / ps
};

struct WalkLane {
  int row, qoff, qs, ss, rl, thr, seg_end;  // geometry
  int pos, lq, ls, ll;                      // chain state
  bool fin;
};

struct WalkEvents {
  int* lane;
  int* q;
  int* s;
  int* len;
  int* count;  // total found, may exceed cap
  int cap;
};

// LCE of text suffixes a and b by ISA + range-min over the adjacent LCP
// (INF when a == b)
WALK_HD int walk_lce(const WalkTables& t, int a_text, int b_text) {
  const int t1 = t.isa[a_text], t2 = t.isa[b_text];
  return range_min(t.rm, walk_min(t1, t2) + 1, walk_max(t1, t2));
}

// true where the literal common prefix of two suffixes stops (text
// positions are below 2^31, so their sum with a window offset fits).
// Both bytes are loaded whatever the other holds, and no branch waits on
// them, so a window's loads all go out in one round.
WALK_HD bool walk_pair_mismatch(const WalkTables& t, unsigned x,
                                unsigned y) {
  const unsigned n = (unsigned)t.n;
  const bool out = (x >= n) | (y >= n);
  const unsigned char c = t.text[x < n ? x : 0];
  const unsigned char d = t.text[y < n ? y : 0];
  return out | (c == 0) | (c != d);
}

template <int ROW_WIN, int DIAG_WIN, int STAGE, int THREADS>
struct WalkWindows {
  static_assert(THREADS == 1 || THREADS == 32, "a warp or one thread");
  static_assert(ROW_WIN % (4 * THREADS) == 0, "whole 4-entry groups");
  static_assert(DIAG_WIN % THREADS == 0 && DIAG_WIN <= 32 * 32,
                "whole pairs per thread, at most 32 mask words");
  static constexpr int RP = ROW_WIN / THREADS;     // row entries a thread
  static constexpr int DP = DIAG_WIN / THREADS;    // pairs a thread
  static constexpr int DW = (DIAG_WIN + 31) / 32;  // mask words

  const WalkTables& t;
  const int* mrow;  // the lane's mlun row at lane position 0
  const int* prow;  // the lane's ps row at lane position 0
  long long row_off;  // table index of lane position 0
  int row_lim;        // lane positions from here on lie past the row
  int tid;            // this thread's index among THREADS
  int rbase;          // lane position of the row window's first entry
  int m[RP], p[RP];   // this thread's entries: rbase + tid * RP + k
  int dq, ds;         // text positions of the diagonal window's first pair
  unsigned mask[DW];  // bit k of the window: pair k mismatches
  int isa_q, isa_s;   // ISA of dq and ds, loaded with the window
  int* stage;         // [3, STAGE] staged (q, s, len)
  int nst;            // staged events

  WALK_HD WalkWindows(const WalkTables& tables, const WalkLane& w,
                      int* stage_buf, int thread)
      : t(tables) {
    row_off = (long long)w.row * t.qb + w.qoff;
    mrow = t.mlun + row_off;
    prow = t.ps + row_off;
    row_lim = (int)(t.qb - w.qoff);
    tid = thread;
    rbase = -ROW_WIN - 8;  // covers no lane position
    dq = ds = -1;
    for (int k = 0; k < DW; ++k) mask[k] = 0;
    isa_q = isa_s = 0;
    stage = stage_buf;
    nst = 0;
  }

  WALK_HD bool row_covers(int pos) const {
    return pos >= rbase && pos < rbase + ROW_WIN;
  }

  // issues the loads of a row window that holds pos
  WALK_HD void row_fill(int pos) {
    rbase = pos - (int)((row_off + pos) & 3);
    const int first = rbase + tid * RP;
#ifdef __CUDA_ARCH__
    // 16-byte loads: (row_off + first) % 4 == 0, and as qb % 4 == 0 a
    // group of 4 lies wholly inside the row or wholly past it
#pragma unroll
    for (int k = 0; k < RP; k += 4) {
      int4 a = make_int4(0, 0, 0, 0), b = a;
      if (first + k < row_lim) {
        a = __ldg(reinterpret_cast<const int4*>(mrow + first + k));
        b = __ldg(reinterpret_cast<const int4*>(prow + first + k));
      }
      m[k] = a.x; m[k + 1] = a.y; m[k + 2] = a.z; m[k + 3] = a.w;
      p[k] = b.x; p[k + 1] = b.y; p[k + 2] = b.z; p[k + 3] = b.w;
    }
#else
    for (int k = 0; k < RP; ++k) {
      const bool in = first + k < row_lim;
      m[k] = in ? mrow[first + k] : 0;
      p[k] = in ? prow[first + k] : 0;
    }
#endif
  }

  // the window's entry of pos (row_covers(pos) must hold)
  WALK_HD int row_pick(const int* v, int pos) const {
    const int e = pos - rbase;
#ifdef __CUDA_ARCH__
    const int comp = e % RP;
    int x = v[0];
#pragma unroll
    for (int k = 1; k < RP; ++k) x = comp == k ? v[k] : x;
    return __shfl_sync(WALK_FULL_MASK, x, e / RP);
#else
    return v[e];
#endif
  }

  WALK_HD int mlun_at(int pos) {
    if (!row_covers(pos)) row_fill(pos);
    return row_pick(m, pos);
  }

  WALK_HD int ps_at(int pos) {
    if (!row_covers(pos)) row_fill(pos);
    return row_pick(p, pos);
  }

  // one step of the pure pos += matchlen + 1 chain, stopping at anchor
  // candidates (unique and at least the threshold long)
  WALK_HD int hop(int pos, int thr) {
    const int v = mlun_at(pos);
    const int ml = v & (WALK_UNIQ_BIT - 1);
    const bool cand = (v & WALK_UNIQ_BIT) != 0 && ml >= thr;
    return cand ? pos : pos + ml + 1;
  }

  // issues the loads of the diagonal window from (a, b) and the ISA pair
  WALK_HD void diag_fill(int a, int b) {
    dq = a;
    ds = b;
    isa_q = t.isa[a];
    isa_s = t.isa[b];
#ifdef __CUDA_ARCH__
    bool mm[DP];
#pragma unroll
    for (int j = 0; j < DP; ++j)
      mm[j] = walk_pair_mismatch(t, (unsigned)(a + tid + 32 * j),
                                 (unsigned)(b + tid + 32 * j));
#pragma unroll
    for (int j = 0; j < DP; ++j) mask[j] = __ballot_sync(WALK_FULL_MASK,
                                                          mm[j]);
#else
    for (int k = 0; k < DW; ++k) mask[k] = 0;
    for (int j = 0; j < DP; ++j)
      if (walk_pair_mismatch(t, (unsigned)(a + j), (unsigned)(b + j)))
        mask[j >> 5] |= 1u << (j & 31);
#endif
  }

  // offset of the window's first mismatch at or after offset o, or -1
  WALK_HD int diag_first(int o) const {
    int first = -1;
#pragma unroll
    for (int k = DW - 1; k >= 0; --k) {
      const int lo = o - 32 * k;  // bits of word k below offset o
      unsigned bits = mask[k];
      bits = lo <= 0 ? bits : (lo >= 32 ? 0u : bits & (~0u << lo));
      if (bits) first = 32 * k + walk_ctz(bits);
    }
    return first;
  }

  // LCE of text suffixes a and b.  A refill of the diagonal window also
  // issues the row window's loads for the probe position `pos` when the
  // row window misses it (the probe reads the row if its lucky check
  // fails), so every load the check may need comes in one round.
  WALK_HD int lce(int a, int b, int pos) {
    if (a == b) return walk_lce(t, a, b);
    const int o = a - dq;
    if (dq >= 0 && b - a == ds - dq && o >= 0 && o < DIAG_WIN) {
      const int first = diag_first(o);
      if (first >= 0) return first - o;
      if (o == 0) return lce_past_window();
    }
    if (!row_covers(pos)) row_fill(pos);
    diag_fill(a, b);
    const int first = diag_first(0);
    return first >= 0 ? first : lce_past_window();
  }

  // the LCE of the window's first pair when all its pairs match
  WALK_HD int lce_past_window() {
    return range_min(t.rm, walk_min(isa_q, isa_s) + 1,
                     walk_max(isa_q, isa_s));
  }

  // reserves slots for the staged events and writes them in chain order
  WALK_HD void flush(const WalkEvents& ev, int lane) {
    if (nst == 0) return;
    int base = 0;
#ifdef __CUDA_ARCH__
    __syncwarp();
    if (tid == 0) base = atomicAdd(ev.count, nst);
    base = __shfl_sync(WALK_FULL_MASK, base, 0);
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

  WALK_HD void record(int q, int s, int len, const WalkEvents& ev,
                      int lane) {
    if (tid == 0) {
      stage[nst] = q;
      stage[STAGE + nst] = s;
      stage[2 * STAGE + nst] = len;
    }
    if (++nst == STAGE) flush(ev, lane);
  }
};

// One probe step of a lane that has not finished, shared by the flat walk
// and the count-in-loop replay (replay_lane.cuh).  While the gap to the
// last anchor exceeds the threshold no lucky anchor can fire, so the pure
// chain is hopped (one hop plus `chase` more, stopping at `stop`).  Where
// the position lies before `stop` it is probed: the lucky check along the
// last anchor's diagonal, else the table entry.  At or past `stop`,
// pos_qj is the true chain's next probe position and nothing was probed.
struct WalkProbe {
  int pos_qj;        // the probed position
  bool found;        // an anchor starts there
  int this_s;        // its subject position (lucky, or the table's)
  int this_len;      // the probe's match length (an anchor's if found)
};

template <class Windows>
WALK_HD WalkProbe walk_probe(Windows& win, const WalkLane& w, int stop,
                             int chase) {
  WalkProbe p{w.pos, false, 0, 0};
  if (w.pos - w.lq - w.ll > w.thr) {
    p.pos_qj = win.hop(w.pos, w.thr);
    for (int c = 0; c < chase; ++c) {
      if (p.pos_qj >= stop) break;
      p.pos_qj = win.hop(p.pos_qj, w.thr);
    }
  }
  if (p.pos_qj >= stop) return p;
  const int advance = p.pos_qj - w.lq;
  const int gap = advance - w.ll;
  const int try_s = w.ls + advance;
  if (try_s < w.rl && gap >= 0 && gap <= w.thr) {
    p.this_len = win.lce(w.qs + p.pos_qj, w.ss + try_s, p.pos_qj);
    p.found = p.this_len >= w.thr;
    p.this_s = try_s;
  }
  if (!p.found) {
    const int v = win.mlun_at(p.pos_qj);
    p.this_len = v & (WALK_UNIQ_BIT - 1);
    p.found = (v & WALK_UNIQ_BIT) != 0 && p.this_len >= w.thr;
    p.this_s = win.ps_at(p.pos_qj);
  }
  return p;
}

// Walks lane `lane` from its entry state; returns the loop iterations it
// ran.  Every thread of the lane calls it with the same arguments but its
// own `tid`; `stage` is the lane's [3, STAGE] staging buffer (shared by
// its threads).  Events are recorded in chain order.
template <int ROW_WIN, int DIAG_WIN, int STAGE, int THREADS>
WALK_HD int walk_lane(const WalkTables& t, int lane, WalkLane& w,
                      int max_iters, int max_events, int chase, int unroll,
                      const WalkEvents& ev, int* stage, int tid) {
  WalkWindows<ROW_WIN, DIAG_WIN, STAGE, THREADS> win(t, w, stage, tid);
  int evn = 0;
  int it = 0;
  w.fin = (w.pos >= w.seg_end) || (0 >= max_events);
  while (!w.fin && it < max_iters) {
    for (int u = 0; u < unroll && !w.fin; ++u) {
      const WalkProbe p = walk_probe(win, w, w.seg_end, chase);
      if (p.pos_qj >= w.seg_end) {
        // out of range: freeze at pos_qj exactly (the true chain's next
        // probe position, the next segment's entry)
        w.pos = p.pos_qj;
      } else {
        if (p.found) {
          w.lq = p.pos_qj;
          w.ls = p.this_s;
          w.ll = p.this_len;
          ++evn;
          win.record(p.pos_qj, p.this_s, p.this_len, ev, lane);
        }
        w.pos = p.pos_qj + p.this_len + 1;
      }
      w.fin = (w.pos >= w.seg_end) || (evn >= max_events);
    }
    ++it;
  }
  win.flush(ev, lane);
  return it;
}
