// Tile bodies of the range-min build, shared by the CUDA kernels (rmq.cu,
// a block of threads a tile) and their host twin (rmq_cpu.cpp, built with
// g++ for the tests, one "thread" that takes every index of a tile).
//
// Semantics are those of andix/esa/rmq.py:build (the arrays the walk
// reads; see esa/rmq.py), over values padded with INF to Np, a multiple
// of 512:
//   * pref8[t], suff8[t]: min over [fine start .. t], [t .. fine end] of
//     t's fine block of 8 (rmq_fine_block);
//   * t8[k][c] = min of the fine mins c .. c + 2^k - 1 (INF past nf), k =
//     0..6: row 0 in the fine pass, rows 1..6 by doubling over a tile of
//     fine mins and the 63 after it (rmq_t8_tile);
//   * prefg[c], suffg[c]: min over the fine mins of c's group of 64 up to
//     c, from c (rmq_group_scan), and the group's min into tg[0];
//   * tg[k][g] = min(tg[k - 1][g], tg[k - 1][g + 2^(k - 1)]), INF past ng.
//
// A tile function runs its index loops as `for (x = tid; x < n; x +=
// nth)` with RMQ_SYNC() between steps that read what another index
// wrote: on the card every thread of the block calls it (a barrier), in
// the twin one caller with tid 0, nth 1 (no barrier needed).  Each step
// reads one buffer and writes the other, so one barrier a step suffices.

#pragma once

#ifdef __CUDACC__
#define RMQ_HD __host__ __device__ __forceinline__
#else
#define RMQ_HD inline
#endif

#ifdef __CUDA_ARCH__
#define RMQ_SYNC() __syncthreads()
#else
#define RMQ_SYNC()
#endif

#define RMQ_INF 2147483647
#define RMQ_FINE 8
#define RMQ_GROUP 64
#define RMQ_T8_ROWS 7

RMQ_HD int rmq_min(int a, int b) { return a < b ? a : b; }

// one fine block: v, pref8 and suff8 point at its 8 elements (16-byte
// aligned on the card: two 16-byte loads and four 16-byte stores);
// returns its min
RMQ_HD int rmq_fine_block(const int* v, int* pref8, int* suff8) {
  int e[RMQ_FINE];
#ifdef __CUDA_ARCH__
  const int4 lo = __ldg(reinterpret_cast<const int4*>(v));
  const int4 hi = __ldg(reinterpret_cast<const int4*>(v) + 1);
  e[0] = lo.x; e[1] = lo.y; e[2] = lo.z; e[3] = lo.w;
  e[4] = hi.x; e[5] = hi.y; e[6] = hi.z; e[7] = hi.w;
#else
  for (int d = 0; d < RMQ_FINE; ++d) e[d] = v[d];
#endif
  int p[RMQ_FINE], s[RMQ_FINE];
  p[0] = e[0];
  for (int d = 1; d < RMQ_FINE; ++d) p[d] = rmq_min(p[d - 1], e[d]);
  s[RMQ_FINE - 1] = e[RMQ_FINE - 1];
  for (int d = RMQ_FINE - 2; d >= 0; --d) s[d] = rmq_min(s[d + 1], e[d]);
#ifdef __CUDA_ARCH__
  int4* po = reinterpret_cast<int4*>(pref8);
  int4* so = reinterpret_cast<int4*>(suff8);
  __stcs(po, make_int4(p[0], p[1], p[2], p[3]));
  __stcs(po + 1, make_int4(p[4], p[5], p[6], p[7]));
  __stcs(so, make_int4(s[0], s[1], s[2], s[3]));
  __stcs(so + 1, make_int4(s[4], s[5], s[6], s[7]));
#else
  for (int d = 0; d < RMQ_FINE; ++d) {
    pref8[d] = p[d];
    suff8[d] = s[d];
  }
#endif
  return p[RMQ_FINE - 1];
}

// inclusive prefix mins (suffix mins when `suffix`) within each group of
// RMQ_GROUP of a[0 .. nx), nx a multiple of RMQ_GROUP, in log steps;
// b is scratch of nx; the result ends in a (an even number of steps)
RMQ_HD void rmq_group_scan(int* a, int* b, int nx, bool suffix, int tid,
                           int nth) {
  for (int w = 1; w < RMQ_GROUP; w <<= 1) {
    for (int x = tid; x < nx; x += nth) {
      const int c = x & (RMQ_GROUP - 1);
      int m = a[x];
      if (!suffix && c >= w) m = rmq_min(m, a[x - w]);
      if (suffix && c + w < RMQ_GROUP) m = rmq_min(m, a[x + w]);
      b[x] = m;
    }
    RMQ_SYNC();
    int* t = a;
    a = b;
    b = t;
  }
}

// rows 1..6 of t8 for the fine blocks c0 .. c0 + nt - 1: a holds the fine
// mins c0 .. c0 + nt + 63 (INF past nf), b is scratch of the same size;
// step k doubles the windows of step k - 1, and a window of 2^k from an
// index below nt stays inside the nt + 64 loaded
RMQ_HD void rmq_t8_tile(int* a, int* b, int nt, int c0, int nf, int* t8,
                        int tid, int nth) {
  const int nx = nt + RMQ_GROUP;
  for (int k = 1; k < RMQ_T8_ROWS; ++k) {
    const int w = 1 << (k - 1);
    for (int x = tid; x < nx; x += nth)
      b[x] = rmq_min(a[x], x + w < nx ? a[x + w] : RMQ_INF);
    RMQ_SYNC();
    for (int x = tid; x < nt; x += nth)
      t8[(long long)k * nf + c0 + x] = b[x];
    int* t = a;
    a = b;
    b = t;
  }
}

// tg[k][g] from row k - 1 (prev) at span 2^(k - 1)
RMQ_HD int rmq_tg_entry(const int* prev, int ng, int span, int g) {
  return rmq_min(prev[g], g + span < ng ? prev[g + span] : RMQ_INF);
}
