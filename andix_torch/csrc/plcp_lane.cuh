// Per-entry bodies of the sampled-PLCP adjacent LCP, shared by the CUDA
// kernels (plcp.cu, one thread an entry) and their host twin
// (plcp_cpu.cpp, built with g++ for the tests, entry after entry).
//
// Semantics are those of andix/esa/plcp.py:plcp_lcp_hybrid_traced (with
// _ladder and _fill_from_samples), entry by entry:
//   * w16[i] packs the 4-bit classes of sym[i..i+15] big-endian (A C G T
//     ! # ; -> 1..7; separators, padding and positions past the end -> 0);
//   * a sample j (position i = 16 j, partner a = phi(i)) walks the level
//     rows top-down from h = 0, then probes words from that h;
//   * the entry of SA slot t (position i = SA[t], partner SA[t - 1])
//     starts at the Kasai bound lo = max(S[i >> 4] - (i & 15), 0), probes
//     one word at (a + lo, i + lo) (both cut to N - 1), and a survivor (16
//     symbols agree) probes on from h = 16; lcp[t] = its PLCP, lcp[0] = 0.
// A probe reads w16 at (a + h, b + h), each cut to N - 1, and advances to
// the first differing or both-special nibble (done), or by 16.
//
// The probe cap.  andix runs its probes in lock-step over compacted
// buffers: one global pass counter, the level walk over the still-open
// entries at pass LADDER_PRE (64), and at most PASS_CAP (64 + 4096 / 16 +
// 8 = 328) passes.  An entry takes part in every pass until it is done,
// so an entry's fate depends on itself alone: it is done at its k-th
// probe if k <= PASS_CAP, the walk coming before probe 64.  Each thread
// here runs exactly that: PLCP_PASS_CAP probes, the walk before probe
// PLCP_LADDER_PRE.  An entry still open after them counts in the open
// counters (counters[0] samples, counters[1] survivors); the wrapper
// raises the overflow flag for any open entry, as andix does.  With every
// level row written the walk leaves less than base (<= 12) symbols, so
// the first probe after it ends the entry and the cap never bites; it
// bites where rows are missing.  andix also flags more fill survivors
// than its buffer of max(N / 2, 8192) holds; every survivor here has its
// own thread, so there is no such buffer and no such flag.  An open
// sample keeps S = 0 and an open survivor the Kasai bound, what andix's
// output buffers hold for them.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PLCP_HD __host__ __device__ __forceinline__
#else
#define PLCP_HD inline
#endif

#define PLCP_LADDER_PRE 64
#define PLCP_PASS_CAP (PLCP_LADDER_PRE + 4096 / 16 + 8)

struct PlcpView {
  const int64_t* w16;           // [n]
  const int32_t* const* rows;   // L rank rows of [n], row r of width base << r
  int64_t n;
  int L;
  int lev_cnt;  // rows written (>= L after an overflow)
  int base;
};

PLCP_HD int plcp_clz64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

PLCP_HD uint64_t plcp_code(int32_t s) {
  switch (s) {
    case 65: return 1;  // A
    case 67: return 2;  // C
    case 71: return 3;  // G
    case 84: return 4;  // T
    case 33: return 5;  // !
    case 35: return 6;  // #
    case 59: return 7;  // ;
    default: return 0;  // separator, padding
  }
}

// w16[i]: the codes of sym[i..i+15], big-endian, 0 past the end
PLCP_HD int64_t plcp_word(const int32_t* sym, int64_t n, int64_t i) {
  uint64_t w = 0;
  for (int j = 0; j < 16; ++j)
    w = (w << 4) | (i + j < n ? plcp_code(sym[i + j]) : 0);
  return (int64_t)w;
}

// symbols of agreement of two words: the first differing nibble or the
// first both-special one; 16 when all agree with no mutual special
PLCP_HD int plcp_word_m(int64_t wa, int64_t wb) {
  const uint64_t m7 = 0x7777777777777777ull;
  const int d = plcp_clz64((uint64_t)(wa ^ wb)) >> 2;
  const uint64_t z = (uint64_t)(wa | wb);
  const uint64_t zn = ~(((z & m7) + m7) | z) & ~m7;  // bit 3 of zero nibbles
  const int zq = plcp_clz64(zn) >> 2;
  return d < zq ? d : zq;
}

// top-down walk over the written level rows: equal ranks at (a + h, b + h)
// advance h by the row's width
PLCP_HD int plcp_walk(const PlcpView& v, int64_t a, int64_t b, int h) {
  for (int r = v.L - 1; r >= 0; --r) {
    if (r >= v.lev_cnt) continue;
    const int64_t ia = a + h, ib = b + h;
    if (ia >= v.n || ib >= v.n) continue;
    const int32_t* row = v.rows[r];
    if (row[ia] == row[ib]) {
      const int64_t w = (int64_t)v.base << r;
      h += (int)(w < (1 << 30) ? w : (1 << 30));
    }
  }
  return h;
}

// word probes from h, the level walk before probe PLCP_LADDER_PRE; true
// and *out = h + m when done within PLCP_PASS_CAP probes
PLCP_HD bool plcp_ladder(const PlcpView& v, int64_t a, int64_t b, int h,
                         int* out) {
  const int64_t last = v.n - 1;
  for (int p = 0; p < PLCP_PASS_CAP; ++p) {
    if (p == PLCP_LADDER_PRE) h = plcp_walk(v, a, b, h);
    const int64_t ia = a + h < last ? a + h : last;
    const int64_t ib = b + h < last ? b + h : last;
    const int m = plcp_word_m(v.w16[ia], v.w16[ib]);
    if (m < 16) {
      *out = h + m;
      return true;
    }
    h += 16;
  }
  return false;
}

// sample j's PLCP from its partner phi(16 j) (-1: none); *open when the
// probes ran out
PLCP_HD int plcp_sample(const PlcpView& v, int32_t phi, int64_t j,
                        bool* open) {
  *open = false;
  if (phi < 0) return 0;
  const int h = plcp_walk(v, phi, 16 * j, 0);
  int out = 0;
  if (!plcp_ladder(v, phi, 16 * j, h, &out)) {
    *open = true;
    return 0;
  }
  return out;
}

// lcp[t] from the samples; a survivor (the first probe agreed on all 16
// symbols) probes on, *open when its probes ran out
PLCP_HD int plcp_fill(const PlcpView& v, const int32_t* sa,
                      const int32_t* S, int64_t t, bool* open) {
  *open = false;
  if (t == 0) return 0;
  const int64_t i = sa[t];
  const int64_t a = sa[t - 1];
  int lo = S[i >> 4] - (int)(i & 15);
  lo = lo > 0 ? lo : 0;
  const int64_t last = v.n - 1;
  const int64_t af = a + lo < last ? a + lo : last;
  const int64_t bf = i + lo < last ? i + lo : last;
  const int m1 = plcp_word_m(v.w16[af], v.w16[bf]);
  if (m1 < 16) return m1 + lo;
  int out = 0;
  if (!plcp_ladder(v, af, bf, 16, &out)) {
    *open = true;
    return lo;
  }
  return out + lo;
}
