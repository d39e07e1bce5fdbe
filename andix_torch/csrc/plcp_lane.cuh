// Per-entry bodies of the sampled-PLCP adjacent LCP, shared by the CUDA
// kernels (plcp.cu, one thread an entry or a run of samples) and their
// host twin (plcp_cpu.cpp, built with g++ for the tests, entry after
// entry).
//
// Semantics are those of andix/esa/plcp.py:plcp_lcp_hybrid_traced (with
// _ladder and _fill_from_samples), entry by entry:
//   * the packed text holds the 4-bit classes of sym (A C G T ! # ; ->
//     1..7; separators, padding and positions past the end -> 0), 16 a
//     64-bit word, big-endian, word k for positions 16 k .. 16 k + 15, and
//     two words of zeros past the end.  plcp_read(p) joins the two words
//     around p into the 16 codes of positions p .. p + 15: andix's w16[p];
//   * a sample j (position i = 16 j, partner a = phi(i)) walks the level
//     rows top-down from h = 0, then probes words from that h;
//   * the entry of SA slot t (position i = SA[t], partner SA[t - 1])
//     starts at the Kasai bound lo = max(S[i >> 4] - (i & 15), 0), probes
//     one word at (a + lo, i + lo) (both cut to N - 1), and a survivor (16
//     symbols agree) probes on from h = 16; lcp[t] = its PLCP, lcp[0] = 0.
// A probe reads the words at (a + h, b + h), each cut to N - 1, and
// advances to the first differing or both-special nibble (done), or by 16.
//
// The probe cap.  andix runs its probes in lock-step over compacted
// buffers: one global pass counter, the level walk over the still-open
// entries at pass LADDER_PRE (64), and at most PASS_CAP (64 + 4096 / 16 +
// 8 = 328) passes.  An entry takes part in every pass until it is done,
// so an entry's fate depends on itself alone: it is done at its k-th
// probe if k <= PASS_CAP, the walk coming before probe 64.  plcp_sample
// and plcp_fill run exactly that: PLCP_PASS_CAP probes, the walk before
// probe PLCP_LADDER_PRE.  An entry still open after them counts in the
// open counters (counters[0] samples, counters[1] survivors); the wrapper
// raises the overflow flag for any open entry, as andix does.  andix also
// flags more fill survivors than its buffer of max(N / 2, 8192) holds;
// every survivor here has its own thread, so there is no such buffer and
// no such flag.  An open sample keeps S = 0 and an open survivor the
// Kasai bound, what andix's output buffers hold for them.
//
// Sample runs (plcp_run, then plcp_settle).  A run of consecutive
// samples j0 .. j1 - 1 goes to one thread.  Each but the first starts
// from the Kasai bound PLCP[16 j] >= PLCP[16 (j - 1)] - 16 and probes up
// to `tries` words from there.  A PLCP P found so is exact, and is taken
// as andix's outcome when P < base << lev_cnt: the rows below lev_cnt are
// the doubling ranks of widths base << r, equal prefixes of a width have
// equal ranks and the converse, so andix's top-down walk over them
// leaves P - h = P mod base < base <= 16 symbols for such a P, and its
// first probe ends the entry with the same P.  A sample whose bound is
// too low (and the run's first) takes andix's walk and its first `tries`
// probes (all before probe PLCP_LADDER_PRE), whose outcome is andix's
// when one ends the entry.  Every other sample is deferred to a second
// pass, a thread a sample, that runs plcp_sample, andix's schedule; the
// run goes on from the exact P, or from the lower bound the probes
// reached, and walks no more until it knows a PLCP again.  So the long
// capped schedules of a text with rows missing run in parallel, and the
// open entries, the counters and the flag stay andix's.  With every row
// the text needs, every PLCP is below base << lev_cnt (the next width's
// ranks are tie-free) and the walk ends every entry at its first probe,
// so a run walks once and defers nothing.  When the top row was
// overwritten by later rounds (lev_cnt > L, an overflow of the SA loop)
// its ranks are of a wider width, so the wrapper gives every run one
// sample: each walks, as in andix.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PLCP_HD __host__ __device__ __forceinline__
#else
#define PLCP_HD inline
#endif

#define PLCP_LADDER_PRE 64
#define PLCP_PASS_CAP (PLCP_LADDER_PRE + 4096 / 16 + 8)

#define PLCP_TEXT_PAD 2  // words of zeros past the packed text

struct PlcpView {
  const uint64_t* text;         // [n / 16 + PLCP_TEXT_PAD] packed codes
  const int32_t* const* rows;   // L rank rows of [n], row r of width base << r
  int64_t n;
  int L;
  int lev_cnt;  // rows written (> L after an overflow)
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

// one packed word: the codes of s[0..15], big-endian
PLCP_HD uint64_t plcp_pack16(const int32_t* s) {
  uint64_t w = 0;
  for (int j = 0; j < 16; ++j) w = (w << 4) | plcp_code(s[j]);
  return w;
}

// a packed word through the read-only path: the text is read by every
// probe and stays in L2, so nothing streamed should evict it
PLCP_HD uint64_t plcp_load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__ldg((const unsigned long long*)p);
#else
  return *p;
#endif
}

// the codes of positions p .. p + 15 (0 past the end), 0 <= p < n: the
// aligned words around p joined by a funnel shift.  On the card it is two
// 32-bit funnel shifts of three of their four halves (one instruction
// each), where 64-bit shifts by a variable count take several; on the
// host, for p & 15 == 0 the second word's share shifts out whole
PLCP_HD int64_t plcp_read(const PlcpView& v, int64_t p) {
  const uint64_t* w = v.text + (p >> 4);
  const int s = (int)(p & 15) << 2;
  const uint64_t hi = plcp_load(w), lo = plcp_load(w + 1);
#ifdef __CUDA_ARCH__
  const bool high = s & 32;  // drop the top half, then shift by s - 32
  const unsigned x = high ? (unsigned)hi : (unsigned)(hi >> 32);
  const unsigned y = high ? (unsigned)(lo >> 32) : (unsigned)hi;
  const unsigned z = high ? (unsigned)lo : (unsigned)(lo >> 32);
  return (int64_t)(((uint64_t)__funnelshift_l(y, x, s) << 32) |
                   __funnelshift_l(z, y, s));
#else
  return (int64_t)((hi << s) | ((lo >> 1) >> (63 - s)));
#endif
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

// one probe at (a + h, b + h), each cut to N - 1
PLCP_HD int plcp_probe(const PlcpView& v, int64_t a, int64_t b, int h) {
  const int64_t last = v.n - 1;
  const int64_t ia = a + h < last ? a + h : last;
  const int64_t ib = b + h < last ? b + h : last;
  return plcp_word_m(plcp_read(v, ia), plcp_read(v, ib));
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
  for (int p = 0; p < PLCP_PASS_CAP; ++p) {
    if (p == PLCP_LADDER_PRE) h = plcp_walk(v, a, b, h);
    const int m = plcp_probe(v, a, b, h);
    if (m < 16) {
      *out = h + m;
      return true;
    }
    h += 16;
  }
  return false;
}

// sample j's PLCP from its partner phi(16 j) (-1: none), andix's schedule;
// *open when the probes ran out
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

// up to `tries` probes from *h; true and *out = *h + m when one ends the
// entry, else *h advanced past the symbols that agreed (a lower bound)
PLCP_HD bool plcp_probes(const PlcpView& v, int64_t a, int64_t b, int* h,
                         int tries, int* out) {
  for (int p = 0; p < tries; ++p) {
    const int m = plcp_probe(v, a, b, *h);
    if (m < 16) {
      *out = *h + m;
      return true;
    }
    *h += 16;
  }
  return false;
}

// the first pass over samples j0 .. j1 - 1 of one run: S[j] = andix's
// outcome where the run settles it, PLCP_DEFER where plcp_sample must;
// `tries` <= PLCP_LADDER_PRE
#define PLCP_DEFER (-1)
PLCP_HD void plcp_run(const PlcpView& v, const int32_t* sphi, int64_t j0,
                      int64_t j1, int tries, int32_t* S) {
  const int64_t accept =
      v.lev_cnt >= 31 ? INT64_MAX : (int64_t)v.base << v.lev_cnt;
  int prev = 0;        // PLCP of the sample before, or a lower bound
  bool known = false;  // prev is that PLCP
  for (int64_t j = j0; j < j1; ++j) {
    const int32_t phi = sphi[j];
    if (phi < 0) {
      S[j] = 0;
      prev = 0;
      known = true;
      continue;
    }
    int lo = prev > 16 ? prev - 16 : 0, s;
    if (j > j0 && plcp_probes(v, phi, 16 * j, &lo, tries, &s)) {
      S[j] = s < accept ? s : PLCP_DEFER;
      prev = s;
      known = true;
      continue;
    }
    if (j == j0 || known) {  // andix's walk and its first probes
      int h = plcp_walk(v, phi, 16 * j, 0);
      if (plcp_probes(v, phi, 16 * j, &h, tries, &s)) {
        S[j] = s;
        prev = s;
        known = true;
        continue;
      }
      lo = h > lo ? h : lo;
    }
    S[j] = PLCP_DEFER;
    prev = lo;
    known = false;
  }
}

// the second pass: a deferred sample j takes andix's schedule; true when
// it was deferred, *open when its probes ran out
PLCP_HD bool plcp_settle(const PlcpView& v, const int32_t* sphi, int64_t j,
                         int32_t* S, bool* open) {
  *open = false;
  if (S[j] != PLCP_DEFER) return false;
  S[j] = plcp_sample(v, sphi[j], j, open);
  return true;
}

// lcp[t] from the samples, position i = SA[t] and partner a = SA[t - 1]
// (t > 0); a survivor (the first probe agreed on all 16 symbols) probes
// on, *open when its probes ran out
PLCP_HD int plcp_fill(const PlcpView& v, int64_t i, int64_t a,
                      const int32_t* S, bool* open) {
  *open = false;
  int lo = S[i >> 4] - (int)(i & 15);
  lo = lo > 0 ? lo : 0;
  const int64_t last = v.n - 1;
  const int64_t af = a + lo < last ? a + lo : last;
  const int64_t bf = i + lo < last ? i + lo : last;
  const int m1 = plcp_word_m(plcp_read(v, af), plcp_read(v, bf));
  if (m1 < 16) return m1 + lo;
  int out = 0;
  if (!plcp_ladder(v, af, bf, 16, &out)) {
    *open = true;
    return lo;
  }
  return out + lo;
}
