// The bootstrap resampler's body, shared by the CUDA kernel (bootstrap.cu,
// a warp a pair's 32 rounds) and its host twin (bootstrap_cpu.cpp, built
// with g++ for the tests, one caller at the same mapping).
//
// One (round, pair) draws its 16 cells as conditional binomials: cell c
// takes Binomial(n, counts[c] / mass), with n the total not yet drawn and
// mass the source counts of cells c.. (cell 15 takes what is left), which
// is a multinomial draw of the pair's total over its cells: the total is
// kept exactly, an all-zero pair stays all zero.  Counts are int64 and
// below 2^53, so float64 carries them exactly.
//
// Random words: Philox4x32-10, written here, keyed (seed & 0xFFFFFFFF, 0),
// with the counter (round, pair, cell, attempt).  A binomial of mean n p
// (p <= 1/2 after the flip to 1 - p) below BOOT_INV_MEAN takes inversion
// (one uniform an attempt, a restart past its bound); above, BTRS
// (Hoermann 1993, as torch.binomial draws; two uniforms an attempt).  A
// uniform is the 53 high bits of two words.  Every float64 operation is
// written out in one order and must not be contracted (nvcc -fmad=false,
// g++ -ffp-contract=off): the plain torch version (bootstrap.py) repeats
// the same operations and draws the same numbers.

#pragma once

#ifdef __CUDACC__
#define BOOT_HD __host__ __device__ __forceinline__
#else
#define BOOT_HD inline
#endif

#include <math.h>

#define BOOT_CELLS 16
#define BOOT_INV_MEAN 10.0

struct BootTally {
  long long inv_attempts, inv_steps, btrs_attempts;
};

BOOT_HD void boot_mulhilo(unsigned a, unsigned b, unsigned* hi,
                          unsigned* lo) {
  const unsigned long long p = (unsigned long long)a * b;
  *hi = (unsigned)(p >> 32);
  *lo = (unsigned)p;
}

// Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1)
BOOT_HD void boot_philox(unsigned c0, unsigned c1, unsigned c2, unsigned c3,
                         unsigned k0, unsigned k1, unsigned out[4]) {
  unsigned x0 = c0, x1 = c1, x2 = c2, x3 = c3;
  for (int r = 0; r < 10; ++r) {
    unsigned hi0, lo0, hi1, lo1;
    boot_mulhilo(0xD2511F53u, x0, &hi0, &lo0);
    boot_mulhilo(0xCD9E8D57u, x2, &hi1, &lo1);
    const unsigned y0 = hi1 ^ x1 ^ k0, y2 = hi0 ^ x3 ^ k1;
    x0 = y0;
    x1 = lo1;
    x2 = y2;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = x0;
  out[1] = x1;
  out[2] = x2;
  out[3] = x3;
}

// a uniform in [0, 1) from the 53 high bits of (hi, lo)
BOOT_HD double boot_u53(unsigned hi, unsigned lo) {
  const unsigned long long x =
      ((unsigned long long)hi << 21) | (unsigned long long)(lo >> 11);
  return (double)x * (1.0 / 9007199254740992.0);
}

// below 10 from the table, picked by selects (an indexed table would sit
// in the kernel's local memory)
BOOT_HD double boot_stirling_tail(double k) {
  if (k <= 9) {
    const int i = (int)k;
    return i == 0   ? 0.0810614667953272
           : i == 1 ? 0.0413406959554092
           : i == 2 ? 0.0276779256849983
           : i == 3 ? 0.02079067210376509
           : i == 4 ? 0.0166446911898211
           : i == 5 ? 0.0138761288230707
           : i == 6 ? 0.0118967099458917
           : i == 7 ? 0.0104112652619720
           : i == 8 ? 0.00925546218271273
                    : 0.00833056343336287;
  }
  const double kp1sq = (k + 1) * (k + 1);
  return (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1);
}

struct BootStream {
  unsigned k0, r, pair, cell, attempt;
};

// Binomial(n, p), 0 < p <= 1/2, n >= 1
BOOT_HD long long boot_binomial_half(long long n, double p, BootStream* st,
                                     BootTally* tally) {
  const double nd = (double)n;
  unsigned w[4];
  if (nd * p < BOOT_INV_MEAN) {
    const double q = 1 - p;
    const double qn = exp(nd * log1p(-p));
    const double np = nd * p;
    const double bound = fmin(nd, np + 10 * sqrt(np * q + 1));
    for (;;) {
      boot_philox(st->r, st->pair, st->cell, st->attempt++, st->k0, 0, w);
      if (tally) ++tally->inv_attempts;
      double u = boot_u53(w[0], w[1]);
      double px = qn;
      long long x = 0;
      bool restart = false;
      while (u > px) {
        ++x;
        if (tally) ++tally->inv_steps;
        if ((double)x > bound) {
          restart = true;
          break;
        }
        u = u - px;
        px = (double)(n - x + 1) * p * px / ((double)x * q);
      }
      if (!restart) return x;
    }
  }
  const double stddev = sqrt(nd * p * (1 - p));
  const double b = 1.15 + 2.53 * stddev;
  const double a = -0.0873 + 0.0248 * b + 0.01 * p;
  const double c = nd * p + 0.5;
  const double v_r = 0.92 - 4.2 / b;
  const double r = p / (1 - p);
  const double alpha = (2.83 + 5.1 / b) * stddev;
  const double m = floor((nd + 1) * p);
  for (;;) {
    boot_philox(st->r, st->pair, st->cell, st->attempt++, st->k0, 0, w);
    if (tally) ++tally->btrs_attempts;
    const double U = boot_u53(w[0], w[1]) - 0.5;
    double V = boot_u53(w[2], w[3]);
    const double us = 0.5 - fabs(U);
    const double k = floor((2 * a / us + b) * U + c);
    if (k < 0 || k > nd) continue;
    if (us >= 0.07 && V <= v_r) return (long long)k;
    V = log(V * alpha / (a / (us * us) + b));
    const double upper =
        (m + 0.5) * log((m + 1) / (r * (nd - m + 1))) +
        (nd + 1) * log((nd - m + 1) / (nd - k + 1)) +
        (k + 0.5) * log(r * (nd - k + 1) / (k + 1)) +
        boot_stirling_tail(m) + boot_stirling_tail(nd - m) -
        boot_stirling_tail(k) - boot_stirling_tail(nd - k);
    if (V <= upper) return (long long)k;
  }
}

// The warp mapping, kernel and twin alike: a warp takes one pair's rounds
// 32 at a time, lane r drawing round chunk * 32 + r; the tail lanes of a
// rounds count that is not a multiple of 32 draw nothing.
#define BOOT_WARP 32

BOOT_HD unsigned boot_round(long long chunk, int lane) {
  return (unsigned)(chunk * BOOT_WARP + lane);
}

// What every round of a pair shares, cell by cell: its count cc, its mass
// (the counts of cells c..15, the total at cell 0) and p = cc / mass (0
// where cc is 0).  The kernel's lanes 0-15 compute a cell each, the twin
// one after another; the mass is an integer sum and p one division of the
// same operands, so both give the same bits.
BOOT_HD double boot_cell_p(long long cc, long long mass) {
  return cc > 0 ? (double)cc / (double)mass : 0.0;
}

// One round of one pair from its cells' cc, mass and p: the 16 cells into
// out[0..15].  The lanes of a warp start every cell with the same cc,
// mass and p, and at cell 0 with the same n (the total), so they take the
// same branch there; they part only where their draws differ.
BOOT_HD void boot_draw_round(const long long* cc, const long long* mass,
                             const double* p, unsigned k0, unsigned round,
                             unsigned pair, long long* out,
                             BootTally* tally) {
  long long n = mass[0];
  BootStream st{k0, round, pair, 0, 0};
  for (int c = 0; c < BOOT_CELLS - 1; ++c) {
    long long x = 0;
    if (n > 0 && cc[c] > 0) {
      if (cc[c] == mass[c]) {
        x = n;
      } else {
        st.cell = (unsigned)c;
        st.attempt = 0;
        x = p[c] > 0.5 ? n - boot_binomial_half(n, 1 - p[c], &st, tally)
                       : boot_binomial_half(n, p[c], &st, tally);
      }
    }
    out[c] = x;
    n -= x;
  }
  out[BOOT_CELLS - 1] = n;
}
