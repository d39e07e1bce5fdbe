// Host twin of bootstrap.cu: the same body (bootstrap_lane.cuh) at the
// kernel's mapping, a warp's 32 rounds of one pair after another, built
// with g++ -ffp-contract=off, so the kernel's draws are tested on machines
// without a card.  The C interface is the kernel's entry's, with the
// sampler's work tallied (inversion attempts and steps, BTRS attempts) in
// place of the stream.

#include "bootstrap_lane.cuh"

extern "C" int andix_bootstrap_resample_cpu(const long long* counts,
                                            int pairs, int rounds,
                                            unsigned key, long long* out,
                                            long long* tally) {
  BootTally t{0, 0, 0};
  const long long chunks = (rounds + BOOT_WARP - 1) / BOOT_WARP;
  for (long long w = 0; w < chunks * pairs; ++w) {
    const int pair = (int)(w % pairs);
    const long long chunk = w / pairs;
    const long long* src = counts + (long long)pair * BOOT_CELLS;
    long long cc[BOOT_CELLS], mass[BOOT_CELLS];
    double p[BOOT_CELLS];
    long long suffix = 0;
    for (int c = BOOT_CELLS - 1; c >= 0; --c) {
      cc[c] = src[c];
      mass[c] = suffix += src[c];
      p[c] = boot_cell_p(cc[c], mass[c]);
    }
    for (int lane = 0; lane < BOOT_WARP; ++lane) {
      const unsigned round = boot_round(chunk, lane);
      if (round < (unsigned)rounds)
        boot_draw_round(cc, mass, p, key, round, (unsigned)pair,
                        out + ((long long)round * pairs + pair) * BOOT_CELLS,
                        &t);
    }
  }
  tally[0] = t.inv_attempts;
  tally[1] = t.inv_steps;
  tally[2] = t.btrs_attempts;
  return 0;
}
