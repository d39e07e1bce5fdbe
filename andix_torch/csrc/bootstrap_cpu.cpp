// Host twin of bootstrap.cu: the same (round, pair) body
// (bootstrap_lane.cuh) over every (round, pair) in the kernel's thread
// order, built with g++ -ffp-contract=off, so the kernel's draws are
// tested on machines without a card.  The C interface is the kernel's
// entry's, with the sampler's work tallied (inversion attempts and steps,
// BTRS attempts) in place of the stream.

#include "bootstrap_lane.cuh"

extern "C" int andix_bootstrap_resample_cpu(const long long* counts,
                                            int pairs, int rounds,
                                            unsigned key, long long* out,
                                            long long* tally) {
  BootTally t{0, 0, 0};
  for (long long i = 0; i < (long long)pairs * rounds; ++i)
    boot_resample(counts + (i % pairs) * BOOT_CELLS, out + i * BOOT_CELLS,
                  key, (unsigned)(i / pairs), (unsigned)(i % pairs), &t);
  tally[0] = t.inv_attempts;
  tally[1] = t.inv_steps;
  tally[2] = t.btrs_attempts;
  return 0;
}
