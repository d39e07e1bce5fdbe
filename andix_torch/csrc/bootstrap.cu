// Bootstrap resampler on the card: every (round, pair) multinomial
// resample of the averaged counts in one launch.
//
// Replaces andix/bootstrap.py:_resample_fn (a vmapped
// jax.random.multinomial there, reached through device_bootstrap_rounds).
// The stream cannot be jax.random's threefry draws: it is Philox4x32-10
// written into bootstrap_lane.cuh, keyed by the seed, and the tests hold
// it to andix's properties and distribution, not to its draws.
//
// What bounds it: at 406 pairs x 1000 rounds the output is 52 MB (128 B a
// (round, pair)), 15.5 us of writes at 3.35 TB/s; the sampler's float64
// work (15 conditional binomials a (round, pair), each some Philox words
// and, by BTRS, a few logs an attempt) is of the same order at the card's
// float64 rate.  So the design is the plain one: a thread a (round, pair),
// its pair's 16 counts read through the cache (every round reads them),
// its 16 int64 cells written as eight 16-byte stores; consecutive threads
// take consecutive pairs of one round, so the stores of a warp are
// contiguous.  Built with -fmad=false: its float64 operations must round
// as the host twin's and the plain version's do.

#include <cuda_runtime.h>

#include "bootstrap_lane.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const long long* __restrict__ counts, int pairs,
                    long long total, unsigned key,
                    long long* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned round = (unsigned)(t / pairs), pair = (unsigned)(t % pairs);
  long long c[BOOT_CELLS], x[BOOT_CELLS];
  for (int i = 0; i < BOOT_CELLS; ++i)
    c[i] = counts[(long long)pair * BOOT_CELLS + i];
  boot_resample(c, x, key, round, pair, nullptr);
  longlong2* dst = reinterpret_cast<longlong2*>(out + t * BOOT_CELLS);
  for (int i = 0; i < BOOT_CELLS / 2; ++i)
    dst[i] = make_longlong2(x[2 * i], x[2 * i + 1]);
}

}  // namespace

// counts int64[pairs][16], out int64[rounds][pairs][16] (16-byte aligned)
extern "C" int andix_bootstrap_resample(const long long* counts, int pairs,
                                        int rounds, unsigned key,
                                        long long* out, void* stream) {
  const long long total = (long long)pairs * rounds;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  resample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      counts, pairs, total, key, out);
  return (int)cudaGetLastError();
}
