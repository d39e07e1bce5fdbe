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
// float64 rate, and a warp runs one sampler branch at a time.  So a warp
// takes one pair and 32 of its rounds (bootstrap_lane.cuh's mapping):
// lanes 0-15 load the pair's counts once, sum the cells' masses
// by shuffles and divide out each cell's p, into shared memory; every
// lane then starts each cell from the same constants, at cell 0 with the
// same n, so the lanes part only where their draws differ (a later cell's
// n, the number of rejection attempts).  A lane keeps its running n and
// the current draw in registers and writes each cell into a staging row
// in shared memory; the warp then stores its 32 rounds' rows as 16-byte
// words on consecutive addresses, eight a round's 128 B.  Consecutive
// warps take consecutive pairs of the same rounds.  Built with
// -fmad=false: its float64 operations must round as the host twin's and
// the plain version's do.

#include <cuda_runtime.h>

#include "bootstrap_lane.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * BOOT_WARP;
constexpr int kRow = BOOT_CELLS + 1;  // a staging row, padded off the banks
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const long long* __restrict__ counts, int pairs,
                    int rounds, long long warps, unsigned key,
                    long long* __restrict__ out) {
  __shared__ long long s_cc[kWarps][BOOT_CELLS];
  __shared__ long long s_mass[kWarps][BOOT_CELLS];
  __shared__ double s_p[kWarps][BOOT_CELLS];
  __shared__ long long s_row[kWarps][BOOT_WARP * kRow];
  const int warp = threadIdx.x / BOOT_WARP, lane = threadIdx.x % BOOT_WARP;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= warps) return;  // the whole warp
  const int pair = (int)(w % pairs);
  const long long chunk = w / pairs;

  const long long cc =
      lane < BOOT_CELLS ? __ldg(counts + (long long)pair * BOOT_CELLS + lane)
                        : 0;
  long long mass = cc;  // lanes 0-15: the suffix sums, cell c's mass
#pragma unroll
  for (int d = 1; d < BOOT_CELLS; d *= 2) {
    const long long t = __shfl_down_sync(kFull, mass, d);
    if (lane + d < BOOT_CELLS) mass += t;
  }
  if (lane < BOOT_CELLS) {
    s_cc[warp][lane] = cc;
    s_mass[warp][lane] = mass;
    s_p[warp][lane] = boot_cell_p(cc, mass);
  }
  __syncwarp();

  long long* row = s_row[warp];
  const unsigned round = boot_round(chunk, lane);
  if (round < (unsigned)rounds)
    boot_draw_round(s_cc[warp], s_mass[warp], s_p[warp], key, round,
                    (unsigned)pair, row + lane * kRow, nullptr);
  __syncwarp();

  const long long r0 = boot_round(chunk, 0);
  const int live = rounds - r0 < BOOT_WARP ? (int)(rounds - r0) : BOOT_WARP;
  for (int x = lane; x < live * (BOOT_CELLS / 2); x += BOOT_WARP) {
    const int r = x / (BOOT_CELLS / 2), c = 2 * (x % (BOOT_CELLS / 2));
    longlong2* dst = reinterpret_cast<longlong2*>(
        out + ((r0 + r) * pairs + pair) * BOOT_CELLS + c);
    *dst = make_longlong2(row[r * kRow + c], row[r * kRow + c + 1]);
  }
}

}  // namespace

// counts int64[pairs][16], out int64[rounds][pairs][16] (16-byte aligned)
extern "C" int andix_bootstrap_resample(const long long* counts, int pairs,
                                        int rounds, unsigned key,
                                        long long* out, void* stream) {
  if (pairs <= 0 || rounds <= 0) return 0;
  const long long warps =
      (long long)pairs * ((rounds + BOOT_WARP - 1) / BOOT_WARP);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  resample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      counts, pairs, rounds, warps, key, out);
  return (int)cudaGetLastError();
}
