// Range-min build over the adjacent-LCP array on the card.
//
// Replaces andix/esa/rmq.py:67 (build), plain XLA there, and the torch
// ops of esa/rmq.py's build_plain: four cummin calls, two of them over
// flipped copies, and a shift-min with a concatenation per sparse-table
// row, each a pass over device memory.
//
// What bounds it: bytes.  The build reads the values once (4 B an
// element) and writes pref8 and suff8 (8 B), t8 (28 B a fine block of 8),
// prefg and suffg (8 B a fine block) and tg (small): about 16.5 B an
// element, 0.50 ms at 100,663,296 elements at 3.35 TB/s.  It does a few
// integer mins a byte.  So every array is written once, in 16-byte or
// coalesced 4-byte stores, and nothing is read twice from device memory
// but the fine mins (0.5 B an element):
//   1. fine pass: a block of 256 threads takes 4 groups of 512 elements;
//      a thread loads its fine block of 8 with two 16-byte loads, forms
//      pref8 and suff8 in registers and stores them with 16-byte stores,
//      writes its fine min to t8 row 0 and shared memory; the block scans
//      each group's 64 fine mins into prefg and suffg in shared memory
//      (6 log steps each) and writes the group mins to tg row 0;
//   2. t8 pass: a block loads 256 fine mins and the 63 after them into
//      shared memory and doubles the windows 6 times, one row a step;
//   3. tg: one small launch a row over the group mins (Np / 512 of them).
// The tile bodies are in rmq_tile.cuh, shared with the host twin.

#include <cuda_runtime.h>

#include "rmq_tile.cuh"

namespace {

constexpr int kTile = 256;  // fine blocks a block of threads

__global__ void fine_kernel(const int* __restrict__ v, int nf,
                            int* __restrict__ pref8, int* __restrict__ suff8,
                            int* __restrict__ t8, int* __restrict__ prefg,
                            int* __restrict__ suffg, int* __restrict__ tg) {
  __shared__ int pa[kTile], pb[kTile], sa[kTile], sb[kTile];
  const int f0 = blockIdx.x * kTile;
  const int nt = nf - f0 < kTile ? nf - f0 : kTile;
  const int x = threadIdx.x;
  if (x < nt) {
    const long long e = (long long)(f0 + x) * RMQ_FINE;
    const int m = rmq_fine_block(v + e, pref8 + e, suff8 + e);
    t8[f0 + x] = m;
    pa[x] = m;
    sa[x] = m;
  }
  __syncthreads();
  rmq_group_scan(pa, pb, nt, false, x, kTile);
  rmq_group_scan(sa, sb, nt, true, x, kTile);
  if (x < nt) {
    prefg[f0 + x] = pa[x];
    suffg[f0 + x] = sa[x];
    if ((x & (RMQ_GROUP - 1)) == 0) tg[(f0 + x) / RMQ_GROUP] = sa[x];
  }
}

__global__ void t8_kernel(int nf, int* __restrict__ t8) {
  __shared__ int a[kTile + RMQ_GROUP], b[kTile + RMQ_GROUP];
  const int c0 = blockIdx.x * kTile;
  const int nt = nf - c0 < kTile ? nf - c0 : kTile;
  for (int x = threadIdx.x; x < nt + RMQ_GROUP; x += kTile)
    a[x] = c0 + x < nf ? __ldg((const int*)t8 + c0 + x) : RMQ_INF;
  __syncthreads();
  rmq_t8_tile(a, b, nt, c0, nf, t8, threadIdx.x, kTile);
}

__global__ void tg_kernel(const int* __restrict__ prev, int ng, int span,
                          int* __restrict__ next) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < ng) next[g] = rmq_tg_entry(prev, ng, span, g);
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kTile - 1) / kTile);
}

}  // namespace

// v int32 [np] (np a multiple of 512, below 2^31, 16-byte aligned);
// outputs pref8, suff8 int32 [np] (16-byte aligned), t8 int32 [7, nf],
// prefg, suffg int32 [nf], tg int32 [lg, ng] with nf = np / 8, ng =
// nf / 64.
extern "C" int andix_range_min_build(const int* v, long long np, int* pref8,
                                     int* suff8, int* t8, int* prefg,
                                     int* suffg, int* tg, int lg,
                                     void* stream) {
  if (np <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nf = (int)(np / RMQ_FINE);
  const int ng = nf / RMQ_GROUP;
  fine_kernel<<<blocks_for(nf), kTile, 0, s>>>(v, nf, pref8, suff8, t8,
                                                prefg, suffg, tg);
  t8_kernel<<<blocks_for(nf), kTile, 0, s>>>(nf, t8);
  for (int k = 1, span = 1; k < lg; ++k, span *= 2)
    tg_kernel<<<blocks_for(ng), kTile, 0, s>>>(
        tg + (long long)(k - 1) * ng, ng, span, tg + (long long)k * ng);
  return (int)cudaGetLastError();
}
