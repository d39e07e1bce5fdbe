// Sampled-PLCP adjacent LCP on the card: one thread an entry.
//
// Replaces andix/esa/plcp.py:plcp_lcp_hybrid_traced (_ladder :110 with its
// while_loop at :186, _fill_from_samples :224), an XLA program of
// lock-step passes over compacted buffers: one global pass counter, tiers
// that shrink the survivors' buffers 4x at a time, and a gather pair per
// pass.  Those are the TPU's workarounds for data-dependent loops; here an
// entry runs its own loop to the end in registers (plcp_lane.cuh), and the
// pass cap becomes a per-thread probe cap with the same outcome.
//
// Four launches on one stream:
//   1. w16: one thread a position packs sym[i..i+15] (coalesced reads).
//   2. sample partners: one thread an SA slot t writes phi(SA[t]) =
//      SA[t - 1] where SA[t] is a multiple of 16 (N / 16 scattered
//      writes), so no inverse SA is built.
//   3. samples: one thread a sample walks the level rows top-down, then
//      probes words.  The rows are separate allocations (the doubling
//      loop allocates one a level), read through a table of pointers.
//   4. fill: one thread an SA slot t: position SA[t] and its partner
//      SA[t - 1] come from two coalesced reads, the Kasai bound from the
//      sample, one probe finishes most entries; lcp[t] is written in SA
//      order, so PLCP is never stored and no final gather runs.
//
// What bounds it: bytes at best (the text, SA and LCP, 12 B a position,
// and the level entries the samples' walks read), but the probes and the
// walk are random 8- and 4-byte reads, one latency round each; the fill's
// single probe pair per position is the bulk.  Speed work is for later.

#include <cuda_runtime.h>

#include "plcp_lane.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void w16_kernel(const int32_t* __restrict__ sym, int64_t n,
                           int64_t* __restrict__ w16) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) w16[i] = plcp_word(sym, n, i);
}

__global__ void sample_phi_kernel(const int32_t* __restrict__ sa, int64_t n,
                                  int32_t* __restrict__ sphi) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int32_t i = sa[t];
  if ((i & 15) == 0) sphi[i >> 4] = t > 0 ? sa[t - 1] : -1;
}

__global__ void samples_kernel(PlcpView v, const int32_t* __restrict__ sphi,
                               int64_t ns, int32_t* __restrict__ S,
                               int* __restrict__ counters) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ns) return;
  bool open;
  S[j] = plcp_sample(v, sphi[j], j, &open);
  if (open) atomicAdd(&counters[0], 1);
}

__global__ void fill_kernel(PlcpView v, const int32_t* __restrict__ sa,
                            const int32_t* __restrict__ S,
                            int* __restrict__ counters,
                            int32_t* __restrict__ lcp) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= v.n) return;
  bool open;
  lcp[t] = plcp_fill(v, sa, S, t, &open);
  if (open) atomicAdd(&counters[1], 1);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// sym, sa int32 [n]; rows: a device table of L device pointers, each to
// an int32 [n] level row; outputs: w16 int64 [n], sphi and S int32
// [n / 16], counters int32 [2] (open samples, open survivors; zeroed by
// the caller), lcp int32 [n].  n is a multiple of 16 and below 2^31.
extern "C" int andix_plcp_hybrid(const int32_t* sym, const int32_t* sa,
                                 const int32_t* const* rows, int L,
                                 int lev_cnt,
                                 int base, long long n, int64_t* w16,
                                 int32_t* sphi, int32_t* S, int* counters,
                                 int32_t* lcp, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ns = n / 16;
  w16_kernel<<<blocks_for(n), kThreads, 0, s>>>(sym, n, w16);
  sample_phi_kernel<<<blocks_for(n), kThreads, 0, s>>>(sa, n, sphi);
  const PlcpView v{w16, rows, n, L, lev_cnt, base};
  samples_kernel<<<blocks_for(ns), kThreads, 0, s>>>(v, sphi, ns, S,
                                                       counters);
  fill_kernel<<<blocks_for(n), kThreads, 0, s>>>(v, sa, S, counters, lcp);
  return (int)cudaGetLastError();
}
