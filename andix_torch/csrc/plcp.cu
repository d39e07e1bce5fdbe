// Sampled-PLCP adjacent LCP on the card.
//
// Replaces andix/esa/plcp.py:267, plcp_lcp_hybrid_traced (_ladder :110
// with its while_loop at :186, _fill_from_samples :224), an XLA program
// of lock-step passes over compacted buffers: one global pass counter,
// tiers that shrink the survivors' buffers 4x at a time, and a gather
// pair per pass.  Those are the TPU's workarounds for data-dependent
// loops; here an entry runs its own loop to the end in registers
// (plcp_lane.cuh), and the pass cap becomes a per-thread probe cap with
// the same outcome.
//
// What bounds it.  The bytes it must move are the text and SA read and
// the LCP written, 12 B a position, and the level entries the samples'
// walks read.  What it spends is random sectors: every probe reads two
// words at positions the data picks, and a walk reads two rank entries a
// level row.  So the design keeps the probed data small enough for the
// 50 MB L2 and walks as few samples as it can:
//   * the text is packed 4 bits a symbol, 16 to a 64-bit word (N / 2 B:
//     8 MB at 2^24, 50 MB at 100,663,296), read through the read-only
//     path.  A probe joins the two aligned words around its position
//     with a funnel shift, mostly within one 32-byte sector.  SA is read
//     with streaming loads and the LCP written with streaming stores, so
//     the streamed data does not evict the text;
//   * samples go in runs of `chain` to a thread: the run's first walks
//     the level rows, every later one starts from the Kasai bound of the
//     one before and needs one or two probes (plcp_lane.cuh says when the
//     chain's outcome is andix's and when a sample takes the walk).
//
// Four launches on one stream:
//   1. pack: one thread a word k packs sym[16 k .. 16 k + 15] (four
//      16-byte loads) and, for the SA slots t = 16 k .. 16 k + 15, writes
//      phi(SA[t]) = SA[t - 1] where SA[t] is a multiple of 16 (N / 16
//      scattered writes), so no inverse SA is built;
//   2. samples: one thread a run of `chain` samples, which settles all
//      but the samples whose outcome needs andix's capped schedule;
//   3. settle: one thread a sample runs that schedule for those (none
//      where every level row is there);
//   4. fill: one thread an SA slot t: position SA[t] and its partner
//      SA[t - 1] from streamed reads, the Kasai bound from the sample, one
//      probe finishes most entries; lcp[t] is written in SA order, so PLCP
//      is never stored and no final gather runs.

#include <cuda_runtime.h>

#include "plcp_lane.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load16(const int32_t* __restrict__ p,
                                       int32_t* out) {
  const int4* q = reinterpret_cast<const int4*>(p);
  for (int c = 0; c < 4; ++c) {
    const int4 x = __ldcs(q + c);
    out[4 * c] = x.x;
    out[4 * c + 1] = x.y;
    out[4 * c + 2] = x.z;
    out[4 * c + 3] = x.w;
  }
}

__global__ void pack_kernel(const int32_t* __restrict__ sym,
                            const int32_t* __restrict__ sa, int64_t nw,
                            uint64_t* __restrict__ text,
                            int32_t* __restrict__ sphi) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nw + PLCP_TEXT_PAD) return;
  if (k >= nw) {  // the words past the end
    text[k] = 0;
    return;
  }
  int32_t s[16];
  load16(sym + 16 * k, s);
  text[k] = plcp_pack16(s);
  load16(sa + 16 * k, s);
  int32_t prev = k > 0 ? __ldcs(sa + 16 * k - 1) : -1;
  for (int c = 0; c < 16; ++c) {
    if ((s[c] & 15) == 0) sphi[s[c] >> 4] = prev;
    prev = s[c];
  }
}

__global__ void samples_kernel(PlcpView v, const int32_t* __restrict__ sphi,
                               int64_t ns, int chain, int tries,
                               int32_t* __restrict__ S) {
  const int64_t j0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * chain;
  if (j0 < ns) plcp_run(v, sphi, j0, j0 + chain < ns ? j0 + chain : ns,
                        tries, S);
}

__global__ void settle_kernel(PlcpView v, const int32_t* __restrict__ sphi,
                              int64_t ns, int32_t* __restrict__ S,
                              int* __restrict__ counters) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool open = false, deferred = false;
  if (j < ns) deferred = plcp_settle(v, sphi, j, S, &open);
  // one atomic a warp for the deferred samples; opens are rare
  const int n_def = __reduce_add_sync(0xffffffffu, (int)deferred);
  if ((threadIdx.x & 31) == 0 && n_def) atomicAdd(&counters[2], n_def);
  if (open) atomicAdd(&counters[0], 1);
}

__global__ void fill_kernel(PlcpView v, const int32_t* __restrict__ sa,
                            const int32_t* __restrict__ S,
                            int* __restrict__ counters,
                            int32_t* __restrict__ lcp) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= v.n) return;
  if (t == 0) {
    __stcs(lcp, 0);
    return;
  }
  bool open;
  const int out =
      plcp_fill(v, __ldcs(sa + t), __ldcs(sa + t - 1), S, &open);
  __stcs(lcp + t, out);
  if (open) atomicAdd(&counters[1], 1);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// sym, sa int32 [n], both 16-byte aligned; rows: a device table of L
// device pointers, each to an int32 [n] level row; chain: samples a run
// (1: every sample walks), tries: probes a sample of a run gets from its
// bound, and after its walk (at most 64); outputs: text uint64 [n / 16 +
// 2] (16-byte aligned), sphi and S int32 [n / 16], counters int32 [3]
// (open samples, open survivors, samples deferred to the settle pass;
// zeroed by the caller), lcp int32 [n].  n is a multiple of 16 and below
// 2^31.
extern "C" int andix_plcp_hybrid(const int32_t* sym, const int32_t* sa,
                                 const int32_t* const* rows, int L,
                                 int lev_cnt, int base, long long n,
                                 int chain, int tries, uint64_t* text,
                                 int32_t* sphi, int32_t* S, int* counters,
                                 int32_t* lcp, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ns = n / 16;
  pack_kernel<<<blocks_for(ns + PLCP_TEXT_PAD), kThreads, 0, s>>>(
      sym, sa, ns, text, sphi);
  const PlcpView v{text, rows, n, L, lev_cnt, base};
  samples_kernel<<<blocks_for((ns + chain - 1) / chain), kThreads, 0, s>>>(
      v, sphi, ns, chain, tries, S);
  settle_kernel<<<blocks_for(ns), kThreads, 0, s>>>(v, sphi, ns, S,
                                                     counters);
  fill_kernel<<<blocks_for(n), kThreads, 0, s>>>(v, sa, S, counters, lcp);
  return (int)cudaGetLastError();
}
