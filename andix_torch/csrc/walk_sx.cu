// Search-in-the-loop chain walk on the card: one warp per lane.
//
// Replaces andix/chain/walk_sx.py:chain_walk_flat_sx, which in JAX is an
// XLA while_loop running every lane in lock-step, about 150 small tensor
// ops per iteration and an any() test per super-step; in plain PyTorch
// each of those ops is a launch.  Here each lane's probes run in
// registers (walk_sx_lane.cuh).
//
// What bounds it on this card: the latency of dependent global loads,
// not bytes.  A first dispatch must move 51-66 MB at 8 x 1 and 8 x 5 Mbp
// (the index entries and words its searches touch, the query words, the
// events), 0.015-0.020 ms at 3.35 TB/s, but each probe is a chain of
// dependent reads: the cache bracket, then per bisection step a suffix
// array entry and then the subject words it points at, then the boundary
// pair and its LCP entries.  The old design ran one thread per lane (a
// few thousand threads) and compared one 16-symbol word per round of
// loads.  This one cuts the rounds:
// 1. One warp per lane (4 lanes a block): 32 threads to issue a lane's
//    loads and compares.  All of them hold the lane state and take the
//    same branches.  At about 80 registers a thread 24 lanes fit an SM, so the
//    8192 lanes of a first dispatch run in about 2.6 waves.
// 2. Every compare takes 32 words (512 symbols) a round, one word a
//    thread; a ballot of mismatches and __ffs give the first differing
//    word.  A long match costs one round of loads per 512 symbols instead
//    of one per 16.
// 3. The query words come from a window of 64 words in registers (2 a
//    thread, read by shuffles), refilled only when the lane's position
//    leaves it; the lucky checks read the subject through a second such
//    window, kept along the diagonal of a homologous stretch.
// 4. Accepted anchors are staged in shared memory, 32 a lane; one
//    atomicAdd reserves a batch's slots and the warp writes it.
// 5. The iteration count of the JAX loop's one-word steps is computed
//    from the compare outcomes, so where a dispatch stops at its cap and
//    the iterations it reports are the plain version's exactly.
// What remains is the search probes' chain (eight in ten probes at 8 x 1
// and 8 x 5 Mbp): cache bracket, then the suffix array pair with its LCP
// entries, then the subject words, three dependent memory rounds a probe.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_sx_lane.cuh"

namespace {

constexpr int kWarps = 4;  // lanes a block

__global__ void __launch_bounds__(32 * kWarps) chain_walk_sx_kernel(
    SxIndex x, const int* __restrict__ row, const int* __restrict__ qwb,
    const int* __restrict__ rl, const int* __restrict__ thr,
    const int* __restrict__ seg_end, const int* __restrict__ pos0,
    const int* __restrict__ lq0, const int* __restrict__ ls0,
    const int* __restrict__ ll0, int lb, int max_iters, int max_events,
    int unroll, SxEvents ev, int* __restrict__ max_it,
    int* __restrict__ pos, int* __restrict__ lq, int* __restrict__ ls,
    int* __restrict__ ll, unsigned char* __restrict__ fin) {
  __shared__ int stage[kWarps][3 * SX_STAGE];
  const int warp = threadIdx.x / 32, tid = threadIdx.x % 32;
  const int lane = blockIdx.x * kWarps + warp;
  if (lane >= lb) return;  // the whole warp
  SxLane w{row[lane], qwb[lane], rl[lane], thr[lane], seg_end[lane],
           pos0[lane], lq0[lane], ls0[lane], ll0[lane], false};
  SxWalk<SX_ROUND, SX_QWIN, SX_DWIN, SX_STAGE, 32> walk(x, w.row,
                                                        stage[warp], tid);
  const int it = walk.walk(lane, w, max_iters, max_events, unroll, ev);
  if (tid == 0) {
    pos[lane] = w.pos;
    lq[lane] = w.lq;
    ls[lane] = w.ls;
    ll[lane] = w.ll;
    fin[lane] = w.fin ? 1 : 0;
    atomicMax(max_it, it);
  }
}

}  // namespace

// counters[0] = events found (may exceed ecap), counters[1] = the
// iteration count of the lock-step loop; both must be zero on entry.
extern "C" int andix_chain_walk_sx(
    const int* salcp, const uint64_t* sw, const int* cache2,
    const int* nreal, const uint64_t* qw, long long lp, long long n_qw,
    long long n_cache, int cache_k, const int* row, const int* qwb,
    const int* rl, const int* thr, const int* seg_end, const int* pos0,
    const int* lq0, const int* ls0, const int* ll0, int lb, int max_iters,
    int max_events, int ecap, int unroll, int* ev_lane, int* ev_q,
    int* ev_s, int* ev_len, int* counters, int* pos, int* lq, int* ls,
    int* ll, unsigned char* fin, void* stream) {
  if (lb <= 0) return 0;
  const SxIndex x{salcp, sw, cache2, nreal, qw, lp, n_qw, n_cache, cache_k};
  const SxEvents ev{ev_lane, ev_q, ev_s, ev_len, counters, ecap};
  const int blocks = (lb + kWarps - 1) / kWarps;
  chain_walk_sx_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      x, row, qwb, rl, thr, seg_end, pos0, lq0, ls0, ll0, lb, max_iters,
      max_events, unroll, ev, counters + 1, pos, lq, ls, ll, fin);
  return (int)cudaGetLastError();
}
