// Search-in-the-loop chain walk on the card: one thread per lane.
//
// Replaces andix/chain/walk_sx.py:chain_walk_flat_sx, which in JAX is an
// XLA while_loop running every lane in lock-step, about 150 small tensor
// ops per iteration and an any() test per super-step; in plain PyTorch
// each of those ops is a launch.  Here each thread runs its lane's whole
// state machine (walk_sx_lane.cuh) in registers.
//
// What bounds it on this card: the latency of dependent global loads.  An
// iteration is a short chain of gathers (two query words, the cache
// bracket, one or two suffix-array entries, two or four subject words,
// two LCP entries at a boundary pair), each waiting on the one before, and
// a lane runs thousands of iterations.  With one thread per lane (a few
// thousand lanes) the card is far from full and each thread waits on its
// loads; the host schedule's lever is more segments per lane.  Events go
// straight to global memory at slots taken from one atomic counter; each
// thread writes its own lane's events in chain order, so a stable regroup
// by lane on the host restores every lane's stream.

#include <cuda_runtime.h>
#include <stdint.h>

// sx_walk_lane is __host__ __device__; only its device instance runs here
static __host__ __device__ __forceinline__ int sx_atomic_add(int* p, int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(p, v);
#else
  const int old = *p;
  *p = old + v;
  return old;
#endif
}

#define SX_ATOMIC_ADD(ptr, v) sx_atomic_add((ptr), (v))
#include "walk_sx_lane.cuh"

namespace {

__global__ void chain_walk_sx_kernel(
    SxIndex x, const int* __restrict__ row, const int* __restrict__ qwb,
    const int* __restrict__ rl, const int* __restrict__ thr,
    const int* __restrict__ seg_end, const int* __restrict__ pos0,
    const int* __restrict__ lq0, const int* __restrict__ ls0,
    const int* __restrict__ ll0, int lb, int max_iters, int max_events,
    int unroll, SxEvents ev, int* __restrict__ max_it,
    int* __restrict__ pos, int* __restrict__ lq, int* __restrict__ ls,
    int* __restrict__ ll, unsigned char* __restrict__ fin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lb) return;
  SxLane w;
  w.row = row[lane];
  w.qwb = qwb[lane];
  w.rl = rl[lane];
  w.thr = thr[lane];
  w.seg_end = seg_end[lane];
  w.pos = pos0[lane];
  w.lq = lq0[lane];
  w.ls = ls0[lane];
  w.ll = ll0[lane];
  w.fin = false;
  const int it =
      sx_walk_lane(x, lane, w, max_iters, max_events, unroll, ev);
  pos[lane] = w.pos;
  lq[lane] = w.lq;
  ls[lane] = w.ls;
  ll[lane] = w.ll;
  fin[lane] = w.fin ? 1 : 0;
  atomicMax(max_it, it);
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
  const int threads = 128;
  const int blocks = (lb + threads - 1) / threads;
  chain_walk_sx_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, row, qwb, rl, thr, seg_end, pos0, lq0, ls0, ll0, lb, max_iters,
      max_events, unroll, ev, counters + 1, pos, lq, ls, ll, fin);
  return (int)cudaGetLastError();
}
