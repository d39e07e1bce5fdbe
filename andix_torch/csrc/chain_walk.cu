// Flat chain walk on the card: one warp per lane.
//
// Replaces andix/chain/replay_device.py:chain_walk_flat, which in JAX is
// an XLA while_loop running every lane in lock-step.  In plain PyTorch
// that loop is ~40 small launches per probe step, times `unroll` steps
// and `chase` hops per iteration, times thousands of iterations per
// chunk: launch-bound.  Here each lane's whole state machine
// (walk_lane.cuh) runs in registers.
//
// What bounds it on this card: the latency of dependent global loads, not
// bytes.  A dispatch moves a few MB (table entries at the probes, text
// pairs of the lucky checks, 16 B per event) — microseconds at 3.35 TB/s
// — but a lane is a chain of thousands of probes, each of which used to
// wait on several dependent loads: up to 1 + chase mlun reads to hop, two
// ISA reads and then the range-min tables for a lucky check, mlun and ps
// at the probe when the check fails, and an atomic round trip per
// accepted anchor.  The tables of an 8 x 5 Mbp block are far beyond the
// 50 MB L2, so each of those is a miss to device memory.  The design cuts
// the round trips per probe:
// 1. One warp per lane (4 lanes a block), so the first dispatch's 512
//    lanes spread over 128 blocks and every SM, and each lane has 32
//    threads to issue its loads.  All of them hold the lane state and
//    take the same branches.
// 2. A window of 256 consecutive entries of the lane's mlun and ps rows,
//    8 per thread as aligned 16-byte loads, read through shuffles: a hop
//    of ~12-16 positions costs a shuffle, and a diverged lane runs
//    several probes with their whole chase per refill.
// 3. The lucky check compares the two diagonals of the text directly, 256
//    symbol pairs a refill (8 a thread, then a ballot each), and keeps the
//    mismatch mask in registers: the next checks along the same stretch
//    cost no load.  Only an LCE that reaches past the window takes ISA +
//    range-min, with the ISA pair loaded in the window's round.  No branch
//    waits on a text byte, so the 16 byte loads of a refill go out
//    together.
// 4. Accepted anchors are staged in shared memory, 32 a lane; one
//    atomicAdd reserves a batch's slots and the warp writes it coalesced.
// 5. The loads a probe may need that do not depend on each other (the
//    diagonal window, the row window at the probe, the ISA pair) are
//    issued in one round.

#include <cuda_runtime.h>

#include "walk_lane.cuh"

namespace {

constexpr int kWarps = 4;  // lanes a block

__global__ void __launch_bounds__(32 * kWarps) chain_walk_flat_kernel(
    WalkTables t, const int* __restrict__ row, const int* __restrict__ qoff,
    const int* __restrict__ qs, const int* __restrict__ ss,
    const int* __restrict__ rl, const int* __restrict__ thr,
    const int* __restrict__ seg_end, const int* __restrict__ pos0,
    const int* __restrict__ lq0, const int* __restrict__ ls0,
    const int* __restrict__ ll0, int lb, int max_iters, int max_events,
    int chase, int unroll, WalkEvents ev, int* __restrict__ max_it,
    int* __restrict__ pos, int* __restrict__ lq, int* __restrict__ ls,
    int* __restrict__ ll, unsigned char* __restrict__ fin) {
  __shared__ int stage[kWarps][3 * WALK_STAGE];
  const int warp = threadIdx.x / 32, tid = threadIdx.x % 32;
  const int lane = blockIdx.x * kWarps + warp;
  if (lane >= lb) return;  // the whole warp
  WalkLane w;
  w.row = row[lane];
  w.qoff = qoff[lane];
  w.qs = qs[lane];
  w.ss = ss[lane];
  w.rl = rl[lane];
  w.thr = thr[lane];
  w.seg_end = seg_end[lane];
  w.pos = pos0[lane];
  w.lq = lq0[lane];
  w.ls = ls0[lane];
  w.ll = ll0[lane];
  const int it = walk_lane<WALK_ROW_WIN, WALK_DIAG_WIN, WALK_STAGE, 32>(
      t, lane, w, max_iters, max_events, chase, unroll, ev, stage[warp],
      tid);
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

// counters[0] = events found (may exceed ecap), counters[1] = the largest
// per-lane iteration count; both must be zero on entry.  mlun and ps must
// be 16-byte aligned with qb % 4 == 0 (the row window's vector loads).
extern "C" int andix_chain_walk_flat(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* row, const int* qoff,
    const int* qs, const int* ss, const int* rl, const int* thr,
    const int* seg_end, const int* pos0, const int* lq0, const int* ls0,
    const int* ll0, int lb, int max_iters, int max_events, int ecap,
    int chase, int unroll, int* ev_lane, int* ev_q, int* ev_s, int* ev_len,
    int* counters, int* pos, int* lq, int* ls, int* ll, unsigned char* fin,
    void* stream) {
  if (lb <= 0) return 0;
  WalkTables t;
  t.isa = isa;
  t.text = text;
  t.n = n;
  t.rm = RangeMinView{rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
                      rm_suffg, rm_tg, nf, ng, lg};
  t.mlun = mlun;
  t.ps = ps;
  t.qb = qb;
  WalkEvents ev{ev_lane, ev_q, ev_s, ev_len, counters, ecap};
  const int blocks = (lb + kWarps - 1) / kWarps;
  chain_walk_flat_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      t, row, qoff, qs, ss, rl, thr, seg_end, pos0, lq0, ls0, ll0, lb,
      max_iters, max_events, chase, unroll, ev, counters + 1, pos, lq, ls,
      ll, fin);
  return (int)cudaGetLastError();
}

// the diagonal window's symbol pairs: a lucky check whose LCE reaches it
// takes ISA + range-min
extern "C" int andix_walk_diag_win() { return WALK_DIAG_WIN; }

// the library's own CUDA runtime (linked statically) keeps its own
// current device per host thread: set it to the launch's card
extern "C" int andix_set_device(int device) {
  return (int)cudaSetDevice(device);
}

extern "C" const char* andix_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
