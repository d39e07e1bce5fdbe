// Count-in-loop replay on the card: one warp per lane.
//
// Replaces andix/chain/replay_device.py:replay_rows_device, an XLA
// while_loop that runs every (subject, query) lane of a subject group in
// lock-step and counts the 16 substitution cells inside the loop.  andix's
// default path walks the chain on the device, moves every anchor to the
// host (16 B an event) and counts there from host text; this kernel
// counts on the card from the block text the walk already holds
// (BlockContext.text) and returns Sg x G x 16 int32 counts.
//
// What bounds it on this card: the latency of dependent loads along one
// lane's chain, as for the flat walk (chain_walk.cu), plus the counted
// sites' bytes.  A lane is not segmented: the most diverged pair of the
// group sets the kernel's time, and a group of 8 genomes gives only 64
// lanes (64 warps) for 132 SMs.  The design keeps what the flat walk does
// against the latency (walk_lane.cuh: the 256-entry row window read by
// shuffles, the lucky check by comparing 256 text pairs along the
// diagonal) and adds only the counting:
// 1. The 32 threads read an interval's two byte runs coalesced, 32 sites
//    a round with the loads of 4 rounds in flight, and each thread adds
//    to its own column of the lane's 16 x 32 counters in shared memory:
//    no atomics and no bank conflicts.  Fast-mode equal anchors (JC,
//    Kimura, Raw) are arithmetic on two registers.
// 2. One warp a block, so the few lanes of a group spread over as many
//    SMs as there are lanes.
// 3. At the lane's end a conflict-free reduction of the columns and one
//    16-int write.

#include <cuda_runtime.h>

#include "replay_lane.cuh"

namespace {

__global__ void __launch_bounds__(32) replay_rows_kernel(
    WalkTables t, const int* __restrict__ ss, const int* __restrict__ rl,
    const int* __restrict__ thr, const int* __restrict__ q_base,
    const int* __restrict__ q_start, const int* __restrict__ q_len, int sg,
    int g, int exact, int chase, int* __restrict__ counts,
    int* __restrict__ stats, int* __restrict__ err) {
  __shared__ int hist[16 * 32];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  if (lane >= sg * g) return;
  const int k = lane / g, q = lane % g;
  const ReplayLane r{k, q_base[q], q_start[q], ss[k], rl[k], thr[k],
                     q_len[lane]};
  if (r.qlen <= 0) return;  // counts and stats were zeroed
#pragma unroll
  for (int c = 0; c < 16; ++c) hist[c * 32 + tid] = 0;
  ReplayCounter<32> cnt{t.text, t.n, hist, tid, err};
  const int probes = replay_lane<WALK_ROW_WIN, WALK_DIAG_WIN, 32>(
      t, r, exact != 0, chase, cnt);
  __syncwarp();
  if (tid < 16) {
    int sum = 0;
    for (int j = 0; j < 32; ++j) sum += hist[tid * 32 + ((j + tid) & 31)];
    if (tid == 0 || tid == 5 || tid == 10 || tid == 15)
      sum += cnt.diag_quarters;
    if (tid == 15) sum += cnt.tt_rest;
    counts[(long long)lane * 16 + tid] = sum;
  }
  if (tid == 0) {
    stats[lane * REPLAY_STATS] = probes;
    stats[lane * REPLAY_STATS + 1] = cnt.gap_sites;
    stats[lane * REPLAY_STATS + 2] = cnt.eq_sites;
  }
}

}  // namespace

// counts [sg * g * 16], stats [sg * g * 3] and err [1] must be zero on
// entry; lane k * g + q pairs subject row k with query q.  mlun and ps
// must be 16-byte aligned with qb % 4 == 0 (the row window's vector
// loads).
extern "C" int andix_replay_rows(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* ss, const int* rl,
    const int* thr, const int* q_base, const int* q_start,
    const int* q_len, int sg, int g, int exact, int chase, int* counts,
    int* stats, int* err, void* stream) {
  if (sg <= 0 || g <= 0) return 0;
  WalkTables t;
  t.isa = isa;
  t.text = text;
  t.n = n;
  t.rm = RangeMinView{rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
                      rm_suffg, rm_tg, nf, ng, lg};
  t.mlun = mlun;
  t.ps = ps;
  t.qb = qb;
  replay_rows_kernel<<<sg * g, 32, 0, (cudaStream_t)stream>>>(
      t, ss, rl, thr, q_base, q_start, q_len, sg, g, exact, chase, counts,
      stats, err);
  return (int)cudaGetLastError();
}
