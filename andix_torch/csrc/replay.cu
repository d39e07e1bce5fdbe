// Count-in-loop replay on the card: segmented lanes, reconciled exactly
// on the card (replay_lane.cuh says why the splice is exact).
//
// Replaces andix/chain/replay_device.py:replay_rows_device, an XLA
// while_loop that runs every (subject, query) lane of a subject group in
// lock-step and counts the 16 substitution cells inside the loop.  andix's
// default path walks the chain on the device, moves every anchor to the
// host (16 B an event) and counts there from host text; these kernels
// count on the card from the block text the walk already holds
// (BlockContext.text) and return Sg x G x 16 int32 counts.
//
// What bounds it on this card: the latency of dependent loads along a
// chain, as for the flat walk (chain_walk.cu), plus the counted sites'
// bytes.  Unsegmented, the most diverged pair of a group set the time
// (one lane of 196,582 probe steps at 8 x 5 Mbp), and a group of 8
// genomes gave 64 warps for 132 SMs.  So:
// 1. Pass 1 (replay_cold_kernel): each lane is cut into K query segments,
//    one warp a segment, four warps a block, all walked at once; the
//    longest chain falls about K-fold and the card holds several warps an
//    SM to hide each one's load latency.  Segment 0 walks the true chain;
//    the others start cold and leave a trail of their first M + 1 anchors,
//    the counts after it, and their exit state in a small global
//    workspace.
// 2. Pass 2 (replay_splice_kernel): one warp a lane, one a block, walks
//    from each segment's true entry until it accepts a trail anchor (a few
//    anchors on related genomes), then takes the segment's counts and exit
//    from the workspace.
// Both passes count as the unsegmented kernel did: the 32 threads read a
// gap's two byte runs coalesced, 32 sites a round with the loads of 4
// rounds in flight, each thread adding to its own column of a 16 x 32
// counter tile in shared memory (no atomics, no bank conflicts);
// fast-mode equal anchors (JC, Kimura, Raw) are arithmetic on two
// registers; at the end a conflict-free reduction of the columns.  Exact
// equal sites (LogDet, ANI) are counted in registers, four bytes a word,
// from 16-byte loads where the interval is long; an identical pair's one
// anchor (the whole query) is summed from the nucleotides pass 1 counted
// a segment a warp, not read again by one warp in pass 2.  The passes run
// on one stream, so pass 2 sees pass 1's workspace.

#include <cuda_runtime.h>

#include "replay_lane.cuh"

namespace {

constexpr int kColdWarps = 4;

// the 16 column sums of a walker's tile into out[0..15], with the
// fast-mode equal counts, from threads 0-15
__device__ __forceinline__ void reduce_cells(const int* hist, int tid,
                                             const ReplayCounter<32>& cnt,
                                             int* out) {
  __syncwarp();
  if (tid < 16) {
    int sum = 0;
    for (int j = 0; j < 32; ++j) sum += hist[tid * 32 + ((j + tid) & 31)];
    if (tid == 0 || tid == 5 || tid == 10 || tid == 15)
      sum += cnt.diag_quarters;
    if (tid == 15) sum += cnt.tt_rest;
    out[tid] = sum;
  }
}

__device__ __forceinline__ ReplayLane lane_of(
    int lane, int g, const int* ss, const int* rl, const int* thr,
    const int* q_base, const int* q_start, const int* q_len) {
  const int k = lane / g, q = lane % g;
  return ReplayLane{k, q_base[q], q_start[q], ss[k], rl[k], thr[k],
                    q_len[lane]};
}

__global__ void __launch_bounds__(32 * kColdWarps) replay_cold_kernel(
    WalkTables t, const int* __restrict__ ss, const int* __restrict__ rl,
    const int* __restrict__ thr, const int* __restrict__ q_base,
    const int* __restrict__ q_start, const int* __restrict__ q_len, int sg,
    int g, int k, int m, int exact, int chase, int* __restrict__ ws,
    int* __restrict__ err) {
  __shared__ int hist_all[kColdWarps][16 * 32];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sub = (long long)blockIdx.x * kColdWarps + warp;
  if (sub >= (long long)sg * g * k) return;
  const int lane = (int)(sub / k), j = (int)(sub % k);
  const ReplayLane r = lane_of(lane, g, ss, rl, thr, q_base, q_start, q_len);
  if (r.qlen <= 0) return;
  int start, end;
  replay_segment(r.qlen, k, j, start, end);
  if (start >= end) return;  // pass 2 never reads an empty segment
  int* hist = hist_all[warp];
#pragma unroll
  for (int c = 0; c < 16; ++c) hist[c * 32 + tid] = 0;
  ReplayCounter<32> cnt{t.text, t.n, hist, tid, err};
  int* seg = ws + sub * replay_seg_ints(m);
  replay_cold<WALK_ROW_WIN, WALK_DIAG_WIN, 32>(t, r, k, j, m, exact != 0,
                                               chase, cnt, seg);
  reduce_cells(hist, tid, cnt, seg + REPLAY_SEG_CELLS);
  if (tid == 0) {
    seg[REPLAY_SEG_GAP] = cnt.gap_sites;
    seg[REPLAY_SEG_EQ] = cnt.eq_sites;
  }
}

__global__ void __launch_bounds__(32) replay_splice_kernel(
    WalkTables t, const int* __restrict__ ss, const int* __restrict__ rl,
    const int* __restrict__ thr, const int* __restrict__ q_base,
    const int* __restrict__ q_start, const int* __restrict__ q_len, int sg,
    int g, int k, int m, int exact, int chase,
    const int* __restrict__ ws, int* __restrict__ counts,
    int* __restrict__ stats, int* __restrict__ splice,
    int* __restrict__ err) {
  __shared__ int hist[16 * 32];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  if (lane >= sg * g) return;
  const ReplayLane r = lane_of(lane, g, ss, rl, thr, q_base, q_start, q_len);
  if (r.qlen <= 0) return;  // counts and stats were zeroed
#pragma unroll
  for (int c = 0; c < 16; ++c) hist[c * 32 + tid] = 0;
  ReplayCounter<32> cnt{t.text, t.n, hist, tid, err};
  const int* segs = ws + (long long)lane * k * replay_seg_ints(m);
  const int probes = replay_splice<WALK_ROW_WIN, WALK_DIAG_WIN, 32>(
      t, r, k, m, segs, exact != 0, chase, cnt,
      splice + (long long)lane * REPLAY_SPLICE);
  reduce_cells(hist, tid, cnt, counts + (long long)lane * 16);
  if (tid == 0) {
    stats[lane * REPLAY_STATS] = probes;
    stats[lane * REPLAY_STATS + 1] = cnt.gap_sites;
    stats[lane * REPLAY_STATS + 2] = cnt.eq_sites;
  }
}

WalkTables tables(const int* isa, const unsigned char* text, long long n,
                  const int* rm_values, const int* rm_pref8,
                  const int* rm_suff8, const int* rm_t8,
                  const int* rm_prefg, const int* rm_suffg,
                  const int* rm_tg, int nf, int ng, int lg, const int* mlun,
                  const int* ps, long long qb) {
  WalkTables t;
  t.isa = isa;
  t.text = text;
  t.n = n;
  t.rm = RangeMinView{rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
                      rm_suffg, rm_tg, nf, ng, lg};
  t.mlun = mlun;
  t.ps = ps;
  t.qb = qb;
  return t;
}

}  // namespace

// ints of one sublane's workspace at a trail of m anchors
extern "C" int andix_replay_seg_ints(int m) { return replay_seg_ints(m); }

// Pass 1: the cold walks of every (lane, segment) into ws, int32
// [sg * g * k, replay_seg_ints(m)].  Lane l = kk * g + q pairs subject row
// kk with query q; its segment j is sublane l * k + j.  err [1] must be
// zero before pass 1.  mlun and ps must be 16-byte aligned with qb % 4 ==
// 0 (the row window's vector loads).
extern "C" int andix_replay_cold(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* ss, const int* rl,
    const int* thr, const int* q_base, const int* q_start,
    const int* q_len, int sg, int g, int k, int m, int exact, int chase,
    int* ws, int* err, void* stream) {
  if (sg <= 0 || g <= 0) return 0;
  const long long subs = (long long)sg * g * k;
  const int blocks = (int)((subs + kColdWarps - 1) / kColdWarps);
  replay_cold_kernel<<<blocks, 32 * kColdWarps, 0, (cudaStream_t)stream>>>(
      tables(isa, text, n, rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
             rm_suffg, rm_tg, nf, ng, lg, mlun, ps, qb),
      ss, rl, thr, q_base, q_start, q_len, sg, g, k, m, exact, chase, ws,
      err);
  return (int)cudaGetLastError();
}

// Pass 2: the splice of each lane's segments from ws.  counts [sg * g *
// 16], stats [sg * g * REPLAY_STATS] and splice [sg * g * REPLAY_SPLICE]
// must be zero on entry.
extern "C" int andix_replay_splice(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* ss, const int* rl,
    const int* thr, const int* q_base, const int* q_start,
    const int* q_len, int sg, int g, int k, int m, int exact, int chase,
    const int* ws, int* counts, int* stats, int* splice, int* err,
    void* stream) {
  if (sg <= 0 || g <= 0) return 0;
  replay_splice_kernel<<<sg * g, 32, 0, (cudaStream_t)stream>>>(
      tables(isa, text, n, rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
             rm_suffg, rm_tg, nf, ng, lg, mlun, ps, qb),
      ss, rl, thr, q_base, q_start, q_len, sg, g, k, m, exact, chase, ws,
      counts, stats, splice, err);
  return (int)cudaGetLastError();
}
