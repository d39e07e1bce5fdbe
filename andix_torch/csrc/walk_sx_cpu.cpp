// Host twin of walk_sx.cu: the same lane body (walk_sx_lane.cuh) with one
// thread per lane, built with g++ and run lane after lane, so the kernel's
// logic is tested on machines without a card.  `tiny` != 0 runs it with
// tiny rounds, windows and staging (2 words a compare round, 3 query
// words, 4 diagonal words, 3 events), so every test case crosses their
// boundaries many times; 0 with the kernel's.  Same C interface as the
// kernel's entry, with `tiny` in place of the stream.

#include "walk_sx_lane.cuh"

namespace {

template <int ROUND, int QWIN, int DWIN, int STAGE>
void walk_lanes(const SxIndex& x, const int* row, const int* qwb,
                const int* rl, const int* thr, const int* seg_end,
                const int* pos0, const int* lq0, const int* ls0,
                const int* ll0, int lb, int max_iters, int max_events,
                int unroll, const SxEvents& ev, int* pos, int* lq, int* ls,
                int* ll, unsigned char* fin) {
  int stage[3 * STAGE];
  for (int lane = 0; lane < lb; ++lane) {
    SxLane w{row[lane], qwb[lane], rl[lane], thr[lane], seg_end[lane],
             pos0[lane], lq0[lane], ls0[lane], ll0[lane], false};
    SxWalk<ROUND, QWIN, DWIN, STAGE, 1> walk(x, w.row, stage, 0);
    const int it = walk.walk(lane, w, max_iters, max_events, unroll, ev);
    pos[lane] = w.pos;
    lq[lane] = w.lq;
    ls[lane] = w.ls;
    ll[lane] = w.ll;
    fin[lane] = w.fin ? 1 : 0;
    if (it > ev.count[1]) ev.count[1] = it;
  }
}

}  // namespace

extern "C" int andix_chain_walk_sx_cpu(
    const int* salcp, const uint64_t* sw, const int* cache2,
    const int* nreal, const uint64_t* qw, long long lp, long long n_qw,
    long long n_cache, int cache_k, const int* row, const int* qwb,
    const int* rl, const int* thr, const int* seg_end, const int* pos0,
    const int* lq0, const int* ls0, const int* ll0, int lb, int max_iters,
    int max_events, int ecap, int unroll, int* ev_lane, int* ev_q,
    int* ev_s, int* ev_len, int* counters, int* pos, int* lq, int* ls,
    int* ll, unsigned char* fin, int tiny) {
  const SxIndex x{salcp, sw, cache2, nreal, qw, lp, n_qw, n_cache, cache_k};
  const SxEvents ev{ev_lane, ev_q, ev_s, ev_len, counters, ecap};
  if (tiny)
    walk_lanes<2, 3, 4, 3>(x, row, qwb, rl, thr, seg_end, pos0, lq0, ls0,
                           ll0, lb, max_iters, max_events, unroll, ev, pos,
                           lq, ls, ll, fin);
  else
    walk_lanes<SX_ROUND, SX_QWIN, SX_DWIN, SX_STAGE>(
        x, row, qwb, rl, thr, seg_end, pos0, lq0, ls0, ll0, lb, max_iters,
        max_events, unroll, ev, pos, lq, ls, ll, fin);
  return 0;
}
