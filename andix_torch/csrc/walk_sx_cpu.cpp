// Host twin of walk_sx.cu: the same per-lane body (walk_sx_lane.cuh),
// built with g++ and run lane after lane, so the kernel's logic is tested
// on machines without a card.  Same C interface minus the stream.

static int serial_add(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

#define SX_ATOMIC_ADD(ptr, v) serial_add((ptr), (v))
#include "walk_sx_lane.cuh"

extern "C" int andix_chain_walk_sx_cpu(
    const int* salcp, const uint64_t* sw, const int* cache2,
    const int* nreal, const uint64_t* qw, long long lp, long long n_qw,
    long long n_cache, int cache_k, const int* row, const int* qwb,
    const int* rl, const int* thr, const int* seg_end, const int* pos0,
    const int* lq0, const int* ls0, const int* ll0, int lb, int max_iters,
    int max_events, int ecap, int unroll, int* ev_lane, int* ev_q,
    int* ev_s, int* ev_len, int* counters, int* pos, int* lq, int* ls,
    int* ll, unsigned char* fin) {
  const SxIndex x{salcp, sw, cache2, nreal, qw, lp, n_qw, n_cache, cache_k};
  const SxEvents ev{ev_lane, ev_q, ev_s, ev_len, counters, ecap};
  for (int lane = 0; lane < lb; ++lane) {
    SxLane w{row[lane], qwb[lane], rl[lane], thr[lane], seg_end[lane],
             pos0[lane], lq0[lane], ls0[lane], ll0[lane], false};
    const int it =
        sx_walk_lane(x, lane, w, max_iters, max_events, unroll, ev);
    pos[lane] = w.pos;
    lq[lane] = w.lq;
    ls[lane] = w.ls;
    ll[lane] = w.ll;
    fin[lane] = w.fin ? 1 : 0;
    if (it > counters[1]) counters[1] = it;
  }
  return 0;
}
