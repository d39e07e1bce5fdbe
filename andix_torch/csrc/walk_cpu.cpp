// Host twin of chain_walk.cu: the same lane body (walk_lane.cuh) with one
// thread per lane, built with g++ and run lane after lane, so the kernel's
// logic is tested on machines without a card.  `tiny` != 0 runs it with
// tiny windows and staging (4 row entries, 8 diagonal pairs, 3 events),
// so every test case crosses their boundaries many times; 0 with the
// kernel's.  Same C interface as the kernel's entry, with `tiny` in place
// of the stream.

#include "walk_lane.cuh"

namespace {

template <int ROW_WIN, int DIAG_WIN, int STAGE>
void walk_lanes(const WalkTables& t, const int* row, const int* qoff,
                const int* qs, const int* ss, const int* rl, const int* thr,
                const int* seg_end, const int* pos0, const int* lq0,
                const int* ls0, const int* ll0, int lb, int max_iters,
                int max_events, int chase, int unroll, const WalkEvents& ev,
                int* pos, int* lq, int* ls, int* ll, unsigned char* fin) {
  int stage[3 * STAGE];
  for (int lane = 0; lane < lb; ++lane) {
    WalkLane w{row[lane], qoff[lane], qs[lane], ss[lane], rl[lane],
               thr[lane], seg_end[lane], pos0[lane], lq0[lane], ls0[lane],
               ll0[lane], false};
    const int it = walk_lane<ROW_WIN, DIAG_WIN, STAGE, 1>(
        t, lane, w, max_iters, max_events, chase, unroll, ev, stage, 0);
    pos[lane] = w.pos;
    lq[lane] = w.lq;
    ls[lane] = w.ls;
    ll[lane] = w.ll;
    fin[lane] = w.fin ? 1 : 0;
    if (it > ev.count[1]) ev.count[1] = it;
  }
}

}  // namespace

extern "C" int andix_chain_walk_flat_cpu(
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
    int tiny) {
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
  if (tiny)
    walk_lanes<4, 8, 3>(t, row, qoff, qs, ss, rl, thr, seg_end, pos0, lq0,
                        ls0, ll0, lb, max_iters, max_events, chase, unroll,
                        ev, pos, lq, ls, ll, fin);
  else
    walk_lanes<WALK_ROW_WIN, WALK_DIAG_WIN, WALK_STAGE>(
        t, row, qoff, qs, ss, rl, thr, seg_end, pos0, lq0, ls0, ll0, lb,
        max_iters, max_events, chase, unroll, ev, pos, lq, ls, ll, fin);
  return 0;
}

// The LCE of each pair (a[i], b[i]), taken in order through one lane's
// diagonal window as the walk takes its lucky checks (a pair on the
// diagonal of the one before it may be answered from the window's mask),
// into lce_window, and by ISA + range-min into lce_rm.
extern "C" int andix_walk_lce_cpu(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, int npairs, const int* a,
    const int* b, int* lce_window, int* lce_rm, int tiny) {
  int rows[8] = {0};  // a one-row table: the window refills read it
  WalkTables t;
  t.isa = isa;
  t.text = text;
  t.n = n;
  t.rm = RangeMinView{rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
                      rm_suffg, rm_tg, nf, ng, lg};
  t.mlun = rows;
  t.ps = rows;
  t.qb = 8;
  const WalkLane w{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, false};
  int stage[3 * WALK_STAGE];
  WalkWindows<4, 8, 3, 1> small(t, w, stage, 0);
  WalkWindows<WALK_ROW_WIN, WALK_DIAG_WIN, WALK_STAGE, 1> full(t, w, stage,
                                                                0);
  for (int i = 0; i < npairs; ++i) {
    lce_window[i] = tiny ? small.lce(a[i], b[i], 0) : full.lce(a[i], b[i], 0);
    lce_rm[i] = walk_lce(t, a[i], b[i]);
  }
  return 0;
}
