// Host twin of replay.cu: the same lane body (replay_lane.cuh) with one
// thread per lane, built with g++ and run lane after lane, so the
// kernel's logic is tested on machines without a card.  `tiny` != 0 runs
// it with tiny windows (4 row entries, 8 diagonal pairs), so every test
// case crosses their boundaries many times; 0 with the kernel's.  Same C
// interface as the kernel's entry, with `tiny` in place of the stream.

#include "replay_lane.cuh"

namespace {

template <int ROW_WIN, int DIAG_WIN>
void replay_lanes(const WalkTables& t, const int* ss, const int* rl,
                  const int* thr, const int* q_base, const int* q_start,
                  const int* q_len, int sg, int g, int exact, int chase,
                  int* counts, int* stats, int* err) {
  for (int lane = 0; lane < sg * g; ++lane) {
    const int k = lane / g, q = lane % g;
    const ReplayLane r{k, q_base[q], q_start[q], ss[k], rl[k], thr[k],
                       q_len[lane]};
    if (r.qlen <= 0) continue;
    int hist[16] = {0};
    ReplayCounter<1> cnt{t.text, t.n, hist, 0, err};
    const int probes = replay_lane<ROW_WIN, DIAG_WIN, 1>(t, r, exact != 0,
                                                         chase, cnt);
    for (int c = 0; c < 16; c += 5) hist[c] += cnt.diag_quarters;
    hist[15] += cnt.tt_rest;
    for (int c = 0; c < 16; ++c) counts[(long long)lane * 16 + c] = hist[c];
    stats[lane * REPLAY_STATS] = probes;
    stats[lane * REPLAY_STATS + 1] = cnt.gap_sites;
    stats[lane * REPLAY_STATS + 2] = cnt.eq_sites;
  }
}

}  // namespace

extern "C" int andix_replay_rows_cpu(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* ss, const int* rl,
    const int* thr, const int* q_base, const int* q_start,
    const int* q_len, int sg, int g, int exact, int chase, int* counts,
    int* stats, int* err, int tiny) {
  WalkTables t;
  t.isa = isa;
  t.text = text;
  t.n = n;
  t.rm = RangeMinView{rm_values, rm_pref8, rm_suff8, rm_t8, rm_prefg,
                      rm_suffg, rm_tg, nf, ng, lg};
  t.mlun = mlun;
  t.ps = ps;
  t.qb = qb;
  if (tiny)
    replay_lanes<4, 8>(t, ss, rl, thr, q_base, q_start, q_len, sg, g, exact,
                       chase, counts, stats, err);
  else
    replay_lanes<WALK_ROW_WIN, WALK_DIAG_WIN>(t, ss, rl, thr, q_base,
                                              q_start, q_len, sg, g, exact,
                                              chase, counts, stats, err);
  return 0;
}
