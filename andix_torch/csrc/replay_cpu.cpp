// Host twin of replay.cu: the same two passes (replay_lane.cuh) with one
// thread, built with g++ and run sublane after sublane, then lane after
// lane, so the kernels' logic and the splice are tested on machines
// without a card.  `tiny` != 0 runs them with tiny windows (4 row entries,
// 8 diagonal pairs), so every test case crosses their boundaries many
// times; 0 with the kernels'.  The C interface is the two kernel entries'
// in one call, with `tiny` in place of the stream.

#include "replay_lane.cuh"

namespace {

// a walker's counts: its 16 columns with the fast-mode equal counts
void fold_cells(const int* hist, const ReplayCounter<1>& cnt, int* out) {
  for (int c = 0; c < 16; ++c) out[c] = hist[c];
  for (int c = 0; c < 16; c += 5) out[c] += cnt.diag_quarters;
  out[15] += cnt.tt_rest;
}

template <int ROW_WIN, int DIAG_WIN>
void replay_lanes(const WalkTables& t, const int* ss, const int* rl,
                  const int* thr, const int* q_base, const int* q_start,
                  const int* q_len, int sg, int g, int k, int m, int exact,
                  int chase, int* ws, int* counts, int* stats, int* splice,
                  int* err) {
  const int stride = replay_seg_ints(m);
  auto lane_of = [&](int lane) {
    const int kk = lane / g, q = lane % g;
    return ReplayLane{kk, q_base[q], q_start[q], ss[kk], rl[kk], thr[kk],
                      q_len[lane]};
  };
  for (long long sub = 0; sub < (long long)sg * g * k; ++sub) {  // pass 1
    const int lane = (int)(sub / k), j = (int)(sub % k);
    const ReplayLane r = lane_of(lane);
    int start, end;
    replay_segment(r.qlen, k, j, start, end);
    if (r.qlen <= 0 || start >= end) continue;
    int hist[16] = {0};
    ReplayCounter<1> cnt{t.text, t.n, hist, 0, err};
    int* seg = ws + sub * stride;
    replay_cold<ROW_WIN, DIAG_WIN, 1>(t, r, k, j, m, exact != 0, chase, cnt,
                                      seg);
    fold_cells(hist, cnt, seg + REPLAY_SEG_CELLS);
    seg[REPLAY_SEG_GAP] = cnt.gap_sites;
    seg[REPLAY_SEG_EQ] = cnt.eq_sites;
  }
  for (int lane = 0; lane < sg * g; ++lane) {  // pass 2
    const ReplayLane r = lane_of(lane);
    if (r.qlen <= 0) continue;
    int hist[16] = {0};
    ReplayCounter<1> cnt{t.text, t.n, hist, 0, err};
    const int probes = replay_splice<ROW_WIN, DIAG_WIN, 1>(
        t, r, k, m, ws + (long long)lane * k * stride, exact != 0, chase,
        cnt, splice + (long long)lane * REPLAY_SPLICE);
    fold_cells(hist, cnt, counts + (long long)lane * 16);
    stats[lane * REPLAY_STATS] = probes;
    stats[lane * REPLAY_STATS + 1] = cnt.gap_sites;
    stats[lane * REPLAY_STATS + 2] = cnt.eq_sites;
  }
}

}  // namespace

extern "C" int andix_replay_seg_ints_cpu(int m) { return replay_seg_ints(m); }

// The exact-mode equal count of text[b, b + len) (ReplayCounter::equal,
// one thread) into out [16]; returns the sites counted.
extern "C" int andix_replay_equal_cpu(const unsigned char* text,
                                      long long n, long long b, int len,
                                      int* out) {
  int hist[16] = {0};
  int err = 0;
  ReplayCounter<1> cnt{text, n, hist, 0, &err};
  cnt.equal(b, len, true);
  for (int c = 0; c < 16; ++c) out[c] = hist[c];
  return err ? -1 : cnt.eq_sites;
}

extern "C" int andix_replay_rows_cpu(
    const int* isa, const unsigned char* text, long long n,
    const int* rm_values, const int* rm_pref8, const int* rm_suff8,
    const int* rm_t8, const int* rm_prefg, const int* rm_suffg,
    const int* rm_tg, int nf, int ng, int lg, const int* mlun,
    const int* ps, long long qb, const int* ss, const int* rl,
    const int* thr, const int* q_base, const int* q_start,
    const int* q_len, int sg, int g, int k, int m, int exact, int chase,
    int* ws, int* counts, int* stats, int* splice, int* err, int tiny) {
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
    replay_lanes<4, 8>(t, ss, rl, thr, q_base, q_start, q_len, sg, g, k, m,
                       exact, chase, ws, counts, stats, splice, err);
  else
    replay_lanes<WALK_ROW_WIN, WALK_DIAG_WIN>(t, ss, rl, thr, q_base,
                                              q_start, q_len, sg, g, k, m,
                                              exact, chase, ws, counts,
                                              stats, splice, err);
  return 0;
}
