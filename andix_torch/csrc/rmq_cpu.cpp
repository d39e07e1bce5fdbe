// Host twin of rmq.cu: the same tile bodies (rmq_tile.cuh) run tile after
// tile by one caller, built with g++, so the kernels' logic is tested on
// machines without a card.  `tiny` != 0 runs it with tiles of one group
// (64 fine blocks) in the fine pass and 8 fine blocks in the t8 pass, so
// the t8 windows cross many tiles; 0 with the kernel's 256 and 256.  Same
// C interface as the kernels' entry, with `tiny` in place of the stream.

#include <vector>

#include "rmq_tile.cuh"

extern "C" int andix_range_min_build_cpu(const int* v, long long np,
                                         int* pref8, int* suff8, int* t8,
                                         int* prefg, int* suffg, int* tg,
                                         int lg, int tiny) {
  if (np <= 0) return 0;
  const int nf = (int)(np / RMQ_FINE);
  const int ng = nf / RMQ_GROUP;
  const int fine_tile = tiny ? RMQ_GROUP : 256;
  const int t8_tile = tiny ? 8 : 256;
  std::vector<int> pa(fine_tile), pb(fine_tile), sa(fine_tile),
      sb(fine_tile);
  for (int f0 = 0; f0 < nf; f0 += fine_tile) {
    const int nt = nf - f0 < fine_tile ? nf - f0 : fine_tile;
    for (int x = 0; x < nt; ++x) {
      const long long e = (long long)(f0 + x) * RMQ_FINE;
      const int m = rmq_fine_block(v + e, pref8 + e, suff8 + e);
      t8[f0 + x] = m;
      pa[x] = m;
      sa[x] = m;
    }
    rmq_group_scan(pa.data(), pb.data(), nt, false, 0, 1);
    rmq_group_scan(sa.data(), sb.data(), nt, true, 0, 1);
    for (int x = 0; x < nt; ++x) {
      prefg[f0 + x] = pa[x];
      suffg[f0 + x] = sa[x];
      if ((x & (RMQ_GROUP - 1)) == 0) tg[(f0 + x) / RMQ_GROUP] = sa[x];
    }
  }
  std::vector<int> a(t8_tile + RMQ_GROUP), b(t8_tile + RMQ_GROUP);
  for (int c0 = 0; c0 < nf; c0 += t8_tile) {
    const int nt = nf - c0 < t8_tile ? nf - c0 : t8_tile;
    for (int x = 0; x < nt + RMQ_GROUP; ++x)
      a[x] = c0 + x < nf ? t8[c0 + x] : RMQ_INF;
    rmq_t8_tile(a.data(), b.data(), nt, c0, nf, t8, 0, 1);
  }
  for (int k = 1, span = 1; k < lg; ++k, span *= 2)
    for (int g = 0; g < ng; ++g)
      tg[(long long)k * ng + g] =
          rmq_tg_entry(tg + (long long)(k - 1) * ng, ng, span, g);
  return 0;
}
