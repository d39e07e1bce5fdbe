// Host twin of doubling.cu: the same key and rerank bodies
// (doubling_tile.cuh), built with g++, the rerank's tiles run one after
// another in counter order, so the kernels' logic is tested on machines
// without a card.  `tiny` != 0 uses tiles of 64 entries instead of the
// kernel's 2048, and then only every 37th tile publishes an inclusive
// prefix (the others their aggregate alone), so a look-back folds across
// aggregates and across its windows of 32 tiles.

#include <vector>

#include "doubling_tile.cuh"

namespace {

constexpr long long KERNEL_TILE = 256 * 8;  // doubling.cu's THREADS * ITEMS
constexpr long long TINY_TILE = 64;
constexpr long long TINY_INCLUSIVE_EVERY = 37;

}  // namespace

// Same arguments as andix_sa_keys, without the stream.
extern "C" int andix_sa_keys_cpu(int mode, const int* src,
                                 const int* sa_vals, long long m, long long n,
                                 long long k, int base, long long* key,
                                 int* vals) {
  for (long long j = 0; j < m; ++j) {
    if (mode <= SD_KEY_WIDE) {
      int w[12];
      for (int x = 0; x < 12; ++x)
        w[x] = j + x < n ? sd_window_value(mode, src[j + x], base) : 0;
      key[j] = sd_initial_key(mode, w, src[j], j, base);
      vals[j] = (int)j;
    } else {
      const int i = mode == SD_KEY_TAIL ? sa_vals[j] : (int)j;
      key[j] = sd_round_key(src, i, n, k);
      vals[j] = i;
    }
  }
  return 0;
}

// Same arguments as andix_sa_rerank, with `tiny` in place of the scratch
// and the stream.
extern "C" int andix_sa_rerank_cpu(int mode, long long m,
                                   const long long* keys, const int* order,
                                   const int* slots, int* rank, int* sa,
                                   int* slots_out, int* savals_out,
                                   int* tied_out, int tiny) {
  *tied_out = 0;
  if (m <= 0) return 0;
  const long long tile = tiny ? TINY_TILE : KERNEL_TILE;
  const long long tiles = sd_tiles(m, tile);
  std::vector<int> scratch(sd_scratch_ints(tiles), 0);
  const SdScratch sc = sd_scratch(scratch.data(), tiles);
  const SdArgs a{mode, m,  keys,      order,      slots,
                 rank, sa, slots_out, savals_out, tied_out};
  std::vector<SdState> loc(tile);
  std::vector<int> tied(tile), val(tile);
  for (long long done = 0; done < tiles; ++done) {
    const long long t = (*sc.counter)++;
    const long long p0 = t * tile;
    const long long p1 = p0 + tile < m ? p0 + tile : m;
    SdState agg = sd_identity();
    for (long long p = p0; p < p1; ++p) {
      const long long kp = p > 0 ? sd_key_at(a, p - 1) : 0;
      const long long kn = p + 1 < m ? sd_key_at(a, p + 1) : 0;
      val[p - p0] = sd_val_at(a, p);
      agg = sd_combine(agg, sd_entry(p, m, kp, sd_key_at(a, p), kn,
                                     val[p - p0], &tied[p - p0]));
      loc[p - p0] = agg;
    }
    const bool incl = !tiny || t % TINY_INCLUSIVE_EVERY == 0;
    SdState prefix = sd_identity();
    if (t == 0 && incl) {
      sd_publish(sc, 0, agg, SD_INCLUSIVE);
    } else {
      sd_publish(sc, t, agg, SD_AGGREGATE);
      if (t > 0) prefix = sd_lookback(sc, t, 0);
      if (incl) sd_publish(sc, t, sd_combine(prefix, agg), SD_INCLUSIVE);
    }
    if (t == tiles - 1) *tied_out = sd_combine(prefix, agg).tied;
    for (long long p = p0; p < p1; ++p) {
      const SdState st = sd_combine(prefix, loc[p - p0]);
      const int td = tied[p - p0];
      sd_emit(a, p, st.head, st.tied - td, td, val[p - p0]);
    }
  }
  return 0;
}
