// Host twin of doubling.cu: the same key and rerank bodies
// (doubling_tile.cuh), built with g++, the rerank's tiles run one after
// another in counter order, so the kernels' logic is tested on machines
// without a card.  `tiny` != 0 uses tiles of 64 entries instead of the
// kernel's 4096, and then only every 37th tile publishes an inclusive
// prefix (the others their aggregate alone), so a look-back folds across
// aggregates and across its windows of 32 tiles.
//
// `bin_order` (tests only) sets the order in which the partitioned scatter's
// pairs are binned and written: 0 as they come, 1 reversed, 2 shuffled
// (a fixed seed).  On the card that order is the atomics'; every rank
// entry is written once, so no order may change an output.

#include <algorithm>
#include <numeric>
#include <random>
#include <vector>

#include "doubling_tile.cuh"

namespace {

constexpr long long KERNEL_TILE = 512 * 8;  // doubling.cu's THREADS * ITEMS
constexpr long long TINY_TILE = 64;
constexpr long long TINY_INCLUSIVE_EVERY = 37;

// 0 .. count - 1 in the given order (as they come, reversed, shuffled)
std::vector<long long> ordered(long long count, int order, unsigned seed) {
  std::vector<long long> idx(count);
  std::iota(idx.begin(), idx.end(), 0);
  if (order == 1) std::reverse(idx.begin(), idx.end());
  if (order == 2) std::shuffle(idx.begin(), idx.end(), std::mt19937(seed));
  return idx;
}

}  // namespace

// Same arguments as andix_sa_keys, without the stream.
extern "C" int andix_sa_keys_cpu(int mode, const int* src,
                                 const int* sa_vals, const int* heads,
                                 long long m, long long n, long long k,
                                 int base, long long* key, int* vals,
                                 int* hist, int shift, int parts) {
  if (hist) std::fill(hist, hist + parts, 0);
  for (long long j = 0; j < m; ++j) {
    if (mode <= SD_KEY_WIDE) {
      int w[12];
      for (int x = 0; x < 12; ++x)
        w[x] = j + x < n ? sd_window_value(mode, src[j + x], base) : 0;
      key[j] = sd_initial_key(mode, w, src[j], j, base);
      vals[j] = (int)j;
    } else if (mode == SD_KEY_FULL) {
      key[j] = sd_round_key(src, j, n, k);
      vals[j] = (int)j;
    } else {
      const int i = sa_vals[j];
      key[j] = sd_tail_key(heads[j], src, i, n, k);
      vals[j] = i;
      if (hist) ++hist[sd_part(i, shift)];
    }
  }
  return 0;
}

// Same arguments as andix_sa_rerank, with `tiny` and `bin_order` in place of
// the scratch and the stream.
extern "C" int andix_sa_rerank_cpu(int mode, long long m,
                                   const long long* keys, const int* order,
                                   const int* slots, int* rank, int* sa,
                                   unsigned* bits, int* slots_out,
                                   int* savals_out, int* heads_out,
                                   int* tied_out, int* pairs, int shift,
                                   int parts, const int* hist, int tiny,
                                   int bin_order) {
  *tied_out = 0;
  if (m <= 0) return 0;
  if (!pairs) parts = 0;
  if (parts > SD_MAX_PARTS) return 1;
  const long long tile = tiny ? TINY_TILE : KERNEL_TILE;
  const long long tiles = sd_tiles(m, tile);
  std::vector<int> scratch(sd_scratch_ints(tiles, parts), 0);
  const SdScratch sc = sd_scratch(scratch.data(), tiles, parts);
  const SdArgs a{mode,      m,        keys,  order,     slots,
                 rank,      sa,       bits,  slots_out, savals_out,
                 heads_out, tied_out, pairs, shift,     parts,
                 hist};
  if (mode == SD_FULL) std::fill(bits, bits + (m + 31) / 32, 0u);
  std::vector<long long> region(parts);  // a tail round's regions
  for (int p = 1; p < parts && mode == SD_TAIL; ++p)
    region[p] = region[p - 1] + hist[p - 1];
  std::vector<SdState> loc(tile);
  std::vector<int> tied(tile), val(tile), dst(tile), head(tile);
  std::vector<int> count(parts), start(parts);
  for (long long done = 0; done < tiles; ++done) {
    const long long t = (*sc.counter)++;
    const long long p0 = t * tile;
    const long long p1 = p0 + tile < m ? p0 + tile : m;
    SdState agg = sd_identity();
    for (long long p = p0; p < p1; ++p) {
      bool changed, next;
      if (mode == SD_EXTRACT) {
        changed = sd_bit(bits, p);
        next = p + 1 < m ? sd_bit(bits, p + 1) : true;
      } else {
        changed = p == 0 || keys[p] != keys[p - 1];
        next = p + 1 < m ? keys[p + 1] != keys[p] : true;
      }
      if (mode == SD_FULL && (changed || p == 0))
        bits[p >> 5] |= 1u << (p & 31);
      val[p - p0] = sd_val_at(a, p);
      agg = sd_combine(agg, sd_entry(p, m, changed, next, val[p - p0],
                                     &tied[p - p0]));
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
      head[p - p0] = st.head;
      dst[p - p0] = sd_emit(a, p, st.head, st.tied - td, td, val[p - p0],
                            mode == SD_EXTRACT ? -1 : order[p]);
    }
    if (!pairs) {
      for (long long p = p0; p < p1; ++p)
        if (dst[p - p0] >= 0) rank[dst[p - p0]] = head[p - p0];
      continue;
    }
    // bin the tile's pairs: each part's run at the offset its cursor gives
    std::fill(count.begin(), count.end(), 0);
    for (long long p = p0; p < p1; ++p) ++count[sd_part(dst[p - p0], shift)];
    for (int q = 0; q < parts; ++q) {
      start[q] = sc.cursor[q];
      sc.cursor[q] += count[q];
    }
    for (long long i : ordered(p1 - p0, bin_order, (unsigned)t)) {
      const int q = sd_part(dst[i], shift);
      const long long slot = sd_region(a, q, region[q]) + start[q]++;
      pairs[2 * slot] = dst[i];
      pairs[2 * slot + 1] = head[i];
    }
  }
  return 0;
}

// Same arguments as andix_sa_pair_scatter, with `bin_order` in place of the
// stream.
extern "C" int andix_sa_pair_scatter_cpu(const int* pairs, long long m,
                                         int* rank, int bin_order) {
  for (long long i : ordered(m, bin_order, 7u)) rank[pairs[2 * i]] =
      pairs[2 * i + 1];
  return 0;
}
