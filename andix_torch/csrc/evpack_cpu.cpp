// Host twin of evpack.cu: a stable sort of the live slots by lane in place
// of the library's, and the encode pass over the same event bodies and
// look-back (evpack_lane.cuh), built with g++, so the kernels' logic is
// tested on machines without a card.
//
// The encode's tiles run in a shuffled order (`seed`), in two sweeps that
// stand for blocks racing on the card: in the first every tile encodes
// its pairs, adds its lane counts and publishes its escape count (tile 0
// its inclusive count); in the second, in another shuffled order, every
// other tile looks back over whatever its predecessors have published by
// then (aggregates and inclusive counts mixed), publishes its inclusive
// count and writes its escapes.  `tiny` != 0 takes tiles of 4 pairs
// instead of the kernel's EVPACK_TILE_PAIRS, so escapes and lane runs
// cross many tiles, and then only every 7th tile publishes its inclusive
// count, so a look-back folds long runs of aggregates across its windows
// of 32 tiles.  The C interface is the kernels' entry's without the
// scratch, with `tiny` and `seed` in place of the stream.

#include <algorithm>
#include <numeric>
#include <random>
#include <vector>

#include "evpack_lane.cuh"

namespace {

constexpr long long TINY_TILE_PAIRS = 4;
constexpr long long TINY_INCLUSIVE_EVERY = 7;

std::vector<long long> shuffled(long long count, std::mt19937& rng) {
  std::vector<long long> idx(count);
  std::iota(idx.begin(), idx.end(), 0);
  std::shuffle(idx.begin(), idx.end(), rng);
  return idx;
}

}  // namespace

extern "C" int andix_evpack_encode_cpu(const int* lane, const int* q,
                                       const int* s, const int* len,
                                       long long cnt, long long k,
                                       int n_lanes, int esc_cap, int* out,
                                       int tiny, int seed) {
  if (k <= 0) return 0;
  const long long kh = (k + 1) / 2, m = 2 * kh;
  int* esc = out + 3 * kh;
  int* counts = esc + 4LL * esc_cap;
  int* tail = counts + n_lanes;
  std::fill(esc, tail, 0);
  // the live slots, stably sorted by lane
  std::vector<int> slot(cnt);
  std::iota(slot.begin(), slot.end(), 0);
  std::stable_sort(slot.begin(), slot.end(),
                   [&](int a, int b) { return lane[a] < lane[b]; });
  std::vector<EvpackSlot> x(m, EvpackSlot{0, 0, 0, 0});
  for (long long i = 0; i < cnt; ++i) {
    const int j = slot[i];
    x[i] = {lane[j], q[j], s[j], len[j]};
  }
  auto event = [&](long long i) {
    return evpack_event(i < cnt, x[i], i > 0, i > 0 ? x[i - 1] : x[i]);
  };
  // the encode pass
  const long long tile = tiny ? TINY_TILE_PAIRS : EVPACK_TILE_PAIRS;
  const long long tiles = evpack_tiles(kh, tile);
  std::vector<int> scratch(evpack_scratch_ints(tiles), 0);
  const EvpackScratch sc = evpack_scratch(scratch.data(), tiles);
  std::vector<int> agg(tiles, 0);
  std::mt19937 rng((unsigned)seed);
  for (long long t : shuffled(tiles, rng)) {
    for (long long j = t * tile; j < kh && j < (t + 1) * tile; ++j) {
      const EvpackEvent e0 = event(2 * j), e1 = event(2 * j + 1);
      evpack_store_pair(out, kh, j, e0, e1);
      for (long long i = 2 * j; i < 2 * j + 2; ++i)
        evpack_count(counts, i, cnt, x[i], i > 0, i > 0 ? x[i - 1] : x[i]);
      agg[t] += e0.esc + e1.esc;
    }
    evpack_publish(sc, t, agg[t], t ? EVPACK_AGGREGATE : EVPACK_INCLUSIVE);
  }
  for (long long t : shuffled(tiles, rng)) {
    int prefix = 0;
    if (t > 0) {
      prefix = evpack_lookback(sc, t, 0);
      if (prefix < 0) return 1;
      if (!tiny || t % TINY_INCLUSIVE_EVERY == 0)
        evpack_publish(sc, t, prefix + agg[t], EVPACK_INCLUSIVE);
    }
    if (t == tiles - 1) {
      tail[0] = prefix + agg[t];
      tail[1] = prefix + agg[t] > esc_cap ? 1 : 0;
    }
    long long slot_at = prefix;
    for (long long i = 2 * t * tile; i < m && i < 2 * (t + 1) * tile; ++i) {
      const EvpackEvent e = event(i);
      if (e.esc) evpack_store_escape(esc, esc_cap, slot_at++, i, e);
    }
  }
  return 0;
}
