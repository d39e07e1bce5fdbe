// Host twin of evpack.cu: the same event bodies (evpack_lane.cuh) run
// block after block by one caller, built with g++, so the kernels' logic
// is tested on machines without a card.  `tiny` != 0 takes blocks of 4
// pairs, so escapes cross many blocks; 0 the kernel's EVPACK_PAIRS.  The
// C interface is the kernels' entry's without the scratch, with `tiny` in
// place of the stream.

#include <vector>

#include "evpack_lane.cuh"

extern "C" int andix_evpack_encode_cpu(const int* lane_s,
                                       const long long* order, const int* q,
                                       const int* s, const int* len,
                                       long long cnt, long long k,
                                       int n_lanes, int esc_cap, int* out,
                                       int tiny) {
  if (k <= 0) return 0;
  const long long kh = (k + 1) / 2;
  const long long pairs = tiny ? 4 : EVPACK_PAIRS;
  const long long nb = (kh + pairs - 1) / pairs;
  int* esc = out + 3 * kh;
  int* counts = esc + 4LL * esc_cap;
  int* tail = counts + n_lanes;
  EvpackIn in{lane_s, order, q, s, len, cnt, k};
  std::vector<unsigned char> bits(kh);
  std::vector<int> block_esc(nb), block_off(nb);
  for (long long b = 0; b < nb; ++b) {  // the fields pass
    int n = 0;
    for (long long j = b * pairs; j < kh && j < (b + 1) * pairs; ++j) {
      bits[j] = (unsigned char)evpack_pair(in, j, kh, out);
      n += (bits[j] & 1) + (bits[j] >> 1);
    }
    block_esc[b] = n;
  }
  int n_esc = 0;  // the scan pass
  for (long long b = 0; b < nb; ++b) {
    block_off[b] = n_esc;
    n_esc += block_esc[b];
  }
  tail[0] = n_esc;
  tail[1] = n_esc > esc_cap ? 1 : 0;
  for (int l = 0; l < n_lanes; ++l)
    counts[l] = evpack_lane_count(lane_s, cnt, l);
  for (int x = n_esc < esc_cap ? n_esc : esc_cap; x < esc_cap; ++x)
    for (int r = 0; r < 4; ++r) esc[(long long)r * esc_cap + x] = 0;
  for (long long b = 0; b < nb; ++b) {  // the escapes pass
    if (!block_esc[b]) continue;
    long long slot = block_off[b];
    for (long long j = b * pairs; j < kh && j < (b + 1) * pairs; ++j) {
      if (!bits[j]) continue;
      evpack_escapes(in, j, bits[j], slot, esc_cap, esc);
      slot += (bits[j] & 1) + (bits[j] >> 1);
    }
  }
  return 0;
}
