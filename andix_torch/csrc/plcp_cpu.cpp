// Host twin of plcp.cu: the same per-entry bodies (plcp_lane.cuh) run entry
// after entry, built with g++, so the kernels' logic is tested on machines
// without a card.  Same C interface as the kernels' entry, without the
// stream.

#include "plcp_lane.cuh"

extern "C" int andix_plcp_hybrid_cpu(const int32_t* sym, const int32_t* sa,
                                     const int32_t* const* rows, int L,
                                     int lev_cnt, int base, long long n,
                                     int64_t* w16, int32_t* sphi, int32_t* S,
                                     int* counters, int32_t* lcp) {
  for (int64_t i = 0; i < n; ++i) w16[i] = plcp_word(sym, n, i);
  for (int64_t t = 0; t < n; ++t)
    if ((sa[t] & 15) == 0) sphi[sa[t] >> 4] = t > 0 ? sa[t - 1] : -1;
  const PlcpView v{w16, rows, n, L, lev_cnt, base};
  for (int64_t j = 0; j < n / 16; ++j) {
    bool open;
    S[j] = plcp_sample(v, sphi[j], j, &open);
    counters[0] += open;
  }
  for (int64_t t = 0; t < n; ++t) {
    bool open;
    lcp[t] = plcp_fill(v, sa, S, t, &open);
    counters[1] += open;
  }
  return 0;
}
