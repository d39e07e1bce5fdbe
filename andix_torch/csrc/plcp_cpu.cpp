// Host twin of plcp.cu: the same per-entry bodies (plcp_lane.cuh) run entry
// after entry, built with g++, so the kernels' logic is tested on machines
// without a card.  Same C interface as the kernels' entry, without the
// stream; the caller picks `chain` and `tries`, the kernel's or tiny ones.

#include "plcp_lane.cuh"

// the pack launch: text words and, where sa is given, the samples' partners
extern "C" void andix_plcp_pack_cpu(const int32_t* sym, const int32_t* sa,
                                    long long n, uint64_t* text,
                                    int32_t* sphi) {
  const int64_t ns = n / 16;
  for (int64_t k = 0; k < ns; ++k) {
    text[k] = plcp_pack16(sym + 16 * k);
    if (!sa) continue;
    int32_t prev = k > 0 ? sa[16 * k - 1] : -1;
    for (int c = 0; c < 16; ++c) {
      const int32_t i = sa[16 * k + c];
      if ((i & 15) == 0) sphi[i >> 4] = prev;
      prev = i;
    }
  }
  for (int c = 0; c < PLCP_TEXT_PAD; ++c) text[ns + c] = 0;
}

// what a probe reads at every position: out[p] = plcp_read(p), p < n
extern "C" void andix_plcp_read_cpu(const uint64_t* text, long long n,
                                    int64_t* out) {
  const PlcpView v{text, nullptr, n, 0, 0, 0};
  for (int64_t p = 0; p < n; ++p) out[p] = plcp_read(v, p);
}

extern "C" int andix_plcp_hybrid_cpu(const int32_t* sym, const int32_t* sa,
                                     const int32_t* const* rows, int L,
                                     int lev_cnt, int base, long long n,
                                     int chain, int tries, uint64_t* text,
                                     int32_t* sphi, int32_t* S,
                                     int* counters, int32_t* lcp) {
  const int64_t ns = n / 16;
  andix_plcp_pack_cpu(sym, sa, n, text, sphi);
  const PlcpView v{text, rows, n, L, lev_cnt, base};
  for (int64_t j0 = 0; j0 < ns; j0 += chain)
    plcp_run(v, sphi, j0, j0 + chain < ns ? j0 + chain : ns, tries, S);
  for (int64_t j = 0; j < ns; ++j) {
    bool open;
    counters[2] += plcp_settle(v, sphi, j, S, &open);
    counters[0] += open;
  }
  if (n > 0) lcp[0] = 0;
  for (int64_t t = 1; t < n; ++t) {
    bool open;
    lcp[t] = plcp_fill(v, sa[t], sa[t - 1], S, &open);
    counters[1] += open;
  }
  return 0;
}
