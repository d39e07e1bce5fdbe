// Host twin of flag_scan.cu: the same tile body and look-back
// (flag_scan_tile.cuh), built with g++, the tiles run one after another in
// counter order, so the kernel's logic is tested on machines without a
// card.  `tiny` != 0 uses tiles of 4 chunks (64 positions) instead of the
// kernel's 256 chunks; `agg_only`, when not null, marks tiles (by id) that
// publish only their aggregate, never an inclusive prefix, so a later
// tile's look-back has to fold across them.

#include <vector>

#include "flag_scan_tile.cuh"

namespace {

constexpr int KERNEL_THREADS = 256;  // flag_scan.cu's block
constexpr int TINY_THREADS = 4;

template <bool REV>
void scan_tiles(const FsArgs& a, const FsOut& o, const FsScratch& sc,
                long long tiles, int threads, const unsigned char* agg_only) {
  const long long tile = (long long)threads * FS_ITEMS;
  std::vector<FsChunk> chunk(threads);
  std::vector<FS> excl(threads);
  for (long long n_done = 0; n_done < tiles; ++n_done) {
    const long long t = (*sc.counter)++;
    FS agg = fs_identity();
    for (int th = 0; th < threads; ++th) {
      fs_load_chunk<REV>(a, t * tile + th * FS_ITEMS, chunk[th]);
      excl[th] = agg;
      agg = fs_combine(agg, fs_fold<REV>(chunk[th]));
    }
    const bool only = agg_only != nullptr && agg_only[t] != 0;
    FS prefix = fs_identity();
    if (t == 0 && !only) {
      fs_publish(sc, 0, agg, FS_INCLUSIVE);
    } else {
      fs_publish(sc, t, agg, FS_AGGREGATE);
      if (t > 0) prefix = fs_lookback(sc, t, 0);
      if (!only) fs_publish(sc, t, fs_combine(prefix, agg), FS_INCLUSIVE);
    }
    for (int th = 0; th < threads; ++th) {
      fs_emit<REV>(a, o, t * tile + th * FS_ITEMS,
                   fs_combine(prefix, excl[th]), chunk[th]);
    }
  }
}

}  // namespace

extern "C" long long andix_flag_scan_cpu_tiles(long long n, int reverse,
                                               int tiny) {
  const int threads = tiny ? TINY_THREADS : KERNEL_THREADS;
  return fs_tiles(n, reverse, (long long)threads * FS_ITEMS);
}

// Same arguments as andix_flag_scan, with agg_only and tiny in place of
// the scratch and the stream; status_out receives each tile's final
// status word.
extern "C" int andix_flag_scan_cpu(const int* values,
                                   const unsigned char* flags,
                                   const int* sa_vals, long long n,
                                   int reverse, const unsigned char* agg_only,
                                   int tiny, int* out_k, int* out_g,
                                   int* out_sa, int* out_suf,
                                   int* status_out) {
  if (n <= 0) return 0;
  const int threads = tiny ? TINY_THREADS : KERNEL_THREADS;
  const long long tiles = andix_flag_scan_cpu_tiles(n, reverse, tiny);
  std::vector<int> scratch(fs_scratch_ints(tiles), 0);
  const FsScratch sc = fs_scratch(scratch.data(), tiles);
  const FsArgs a{values, flags, sa_vals, n, n + fs_pad(n, reverse)};
  const FsOut o{out_k, out_g, out_sa, out_suf};
  if (reverse)
    scan_tiles<true>(a, o, sc, tiles, threads, agg_only);
  else
    scan_tiles<false>(a, o, sc, tiles, threads, agg_only);
  for (long long t = 0; t < tiles; ++t) status_out[t] = sc.status[t];
  return 0;
}
