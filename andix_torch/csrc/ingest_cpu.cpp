// Host twin of ingest.cu: the same tile bodies and look-back
// (ingest_tile.cuh), built with g++, the scan's tiles run one after
// another in counter order, so the kernels' logic is tested on machines
// without a card.  `tiny` != 0 uses tiles of 4 threads (256 bytes) instead
// of the kernel's 256 (16384 bytes); `agg_only`, when not null, marks tiles
// (by id) that publish only their aggregate, never an inclusive prefix, so
// a later tile's look-back has to fold across them.  Kept bytes are staged
// a tile at a time and copied out, as the kernel's shared memory does.

#include <vector>

#include "ingest_tile.cuh"

namespace {

constexpr int KERNEL_THREADS = 256;  // ingest.cu's block
constexpr int TINY_THREADS = 4;

}  // namespace

extern "C" long long andix_ingest_cpu_tiles(long long m, int tiny) {
  const long long tile =
      (long long)(tiny ? TINY_THREADS : KERNEL_THREADS) * IG_SPAN;
  return (m + tile - 1) / tile;
}

// Same outputs as andix_ingest (seq, rec, rs; starts and nfiles as
// there, on the host), with agg_only and tiny in place of the scratch and
// the stream; status_out receives each tile's final status word.
extern "C" int andix_ingest_cpu(const unsigned char* raw, long long m,
                                int cap, const unsigned char* agg_only,
                                int tiny, unsigned char* seq, int* rec,
                                unsigned char* rs, long long rs_cap,
                                const long long* starts, int nfiles,
                                int* status_out) {
  if (m <= 0) return 0;
  const int threads = tiny ? TINY_THREADS : KERNEL_THREADS;
  const long long tile = (long long)threads * IG_SPAN;
  const long long tiles = andix_ingest_cpu_tiles(m, tiny);
  std::vector<int> scratch(ig_scratch_ints(tiles), 0);
  const IgScratch sc = ig_scratch(scratch.data(), tiles);
  for (long long k = 0; k < (cap + 1LL) * IG_REC; ++k) rec[k] = 0;
  std::vector<IgChunk> chunk((std::size_t)threads * IG_CHUNKS);
  std::vector<IG> excl(threads);
  std::vector<unsigned char> stage(tile);
  for (long long done = 0; done < tiles; ++done) {
    const long long t = (*sc.counter)++;
    IG agg = ig_identity();
    for (int th = 0; th < threads; ++th) {
      IG own = ig_identity();
      for (int k = 0; k < IG_CHUNKS; ++k) {
        IgChunk& ch = chunk[th * IG_CHUNKS + k];
        ig_load_chunk(raw, m, t * tile + th * IG_SPAN + k * IG_ITEMS, ch);
        own = ig_fold(own, ch);
      }
      excl[th] = agg;
      agg = ig_combine(agg, own);
    }
    const bool only = agg_only != nullptr && agg_only[t] != 0;
    IG prefix = ig_identity();
    if (t == 0 && !only) {
      ig_publish(sc, 0, agg, IG_INCLUSIVE);
    } else {
      ig_publish(sc, t, agg, IG_AGGREGATE);
      if (t > 0) prefix = ig_lookback(sc, t, 0);
      if (!only) ig_publish(sc, t, ig_combine(prefix, agg), IG_INCLUSIVE);
    }
    const IgRun tile_run = ig_run(prefix);
    const IgOut o{stage.data(), tile_run.k, rec, cap};
    for (int th = 0; th < threads; ++th) {
      const long long i0 = t * tile + th * IG_SPAN;
      IgRun run = ig_run(ig_combine(prefix, excl[th]));
      for (int k = 0; k < IG_CHUNKS; ++k)
        run = ig_emit(run, chunk[th * IG_CHUNKS + k],
                      i0 + k * IG_ITEMS, o);
      if (i0 < m && m <= i0 + IG_SPAN) ig_totals(run, o);
    }
    const int kept = ig_run(ig_combine(prefix, agg)).k - tile_run.k;
    for (int j = 0; j < kept; ++j) seq[tile_run.k + j] = stage[j];
  }
  for (long long t = 0; t < tiles; ++t) status_out[t] = sc.status[t];

  // the RS pass, a chunk of 16 output bytes at a time
  const int nh = rec[(long long)cap * IG_REC];
  if (nh == 0 || nh > cap) return 0;
  const IgRecords r{rec, nh, rec[(long long)cap * IG_REC + 2]};
  const long long total = ig_rs_off(r, nh);
  const IgFiles fl{starts, nfiles};
  for (long long o0 = 0; o0 < total && o0 < rs_cap; o0 += IG_ITEMS) {
    if (nfiles > 0) {
      IgJoinCursor c = ig_join_seek(r, fl, o0);
      for (long long o = o0; o < o0 + IG_ITEMS && o < total; ++o)
        rs[o] = ig_join_byte(r, fl, seq, c, o);
    } else {
      IgRsCursor c = ig_rs_seek(r, o0);
      for (long long o = o0; o < o0 + IG_ITEMS && o < total; ++o)
        rs[o] = ig_rs_byte(r, seq, c, o);
    }
  }
  return 0;
}

// Same arguments as andix_block_text without the stream.
extern "C" int andix_block_text_cpu(const unsigned char* text, long long n,
                                    const long long* ends, int nseg,
                                    int pad_base, long long padded, int* sym,
                                    int* counts) {
  counts[0] = counts[1] = 0;
  for (long long i = 0; i < padded; ++i)
    sym[i] = ig_block_symbol(n, ends, nseg, pad_base, i, i < n ? text[i] : 0,
                             counts[0], counts[1]);
  return 0;
}
