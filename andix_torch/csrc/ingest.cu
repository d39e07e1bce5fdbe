// Genome texts on the card: the FASTA ingest and the joint block's padded
// symbols.
//
// Replaces no TPU kernel.  andix parses, normalizes and reverse-
// complements on the host (fasta.FastaStream, sequence.normalize,
// sequence.catcomp) and widens each joint block to int32 there
// (BlockLayout.sym, backend.pad_symbols) before a pageable copy of 4 bytes
// a symbol; in the port that host work held the card idle for most of a
// matrix.  These kernels do it on the card from the files' raw bytes
// (ingest_tile.cuh defines what they compute):
//
// ingest_scan_kernel: one pass with a decoupled look-back over the raw
//   bytes (tiles of 16384, a thread 64 bytes from four 16-byte loads, all
//   issued before any is used; a tile's fixed costs, its look-back among
//   them, are what a byte costs here, so tiles are large).  Each thread
//   folds its bytes into the IG state, a warp scan by shuffles and
//   one pass over the 8 warp states give its prefix in the tile, the first
//   warp folds the predecessors' published states (ig_lookback), and each
//   thread re-scans its bytes from its exact prefix: kept bytes go
//   upper-cased to a staging buffer in shared memory at their offset in
//   the tile, record rows (header position, header line end, the counts
//   before it) straight to the table; the tile's kept bytes then leave in
//   coalesced stores.
// ingest_rs_kernel: every record's revcomp + '#' + forward + 0, a thread
//   16 output bytes (one binary search over the record table, then a
//   cursor that crosses record edges), stored 16 bytes at a time.  It reads the table
//   and its totals on the card, so both launch back to back.
// ingest_join_rs_kernel: in join mode (-j) in its place, each file's
//   records joined by '!' as one RS, in the bytes its records' RS take
//   otherwise (a thread 16 output bytes: binary searches for the file
//   and the record of its first byte, then a cursor that steps records
//   down on the reverse strand and up on the forward one).
// block_text_kernel: the joint block's int32 symbols from its uint8 text,
//   a thread 16 positions (one 16-byte load, four 16-byte stores); a 0
//   byte looks its separator up in the sorted separator positions and
//   counts itself, so the host can check that the 0 bytes are exactly the
//   separators (the walk kernel takes a 0 byte for a unique symbol) with
//   one read.
//
// What bounds them: bytes.  The ingest reads the raw file bytes once and
// writes the kept bytes; the RS pass reads those and writes about twice as
// many; the block text reads n bytes and writes 4 B a padded position.
// Each reads its input once from device memory and writes each output byte
// once, in 16-byte stores where aligned.

#include <cuda_runtime.h>

#include "ingest_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long TILE = (long long)THREADS * IG_SPAN;
constexpr long long RS_TILE = (long long)THREADS * IG_ITEMS;

long long ig_tiles(long long m) { return (m + TILE - 1) / TILE; }

__global__ void __launch_bounds__(THREADS)
ingest_scan_kernel(const unsigned char* __restrict__ x, long long m,
                   IgScratch sc, unsigned char* __restrict__ seq, int* rec,
                   int cap) {
  __shared__ long long s_tile;
  __shared__ IG s_warp[WARPS];
  __shared__ IG s_prefix, s_agg;
  __shared__ __align__(16) unsigned char s_out[TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long i0 = t * TILE + (long long)threadIdx.x * IG_SPAN;

  IgChunk ch[IG_CHUNKS];
  if (i0 + IG_SPAN <= m) {
    uint4 v[IG_CHUNKS];
#pragma unroll
    for (int k = 0; k < IG_CHUNKS; ++k)
      v[k] = __ldg(reinterpret_cast<const uint4*>(x + i0) + k);
    const int before = i0 > 0 ? __ldg(x + i0 - 1) : '\n';
    const int after = i0 + IG_SPAN < m ? __ldg(x + i0 + IG_SPAN) : '\n';
#pragma unroll
    for (int k = 0; k < IG_CHUNKS; ++k) {
      ch[k].w[0] = v[k].x;
      ch[k].w[1] = v[k].y;
      ch[k].w[2] = v[k].z;
      ch[k].w[3] = v[k].w;
      ch[k].len = IG_ITEMS;
      ch[k].prev = k ? (int)(v[k - 1].w >> 24) : before;
      ch[k].next = k + 1 < IG_CHUNKS ? (int)(v[k + 1].x & 0xff) : after;
    }
  } else {
#pragma unroll
    for (int k = 0; k < IG_CHUNKS; ++k)
      ig_load_chunk(x, m, i0 + k * IG_ITEMS, ch[k]);
  }
  IG own = ig_identity();
#pragma unroll
  for (int k = 0; k < IG_CHUNKS; ++k) own = ig_fold(own, ch[k]);

  // warp inclusive scan of the thread states
  IG inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const IG y = ig_shfl_up(inc, d);
    if (lane >= d) inc = ig_combine(y, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  IG excl = ig_shfl_up(inc, 1);
  if (lane == 0) excl = ig_identity();
  __syncthreads();
  IG before = ig_identity();
  for (int w = 0; w < warp; ++w) before = ig_combine(before, s_warp[w]);
  excl = ig_combine(before, excl);

  if (warp == 0) {
    IG agg = ig_identity();
    for (int w = 0; w < WARPS; ++w) agg = ig_combine(agg, s_warp[w]);
    IG prefix = ig_identity();
    if (t == 0) {
      if (lane == 0) ig_publish(sc, 0, agg, IG_INCLUSIVE);
    } else {
      if (lane == 0) ig_publish(sc, t, agg, IG_AGGREGATE);
      prefix = ig_lookback(sc, t, lane);
      if (lane == 0) ig_publish(sc, t, ig_combine(prefix, agg), IG_INCLUSIVE);
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_agg = agg;
    }
  }
  __syncthreads();
  const IgRun tile_run = ig_run(s_prefix);
  const IgOut o{s_out, tile_run.k, rec, cap};
  IgRun run = ig_run(ig_combine(s_prefix, excl));
#pragma unroll
  for (int k = 0; k < IG_CHUNKS; ++k)
    run = ig_emit(run, ch[k], i0 + k * IG_ITEMS, o);
  if (i0 < m && m <= i0 + IG_SPAN) ig_totals(run, o);
  __syncthreads();
  const int kept = ig_run(ig_combine(s_prefix, s_agg)).k - tile_run.k;
  for (int j = threadIdx.x; j < kept; j += THREADS)
    seq[tile_run.k + j] = s_out[j];
}

// the chunk's 16 RS bytes w (fewer at the end) to rs + o0
__device__ __forceinline__ void ig_store_chunk(unsigned char* rs, long long o0,
                                               long long total,
                                               const unsigned* w) {
  if (o0 + IG_ITEMS <= total) {
    *reinterpret_cast<uint4*>(rs + o0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int j = 0; o0 + j < total; ++j)
      rs[o0 + j] = (unsigned char)(w[j >> 2] >> (8 * (j & 3)));
  }
}

__global__ void __launch_bounds__(THREADS)
ingest_rs_kernel(const unsigned char* __restrict__ seq,
                 const int* __restrict__ rec, int cap,
                 unsigned char* __restrict__ rs) {
  const int nh = rec[(long long)cap * IG_REC];
  if (nh == 0 || nh > cap) return;  // nothing, or the host runs again
  const IgRecords r{rec, nh, rec[(long long)cap * IG_REC + 2]};
  const long long total = ig_rs_off(r, nh);
  const long long o0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * IG_ITEMS;
  if (o0 >= total) return;
  IgRsCursor c = ig_rs_seek(r, o0);
  unsigned w[IG_ITEMS / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < IG_ITEMS; ++j) {
    const long long o = o0 + j;
    if (o < total)
      w[j >> 2] |= (unsigned)ig_rs_byte(r, seq, c, o) << (8 * (j & 3));
  }
  ig_store_chunk(rs, o0, total, w);
}

// ingest_rs_kernel in join mode: each file's records as one RS
__global__ void __launch_bounds__(THREADS)
ingest_join_rs_kernel(const unsigned char* __restrict__ seq,
                      const int* __restrict__ rec, int cap,
                      const long long* __restrict__ starts, int nfiles,
                      unsigned char* __restrict__ rs) {
  const int nh = rec[(long long)cap * IG_REC];
  if (nh == 0 || nh > cap) return;  // nothing, or the host runs again
  const IgRecords r{rec, nh, rec[(long long)cap * IG_REC + 2]};
  const IgFiles fl{starts, nfiles};
  const long long total = ig_rs_off(r, nh);
  const long long o0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * IG_ITEMS;
  if (o0 >= total) return;
  IgJoinCursor c = ig_join_seek(r, fl, o0);
  unsigned w[IG_ITEMS / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < IG_ITEMS; ++j) {
    const long long o = o0 + j;
    if (o < total)
      w[j >> 2] |= (unsigned)ig_join_byte(r, fl, seq, c, o) << (8 * (j & 3));
  }
  ig_store_chunk(rs, o0, total, w);
}

__global__ void __launch_bounds__(THREADS)
block_text_kernel(const unsigned char* __restrict__ text, long long n,
                  const long long* __restrict__ ends, int nseg, int pad_base,
                  long long padded, int* __restrict__ sym,
                  int* __restrict__ counts) {
  const long long i0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * IG_ITEMS;
  if (i0 >= padded) return;
  int v[IG_ITEMS];
  int zeros = 0, stray = 0;
  if (i0 + IG_ITEMS <= n) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(text + i0));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < IG_ITEMS; ++j) {
      const int b = (w[j >> 2] >> (8 * (j & 3))) & 0xff;
      v[j] = b ? b
               : ig_block_symbol(n, ends, nseg, pad_base, i0 + j, 0, zeros,
                                 stray);
    }
  } else {
#pragma unroll
    for (int j = 0; j < IG_ITEMS; ++j) {
      const long long i = i0 + j;
      v[j] = i < padded ? ig_block_symbol(n, ends, nseg, pad_base, i,
                                          i < n ? text[i] : 0, zeros, stray)
                        : 0;
    }
  }
  if (i0 + IG_ITEMS <= padded) {
    int4* out = reinterpret_cast<int4*>(sym + i0);
#pragma unroll
    for (int q = 0; q < IG_ITEMS / 4; ++q)
      out[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    for (int j = 0; i0 + j < padded; ++j) sym[i0 + j] = v[j];
  }
  if (zeros) atomicAdd(counts, zeros);
  if (stray) atomicAdd(counts + 1, stray);
}

}  // namespace

// the int32 scratch an ingest of m bytes needs (tile status words and
// counter, aggregates, inclusive prefixes)
extern "C" long long andix_ingest_scratch_ints(long long m) {
  return ig_scratch_ints(ig_tiles(m));
}

// raw: m bytes, 16-byte aligned; scratch: andix_ingest_scratch_ints(m)
// int32, 16-byte aligned; seq: m bytes; rec: (cap + 1) * IG_REC int32;
// rs: rs_cap >= 2 m bytes, 16-byte aligned; starts: nfiles file starts on
// the card, ascending (join mode: one RS a file), or nfiles 0 (one RS a
// record).  The scratch's status words and the table are zeroed here;
// both kernels run on `stream`.  Returns cudaGetLastError.
extern "C" int andix_ingest(const unsigned char* raw, long long m, int cap,
                            int* scratch, unsigned char* seq, int* rec,
                            unsigned char* rs, long long rs_cap,
                            const long long* starts, int nfiles,
                            void* stream) {
  if (m <= 0) return 0;
  const long long tiles = ig_tiles(m);
  const IgScratch sc = ig_scratch(scratch, tiles);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, ig_status_ints(tiles) * sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(rec, 0, (cap + 1LL) * IG_REC * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  ingest_scan_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(raw, m, sc, seq,
                                                          rec, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned rs_blocks = (unsigned)((rs_cap + RS_TILE - 1) / RS_TILE);
  if (nfiles > 0)
    ingest_join_rs_kernel<<<rs_blocks, THREADS, 0, s>>>(seq, rec, cap, starts,
                                                        nfiles, rs);
  else
    ingest_rs_kernel<<<rs_blocks, THREADS, 0, s>>>(seq, rec, cap, rs);
  return (int)cudaGetLastError();
}

// text: n bytes, 16-byte aligned; ends: the nseg separator positions,
// ascending; sym: padded int32, 16-byte aligned; counts: 2 int32, zeroed
// here (0 bytes, 0 bytes at no separator).  Returns cudaGetLastError.
extern "C" int andix_block_text(const unsigned char* text, long long n,
                                const long long* ends, int nseg,
                                int pad_base, long long padded, int* sym,
                                int* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (padded <= 0) return 0;
  block_text_kernel<<<(unsigned)((padded + RS_TILE - 1) / RS_TILE), THREADS,
                      0, s>>>(text, n, ends, nseg, pad_base, padded, sym,
                              counts);
  return (int)cudaGetLastError();
}
