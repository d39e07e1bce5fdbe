// Flag-window scan on the card: one pass with decoupled look-back.
//
// Replaces andix/esa/scans.py:_flag_scan_pallas (its finals_kernel and
// seeded_kernel) and the XLA evaluation beside it: an inclusive scan of
// the flag-window monoid _fs_combine over n elements (value, flag,
// payload), giving at every position k (flags seen, capped at 2), g (min
// value between the last two flags), sa (payload of the last flag) and
// suf (min value since the last flag).  The matching statistics run it
// twice per subject, forward and reversed (reverse=1 maps scan position i
// to memory position n-1-i, so no reversed copies are made).
//
// What bounds it on this card: memory bytes.  Each position must read 9
// bytes (int32 value and payload, bool flag) and write 16 (four int32
// outputs), against a handful of integer min/select operations.  The
// design reads each input once and writes each output once, in one
// launch (flag_scan_tile.cuh holds the tile body):
// 1. Each block takes its tile id from a counter in scratch, so a tile
//    waits only on tiles that have started: no deadlock however the
//    blocks are scheduled.
// 2. A thread holds 16 consecutive positions (mirrored in reverse mode).
//    A warp loads its 512 positions with coalesced 16-byte loads and hands
//    each thread its chunk through a padded staging buffer in shared
//    memory (flags by shuffles); outputs leave the same way.
// 3. Each thread folds its positions; a warp scan of the thread states by
//    shuffles and one pass over the 8 warp states in shared memory give
//    each thread its prefix within the tile (3 __syncthreads a tile).
// 4. Decoupled look-back: the tile publishes its aggregate, the first warp
//    folds the predecessors' states 32 tiles at a time until it meets an
//    inclusive prefix (fs_lookback; it need not wait for tiles below that
//    prefix), then publishes the tile's inclusive
//    prefix; each thread re-scans its positions from its prefix.  Tile 0
//    publishes its inclusive prefix at once.
// The per-position `pre` field never reaches device memory.  The result
// does not depend on the tile size (the monoid is associative), so the
// TPU kernel's [chunk, 256-lane] layout is not carried over.

#include <cuda_runtime.h>

#include "flag_scan_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks resident on an SM: while a tile waits in its look-back, the
// others keep loads in flight
constexpr int BLOCKS_PER_SM = 3;
constexpr long long TILE = (long long)THREADS * FS_ITEMS;

constexpr int WARP_SPAN = 32 * FS_ITEMS;  // positions a warp
// a warp's staging buffer: 32 chunks of 16 ints, each padded by 4 so that
// 8 threads reading 16 bytes of 8 consecutive chunks hit distinct banks
constexpr int CHUNK_STRIDE = FS_ITEMS + 4;
constexpr int WARP_BUF = 32 * CHUNK_STRIDE;

// 4 consecutive int32 at memory position m (a multiple of 4), `pad`
// outside [0, n)
__device__ __forceinline__ int4 load4(const int* p, long long m, long long n,
                                      int pad) {
  if (m >= 0 && m + 4 <= n) return __ldg(reinterpret_cast<const int4*>(p + m));
  int r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r[c] = m + c >= 0 && m + c < n ? p[m + c] : pad;
  return make_int4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store4(int* p, long long m, long long n,
                                       int4 v) {
  if (m >= 0 && m + 4 <= n) {
    *reinterpret_cast<int4*>(p + m) = v;
    return;
  }
  const int r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (m + c >= 0 && m + c < n) p[m + c] = r[c];
}

// The warp's 16-byte loads of one int32 input: int4 e = lane + 32 q of
// its memory span, coalesced.
__device__ __forceinline__ void warp_load(const int* p, long long mb,
                                          long long n, int pad, int lane,
                                          int4* raw) {
#pragma unroll
  for (int q = 0; q < FS_ITEMS / 4; ++q)
    raw[q] = load4(p, mb + 4 * (lane + 32 * q), n, pad);
}

// Hands each thread its chunk (memory chunk `mc` of the span) of what
// warp_load loaded, through the staging buffer.
__device__ __forceinline__ void warp_transpose(const int4* raw, int lane,
                                               int mc, int* buf, int* out) {
#pragma unroll
  for (int q = 0; q < FS_ITEMS / 4; ++q) {
    const int e = lane + 32 * q;
    *reinterpret_cast<int4*>(buf + (e >> 2) * CHUNK_STRIDE + 4 * (e & 3)) =
        raw[q];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < FS_ITEMS / 4; ++q) {
    const int4 x =
        *reinterpret_cast<const int4*>(buf + mc * CHUNK_STRIDE + 4 * q);
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
  __syncwarp();
}

// One output field of the warp's chunks (each thread's in memory order),
// through the staging buffer to coalesced 16-byte stores.
__device__ __forceinline__ void warp_store(int* p, long long mb, long long n,
                                           int lane, int mc, int* buf,
                                           const int* r) {
#pragma unroll
  for (int q = 0; q < FS_ITEMS / 4; ++q)
    *reinterpret_cast<int4*>(buf + mc * CHUNK_STRIDE + 4 * q) =
        make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < FS_ITEMS / 4; ++q) {
    const int e = lane + 32 * q;
    store4(p, mb + 4 * e, n,
           *reinterpret_cast<const int4*>(buf + (e >> 2) * CHUNK_STRIDE +
                                          4 * (e & 3)));
  }
  __syncwarp();
}

template <bool REV>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flag_scan_kernel(FsArgs a, FsOut o, FsScratch sc) {
  __shared__ long long s_tile;
  __shared__ FS s_warp[WARPS];
  __shared__ FS s_prefix;
  __shared__ __align__(16) int s_buf[WARPS][WARP_BUF];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  // the warp's span of virtual positions, its lowest memory position (a
  // multiple of 16; positions outside [0, n) are padding), and this
  // thread's chunk within it in memory order
  const long long vw = t * TILE + (long long)warp * WARP_SPAN;
  const long long mb = REV ? a.nv - WARP_SPAN - vw : vw;
  const int mc = REV ? 31 - lane : lane;
  int* buf = s_buf[warp];

  // all of the warp's loads go out before any of them is used
  int4 rv[FS_ITEMS / 4], rs[FS_ITEMS / 4];
  warp_load(a.values, mb, a.n, FS_INF, lane, rv);
  warp_load(a.sa_vals, mb, a.n, -1, lane, rs);
  uint4 f;  // the flags of memory chunk `lane`
  const long long mf = mb + FS_ITEMS * lane;
  if (mf >= 0 && mf + FS_ITEMS <= a.n) {
    f = __ldg(reinterpret_cast<const uint4*>(a.flags + mf));
  } else {
    unsigned w[4] = {0, 0, 0, 0};
    for (int i = 0; i < FS_ITEMS; ++i)
      if (mf + i >= 0 && mf + i < a.n && a.flags[mf + i])
        w[i >> 2] |= 1u << (8 * (i & 3));
    f = make_uint4(w[0], w[1], w[2], w[3]);
  }
  FsChunk c;
  warp_transpose(rv, lane, mc, buf, c.v);
  warp_transpose(rs, lane, mc, buf, c.s);
  c.f[0] = __shfl_sync(0xffffffffu, f.x, mc);
  c.f[1] = __shfl_sync(0xffffffffu, f.y, mc);
  c.f[2] = __shfl_sync(0xffffffffu, f.z, mc);
  c.f[3] = __shfl_sync(0xffffffffu, f.w, mc);
  const FS own = fs_fold<REV>(c);

  // warp inclusive scan of the thread states
  FS inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const FS y = fs_shfl_up(inc, d);
    if (lane >= d) inc = fs_combine(y, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  FS excl = fs_shfl_up(inc, 1);
  if (lane == 0) excl = fs_identity();
  __syncthreads();
  FS before = fs_identity();  // the warps before this one
  for (int w = 0; w < warp; ++w) before = fs_combine(before, s_warp[w]);
  excl = fs_combine(before, excl);

  if (warp == 0) {
    FS agg = fs_identity();
    for (int w = 0; w < WARPS; ++w) agg = fs_combine(agg, s_warp[w]);
    FS prefix = fs_identity();
    if (t == 0) {
      if (lane == 0) fs_publish(sc, 0, agg, FS_INCLUSIVE);
    } else {
      if (lane == 0) fs_publish(sc, t, agg, FS_AGGREGATE);
      prefix = fs_lookback(sc, t, lane);
      if (lane == 0) fs_publish(sc, t, fs_combine(prefix, agg), FS_INCLUSIVE);
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  int rk[FS_ITEMS], rg[FS_ITEMS], rsa[FS_ITEMS], rsu[FS_ITEMS];
  fs_scan_chunk<REV>(fs_combine(s_prefix, excl), c, rk, rg, rsa, rsu);
  warp_store(o.k, mb, a.n, lane, mc, buf, rk);
  warp_store(o.g, mb, a.n, lane, mc, buf, rg);
  warp_store(o.sa, mb, a.n, lane, mc, buf, rsa);
  warp_store(o.suf, mb, a.n, lane, mc, buf, rsu);
}

}  // namespace

// the int32 scratch a scan of n positions needs (tiles, status words and
// counter, aggregates, inclusive prefixes: fs_scratch_ints)
extern "C" long long andix_flag_scan_scratch_ints(long long n, int reverse) {
  return fs_scratch_ints(fs_tiles(n, reverse, TILE));
}

// scratch: andix_flag_scan_scratch_ints(n, reverse) int32, 16-byte
// aligned; its status words and tile counter are zeroed here, on the
// launch's stream.  values, flags, sa_vals and the outputs must be
// 16-byte aligned.  Returns cudaGetLastError.
extern "C" int andix_flag_scan(const int* values, const unsigned char* flags,
                               const int* sa_vals, long long n, int reverse,
                               int* scratch, int* out_k, int* out_g,
                               int* out_sa, int* out_suf, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = fs_tiles(n, reverse, TILE);
  const FsScratch sc = fs_scratch(scratch, tiles);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, fs_status_ints(tiles) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const FsArgs a{values, flags, sa_vals, n, n + fs_pad(n, reverse)};
  const FsOut o{out_k, out_g, out_sa, out_suf};
  if (reverse)
    flag_scan_kernel<true><<<(unsigned)tiles, THREADS, 0, s>>>(a, o, sc);
  else
    flag_scan_kernel<false><<<(unsigned)tiles, THREADS, 0, s>>>(a, o, sc);
  return (int)cudaGetLastError();
}
