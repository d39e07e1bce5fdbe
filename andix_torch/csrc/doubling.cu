// The suffix-array doubling loop's own passes on the card: the key build
// and the rerank around the library sort.
//
// Replaces, around lax.sort, andix/esa/doubling.py:_sa_loop_traced (:520)
// and its helpers _initial_ranks (:85), _doubling_round (:170),
// _extract_tied (:196) and _bucketed_round (:215), XLA there, and the
// torch ops of esa/doubling.py's *_plain functions: about 15 full-length
// passes a round (a multiply, a fill, a shifted copy, an add, a compare,
// an arange, a cumsum, a scatter, a gather, the tied masks, a sum, the
// rank scatter), each with its own allocation, and 30 for the wide
// initial key.  The sort between them stays a library sort, as lax.sort
// is in andix: CUB's radix sort of (key, int32 suffix) pairs over the
// key's bits (sa_sort.cu).
//
// What bounds it: bytes.  Each pass does a few integer operations an
// entry, so the floor is the bytes it must move:
//   sa_keys (one thread an entry, one int64 key and its int32 suffix
//   out, the sort's value):
//     initial: the text read once into shared memory (a block's window
//       of 256 + base - 1 symbols, each coded once there), 4 + 12 B a
//       position;
//     full round: rank[i] and rank[i + k], two coalesced reads, 4 + 12 B;
//     tail round: rank[sa_vals[j]] and rank[sa_vals[j] + k], gathers.
//   sa_rerank (one pass, decoupled look-back over tiles of 2048 entries):
//     full: the sorted key and suffix read (12 B), sa[t] written (4 B)
//       and the scatter rank[order[t]] = head, a 32-byte sector for 4
//       bytes, so the scatter sets its floor (a random scatter alone costs
//       as much on the card);
//     tail: the same over the tied entries, plus the in-order compaction
//       of the still-tied entries (the next round's slots and suffixes);
//     extract: the tied slots of sa under rank, compacted in order.
// The head is a running max over the positions where the sorted key
// changes; a group can span millions of entries (half the text of a
// clonal pair stays tied for 20 rounds), so no search for its start is
// bounded: the tile's aggregate (its last change, or -1, and its tied
// count) goes through the look-back instead.  The compaction keeps the
// slots ascending (the next round's heads are a running max over them),
// so it is an exclusive count in the same scan, never atomics.
//
// A tile: 8 warps, each a span of 256 consecutive entries that it walks
// 32 at a time (entry q * 32 + lane), so every load and the sa store are
// coalesced; the neighbours' keys come by shuffles, and the span's edges
// by one extra load each.  A warp scans its 8 groups of 32 with shuffles,
// carrying the state from one to the next, and keeps each entry's
// inclusive state in registers; the tile's prefix is then folded in.

#include <cuda_runtime.h>

#include "doubling_tile.cuh"

namespace {

constexpr int KEY_THREADS = 256;
constexpr int KEY_WINDOW = KEY_THREADS + 11;  // base <= 12
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int WARP_SPAN = 32 * ITEMS;
constexpr long long TILE = (long long)THREADS * ITEMS;

__global__ void __launch_bounds__(KEY_THREADS)
initial_key_kernel(const int* __restrict__ sym, long long n, int mode,
                   int base, long long* __restrict__ key,
                   int* __restrict__ vals) {
  __shared__ int w[KEY_WINDOW];
  const long long b0 = (long long)blockIdx.x * KEY_THREADS;
  const int width =
      mode == SD_KEY_WIDE ? base : (mode == SD_KEY_CLAMPED ? 4 : 1);
  for (int x = threadIdx.x; x < KEY_THREADS + width - 1; x += KEY_THREADS)
    w[x] = b0 + x < n ? sd_window_value(mode, __ldg(sym + b0 + x), base) : 0;
  __syncthreads();
  const long long i = b0 + threadIdx.x;
  if (i < n) {
    key[i] = sd_initial_key(mode, w + threadIdx.x, __ldg(sym + i), i, base);
    vals[i] = (int)i;
  }
}

// sa_vals null: entry j is suffix j (a full round)
__global__ void __launch_bounds__(KEY_THREADS)
round_key_kernel(const int* __restrict__ rank,
                 const int* __restrict__ sa_vals, long long m, long long n,
                 long long k, long long* __restrict__ key,
                 int* __restrict__ vals) {
  const long long j = (long long)blockIdx.x * KEY_THREADS + threadIdx.x;
  if (j < m) {
    const int i = sa_vals ? __ldg(sa_vals + j) : (int)j;
    key[j] = sd_round_key(rank, i, n, k);
    vals[j] = i;
  }
}

__device__ __forceinline__ SdState warp_scan(SdState x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const SdState y = sd_shfl_up(x, d);
    if (lane >= d) x = sd_combine(y, x);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
rerank_kernel(SdArgs a, SdScratch sc, long long tiles) {
  __shared__ long long s_tile;
  __shared__ SdState s_warp[WARPS];
  __shared__ SdState s_prefix;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long base = t * TILE + (long long)warp * WARP_SPAN;

  long long key[ITEMS];
  int val[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long p = base + q * 32 + lane;
    key[q] = p < a.m ? sd_key_at(a, p) : 0;
    val[q] = p < a.m ? sd_val_at(a, p) : -1;
  }
  const long long edge_prev =
      lane == 0 && base > 0 && base - 1 < a.m ? sd_key_at(a, base - 1) : 0;
  const long long edge_next = lane == 31 && base + WARP_SPAN < a.m
                                  ? sd_key_at(a, base + WARP_SPAN)
                                  : 0;

  SdState loc[ITEMS];
  unsigned tied_bits = 0;
  SdState carry = sd_identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long p = base + q * 32 + lane;
    long long kp = __shfl_up_sync(0xffffffffu, key[q], 1);
    // the last key of the 32 before, the first of the 32 after
    const long long last = __shfl_sync(0xffffffffu, key[q ? q - 1 : 0], 31);
    if (lane == 0) kp = q ? last : edge_prev;
    long long kn = __shfl_down_sync(0xffffffffu, key[q], 1);
    const long long first =
        __shfl_sync(0xffffffffu, key[q + 1 < ITEMS ? q + 1 : q], 0);
    if (lane == 31) kn = q + 1 < ITEMS ? first : edge_next;
    int td = 0;
    SdState x = sd_identity();
    if (p < a.m) x = sd_entry(p, a.m, kp, key[q], kn, val[q], &td);
    tied_bits |= (unsigned)td << q;
    x = sd_combine(carry, warp_scan(x, lane));
    loc[q] = x;
    carry = sd_shfl(x, 31);
  }
  if (lane == 31) s_warp[warp] = carry;
  __syncthreads();
  SdState before = sd_identity();  // the warps before this one
  for (int w = 0; w < warp; ++w) before = sd_combine(before, s_warp[w]);

  if (warp == 0) {
    SdState agg = sd_identity();
    for (int w = 0; w < WARPS; ++w) agg = sd_combine(agg, s_warp[w]);
    SdState prefix = sd_identity();
    if (t == 0) {
      if (lane == 0) sd_publish(sc, 0, agg, SD_INCLUSIVE);
    } else {
      if (lane == 0) sd_publish(sc, t, agg, SD_AGGREGATE);
      prefix = sd_lookback(sc, t, lane);
      if (lane == 0)
        sd_publish(sc, t, sd_combine(prefix, agg), SD_INCLUSIVE);
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (t == tiles - 1) *a.tied_out = sd_combine(prefix, agg).tied;
    }
  }
  __syncthreads();
  const SdState pre = sd_combine(s_prefix, before);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long p = base + q * 32 + lane;
    if (p < a.m) {
      const SdState st = sd_combine(pre, loc[q]);
      const int td = (tied_bits >> q) & 1;
      sd_emit(a, p, st.head, st.tied - td, td, val[q]);
    }
  }
}

unsigned key_blocks(long long m) {
  return (unsigned)((m + KEY_THREADS - 1) / KEY_THREADS);
}

}  // namespace

// One int64 key and the int32 suffix an entry (doubling_tile.cuh's
// SD_KEY_* modes).  Initial modes: src is the int32 text of n symbols
// (m = n); SD_KEY_FULL: src is rank [n] (m = n, sa_vals null);
// SD_KEY_TAIL: src is rank [n] and sa_vals the m tied suffixes.  Returns
// cudaGetLastError.
extern "C" int andix_sa_keys(int mode, const int* src, const int* sa_vals,
                             long long m, long long n, long long k, int base,
                             long long* key, int* vals, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode <= SD_KEY_WIDE)
    initial_key_kernel<<<key_blocks(m), KEY_THREADS, 0, s>>>(src, n, mode,
                                                             base, key, vals);
  else
    round_key_kernel<<<key_blocks(m), KEY_THREADS, 0, s>>>(
        src, mode == SD_KEY_TAIL ? sa_vals : nullptr, m, n, k, key, vals);
  return (int)cudaGetLastError();
}

// the int32 scratch a rerank of m entries needs
extern "C" long long andix_sa_rerank_scratch_ints(long long m) {
  return sd_scratch_ints(sd_tiles(m, TILE));
}

// One rerank pass over m entries (doubling_tile.cuh's SdArgs says which
// pointers each mode reads and writes; the others may be null).  scratch:
// andix_sa_rerank_scratch_ints(m) int32, 16-byte aligned, its status
// words and counter zeroed here on the launch's stream.  tied_out [1]
// receives the tied count.  Returns cudaGetLastError.
extern "C" int andix_sa_rerank(int mode, long long m, const long long* keys,
                               const int* order, const int* slots, int* rank,
                               int* sa, int* slots_out, int* savals_out,
                               int* tied_out, int* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0) return (int)cudaMemsetAsync(tied_out, 0, sizeof(int), s);
  const long long tiles = sd_tiles(m, TILE);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sd_status_ints(tiles) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const SdArgs a{mode, m,  keys,      order,      slots,
                 rank, sa, slots_out, savals_out, tied_out};
  rerank_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      a, sd_scratch(scratch, tiles), tiles);
  return (int)cudaGetLastError();
}
