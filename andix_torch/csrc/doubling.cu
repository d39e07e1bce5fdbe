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
//   sa_keys (one int64 key and its int32 suffix out, the sort's value):
//     initial: the text read once into shared memory (a block's window
//       of 1024 + base - 1 symbols, each coded once there), 4 + 12 B a
//       position, four positions a thread with 16-byte stores;
//     full round: rank[i] and rank[i + k], two coalesced reads, 4 + 12 B,
//       four entries a thread with 16-byte loads and stores; rank[i + k]
//       comes through a shared-memory tile read from the 16-byte boundary
//       below b0 + k, so k need not keep the alignment;
//     tail round: the tied suffix and the head the last rerank carried
//       beside it (coalesced), rank[suffix + k] (a gather), and a count of
//       the suffixes in each part of the partitioned scatter.
//   sa_rerank (one pass, decoupled look-back over tiles of 4096 entries):
//     full: the sorted key and suffix read (12 B), sa[t] written (4 B),
//       the changed bit (1/8 B) and the rank scatter rank[order[t]] = head;
//     tail: the same over the tied entries, plus the in-order compaction
//       of the still-tied entries (slot, suffix, head);
//     extract: the tied slots from the last full round's changed bits,
//       with SA read only at the tied slots.
//   The rank scatter is random: written where it stands, each 4-byte
//   write takes a 32-byte sector of a rank array far larger than L2, and
//   costs what torch's own index_put_ scatter costs.  Partitioned, the
//   rerank bins its tile's (suffix, head) pairs by part in shared memory
//   and writes each part's run, coalesced, to the part's region of the
//   sort's dead key buffer (a cursor a part, one atomic a tile and part);
//   pair_scatter_kernel then reads the buffer in order and writes each
//   part into its window of rank, which L2 holds (esa/doubling.py's rule
//   sizes the window and keeps the direct scatter for small tails).
// The head is a running max over the positions where the sorted key
// changes; a group can span millions of entries (half the text of a
// clonal pair stays tied for 20 rounds), so no search for its start is
// bounded: the tile's aggregate (its last change, or -1, and its tied
// count) goes through the look-back instead.  The compaction keeps the
// slots ascending (the next round's heads are a running max over them),
// so it is an exclusive count in the same scan, never atomics: only the
// pairs' order inside a part, which no output reads, comes from atomics.
//
// A tile: 16 warps, each a span of 256 consecutive entries that it walks
// 32 at a time (entry q * 32 + lane), so every load and the sa store are
// coalesced; the neighbours' keys come by shuffles, and the span's edges
// by one extra load each.  A warp scans its 8 groups of 32 with shuffles,
// carrying the state from one to the next, and keeps each entry's
// inclusive state in registers; the tile's prefix is then folded in.

#include <cuda_runtime.h>

#include <cstdint>

#include "doubling_tile.cuh"

namespace {

constexpr int KEY_THREADS = 256;
constexpr int KEY_ITEMS = 4;  // entries a thread
constexpr long long KEY_SPAN = (long long)KEY_THREADS * KEY_ITEMS;
constexpr int KEY_WINDOW = KEY_SPAN + 11;  // base <= 12
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int WARP_SPAN = 32 * ITEMS;
constexpr long long TILE = (long long)THREADS * ITEMS;
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_QUADS = 4;  // int4 loads a thread, two pairs each
constexpr long long SCATTER_SPAN = 2LL * SCATTER_THREADS * SCATTER_QUADS;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(4 * THREADS >= SD_MAX_PARTS, "the part scan takes 4 a thread");

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// p[g .. g + 3], 0 past n; one 16-byte load where p is aligned (vec) and
// all four lie below n (g is a multiple of 4)
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long g,
                                      long long n, bool vec) {
  if (vec && g + 3 < n) return __ldg(reinterpret_cast<const int4*>(p + g));
  return make_int4(g < n ? __ldg(p + g) : 0, g + 1 < n ? __ldg(p + g + 1) : 0,
                   g + 2 < n ? __ldg(p + g + 2) : 0,
                   g + 3 < n ? __ldg(p + g + 3) : 0);
}

// four keys and their suffixes from i0 on: two 16-byte stores of keys and
// one of suffixes where aligned and inside, else one at a time
__device__ __forceinline__ void store4(long long* __restrict__ key,
                                       int* __restrict__ vals, long long i0,
                                       long long m, bool vec,
                                       const long long (&kk)[KEY_ITEMS],
                                       const int (&vv)[KEY_ITEMS]) {
  if (vec && i0 + 3 < m) {
    reinterpret_cast<longlong2*>(key + i0)[0] = make_longlong2(kk[0], kk[1]);
    reinterpret_cast<longlong2*>(key + i0)[1] = make_longlong2(kk[2], kk[3]);
    *reinterpret_cast<int4*>(vals + i0) =
        make_int4(vv[0], vv[1], vv[2], vv[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j)
    if (i0 + j < m) {
      key[i0 + j] = kk[j];
      vals[i0 + j] = vv[j];
    }
}

// The initial keys: four positions a thread, each window symbol coded
// once into shared memory (a block's KEY_SPAN + base - 1 of them).
__global__ void __launch_bounds__(KEY_THREADS)
initial_key_kernel(const int* __restrict__ sym, long long n, int mode,
                   int base, bool vec, long long* __restrict__ key,
                   int* __restrict__ vals) {
  __shared__ int w[KEY_WINDOW];
  const long long b0 = (long long)blockIdx.x * KEY_SPAN;
  const int width =
      mode == SD_KEY_WIDE ? base : (mode == SD_KEY_CLAMPED ? 4 : 1);
  for (int x = threadIdx.x; x < KEY_SPAN + width - 1; x += KEY_THREADS)
    w[x] = b0 + x < n ? sd_window_value(mode, __ldg(sym + b0 + x), base) : 0;
  const long long i0 = b0 + (long long)KEY_ITEMS * threadIdx.x;
  const int4 s4 = load4(sym, i0, n, vec);
  __syncthreads();
  const int raw[KEY_ITEMS] = {s4.x, s4.y, s4.z, s4.w};
  long long kk[KEY_ITEMS];
  int vv[KEY_ITEMS];
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j) {
    kk[j] = sd_initial_key(mode, w + KEY_ITEMS * threadIdx.x + j, raw[j],
                           i0 + j, base);
    vv[j] = (int)(i0 + j);
  }
  store4(key, vals, i0, n, vec, kk, vv);
}

// A full round's keys: four suffixes a thread; rank[i + k] through a
// shared tile read from the 16-byte boundary at or below b0 + k.
__global__ void __launch_bounds__(KEY_THREADS)
full_key_kernel(const int* __restrict__ rank, long long n, long long k,
                bool vec, long long* __restrict__ key,
                int* __restrict__ vals) {
  __shared__ __align__(16) int s_far[KEY_SPAN + 4];
  const long long b0 = (long long)blockIdx.x * KEY_SPAN;
  const long long a0 = b0 + (k & ~3LL);
  for (int x = threadIdx.x; x <= KEY_SPAN / 4; x += KEY_THREADS)
    reinterpret_cast<int4*>(s_far)[x] = load4(rank, a0 + 4LL * x, n, vec);
  const long long i0 = b0 + (long long)KEY_ITEMS * threadIdx.x;
  const int4 nv = load4(rank, i0, n, vec);
  __syncthreads();
  const int* far = s_far + KEY_ITEMS * threadIdx.x + (int)(k & 3);
  const int near[KEY_ITEMS] = {nv.x, nv.y, nv.z, nv.w};
  long long kk[KEY_ITEMS];
  int vv[KEY_ITEMS];
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j) {
    const long long i = i0 + j;
    kk[j] = sd_pair_key(near[j], i + k < n ? (long long)far[j] + 1 : 0, n);
    vv[j] = (int)i;
  }
  store4(key, vals, i0, n, vec, kk, vv);
}

// A tail round's keys: four tied entries a thread, each suffix's carried
// head read beside it and rank[suffix + k] gathered; with `hist`, the
// count of the suffixes in each part of 2^shift (a block's counts in
// shared memory, one atomic a lane group, then one a block and part).
__global__ void __launch_bounds__(KEY_THREADS)
tail_key_kernel(const int* __restrict__ rank, const int* __restrict__ sa_vals,
                const int* __restrict__ heads, long long m, long long n,
                long long k, bool vec, long long* __restrict__ key,
                int* __restrict__ vals, int* __restrict__ hist, int shift,
                int parts) {
  __shared__ int s_hist[SD_MAX_PARTS];
  if (hist) {
    for (int x = threadIdx.x; x < parts; x += KEY_THREADS) s_hist[x] = 0;
    __syncthreads();
  }
  const long long j0 =
      (long long)blockIdx.x * KEY_SPAN + (long long)KEY_ITEMS * threadIdx.x;
  const int4 s4 = load4(sa_vals, j0, m, vec);
  const int4 h4 = load4(heads, j0, m, vec);
  const int sv[KEY_ITEMS] = {s4.x, s4.y, s4.z, s4.w};
  const int hd[KEY_ITEMS] = {h4.x, h4.y, h4.z, h4.w};
  long long r2[KEY_ITEMS];
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j)
    r2[j] = j0 + j < m && sv[j] + k < n
                ? (long long)__ldg(rank + sv[j] + k) + 1
                : 0;
  long long kk[KEY_ITEMS];
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j) kk[j] = sd_pair_key(hd[j], r2[j], n);
  store4(key, vals, j0, m, vec, kk, sv);
  if (!hist) return;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < KEY_ITEMS; ++j) {
    const int part = j0 + j < m ? sd_part(sv[j], shift) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, part);
    if (part >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(s_hist + part, __popc(peers));
  }
  __syncthreads();
  for (int x = threadIdx.x; x < parts; x += KEY_THREADS)
    if (s_hist[x]) atomicAdd(hist + x, s_hist[x]);
}

__device__ __forceinline__ SdState warp_scan(SdState x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const SdState y = sd_shfl_up(x, d);
    if (lane >= d) x = sd_combine(y, x);
  }
  return x;
}

// Exclusive scan of get(0 .. count - 1) (count <= 4 THREADS) into out,
// by the whole block; s_tmp holds WARPS ints.
template <class Get>
__device__ __forceinline__ void block_exclusive_scan(Get get, int* out,
                                                     int count, int* s_tmp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int v[4], sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = 4 * threadIdx.x + j;
    v[j] = x < count ? get(x) : 0;
    sum += v[j];
  }
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_tmp[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += s_tmp[w];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = 4 * threadIdx.x + j;
    if (x < count) out[x] = run;
    run += v[j];
  }
  __syncthreads();
}

// The partitioned scatter's binning of tile t's (suffix dst, head hd)
// pairs (dst -1: none): each lane group of one part takes its places with
// one shared atomic, the parts' counts are scanned into the staged tile's
// order and each part takes its run of the pair buffer with one atomic on
// its cursor, and the staged tile is written out in order, so a part's
// run is coalesced.  Shared: each part's pairs in the tile, their first
// place in the staged tile, and the part's region in the pair buffer (a
// tail's, from the part counts), then the offset from a staged place to
// the buffer.
template <int MODE>
__device__ __forceinline__ void bin_pairs(const SdArgs& a,
                                          const SdScratch& sc, long long t,
                                          int lane, const int (&dst)[ITEMS],
                                          const int (&hd)[ITEMS]) {
  __shared__ int s_tmp[WARPS];
  __shared__ int s_count[SD_MAX_PARTS], s_start[SD_MAX_PARTS];
  __shared__ int s_dst[SD_MAX_PARTS];
  __shared__ int2 s_stage[TILE];
  for (int x = threadIdx.x; x < a.parts; x += THREADS) s_count[x] = 0;
  __syncthreads();
  int rnk[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int part = dst[q] >= 0 ? sd_part(dst[q], a.shift) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, part);
    const int leader = __ffs(peers) - 1;
    int off = 0;
    if (part >= 0 && lane == leader)
      off = atomicAdd(s_count + part, __popc(peers));
    rnk[q] = __shfl_sync(FULL_MASK, off, leader) +
             __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();
  block_exclusive_scan([&](int x) { return s_count[x]; }, s_start, a.parts,
                       s_tmp);
  if constexpr (MODE == SD_TAIL)
    block_exclusive_scan([&](int x) { return __ldg(a.hist + x); }, s_dst,
                         a.parts, s_tmp);
  for (int x = threadIdx.x; x < a.parts; x += THREADS)
    if (s_count[x])
      s_dst[x] = (int)(sd_region(a, x, MODE == SD_TAIL ? s_dst[x] : 0) +
                       atomicAdd(sc.cursor + x, s_count[x]) - s_start[x]);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q)
    if (dst[q] >= 0)
      s_stage[s_start[sd_part(dst[q], a.shift)] + rnk[q]] =
          make_int2(dst[q], hd[q]);
  __syncthreads();
  const int cnt = (int)(a.m - t * TILE < TILE ? a.m - t * TILE : TILE);
  int2* pairs = reinterpret_cast<int2*>(a.pairs);
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    const int2 pr = s_stage[i];
    pairs[s_dst[sd_part(pr.x, a.shift)] + i] = pr;
  }
}

// One instance a mode, and a partitioned (BINNED) one of the full and
// tail modes, so each keeps only its own registers and shared memory (the
// extract's few let three blocks share an SM).
template <int MODE, bool BINNED>
__global__ void __launch_bounds__(THREADS, MODE == SD_EXTRACT ? 3 : 2)
rerank_kernel(SdArgs args, SdScratch sc, long long tiles) {
  __shared__ long long s_tile;
  __shared__ SdState s_warp[WARPS];
  __shared__ SdState s_prefix;
  SdArgs a = args;
  a.mode = MODE;  // known to the compiler in the shared bodies
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long base = t * TILE + (long long)warp * WARP_SPAN;

  // bit q: entry q * 32 + lane starts a group; the entry after it does
  unsigned chg = 0, nxt = 0;
  int val[ITEMS], ord[ITEMS];  // the head value (a tail's slot), suffix
  if constexpr (MODE == SD_EXTRACT) {
    // the last full round's changed bits: word q is entries q * 32 + lane
    unsigned w[ITEMS + 1];
#pragma unroll
    for (int q = 0; q <= ITEMS; ++q) {
      const long long e = base + q * 32;
      w[q] = e < a.m ? __ldg(a.bits + (e >> 5)) : 0u;
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      chg |= ((w[q] >> lane) & 1u) << q;
      nxt |= (lane < 31 ? (w[q] >> (lane + 1)) & 1u : w[q + 1] & 1u) << q;
      ord[q] = -1;
    }
  } else {
    long long key[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const long long p = base + q * 32 + lane;
      key[q] = p < a.m ? a.keys[p] : 0;
      if constexpr (MODE == SD_TAIL) val[q] = p < a.m ? a.slots[p] : -1;
      ord[q] = p < a.m ? a.order[p] : -1;  // loaded now, used after the scan
    }
    const long long edge_prev =
        lane == 0 && base > 0 && base - 1 < a.m ? a.keys[base - 1] : 0;
    const long long edge_next =
        lane == 31 && base + WARP_SPAN < a.m ? a.keys[base + WARP_SPAN] : 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      long long kp = __shfl_up_sync(FULL_MASK, key[q], 1);
      // the last key of the 32 before, the first of the 32 after
      const long long last = __shfl_sync(FULL_MASK, key[q ? q - 1 : 0], 31);
      if (lane == 0) kp = q ? last : edge_prev;
      long long kn = __shfl_down_sync(FULL_MASK, key[q], 1);
      const long long first =
          __shfl_sync(FULL_MASK, key[q + 1 < ITEMS ? q + 1 : q], 0);
      if (lane == 31) kn = q + 1 < ITEMS ? first : edge_next;
      chg |= (unsigned)(key[q] != kp) << q;
      nxt |= (unsigned)(kn != key[q]) << q;
    }
  }
  if constexpr (MODE != SD_TAIL) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) val[q] = (int)(base + q * 32 + lane);
  }

  SdState loc[ITEMS];
  unsigned tied_bits = 0;
  SdState carry = sd_identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long p = base + q * 32 + lane;
    int td = 0;
    SdState x = sd_identity();
    const bool c = (chg >> q) & 1u;
    if (p < a.m) x = sd_entry(p, a.m, c, (nxt >> q) & 1u, val[q], &td);
    tied_bits |= (unsigned)td << q;
    if constexpr (MODE == SD_FULL) {
      const unsigned b = __ballot_sync(FULL_MASK, p < a.m && (c || p == 0));
      if (lane == 0 && base + q * 32 < a.m) a.bits[(base >> 5) + q] = b;
    }
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
  int dst[ITEMS], hd[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long p = base + q * 32 + lane;
    dst[q] = -1;
    hd[q] = 0;
    if (p < a.m) {
      const SdState st = sd_combine(pre, loc[q]);
      const int td = (tied_bits >> q) & 1;
      hd[q] = st.head;
      dst[q] = sd_emit(a, p, st.head, st.tied - td, td, val[q], ord[q]);
    }
  }
  if constexpr (BINNED) {
    bin_pairs<MODE>(a, sc, t, lane, dst, hd);
  } else {  // the direct scatter (the extract writes none)
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (dst[q] >= 0) a.rank[dst[q]] = hd[q];
  }
}

// rank[suffix] = head for m (suffix, head) pairs, in buffer order: a
// block a run of 2048, blocks in ascending order, so the parts' windows
// of rank are written one or two at a time.
__global__ void __launch_bounds__(SCATTER_THREADS)
pair_scatter_kernel(const int* __restrict__ pairs, long long m,
                    int* __restrict__ rank) {
  const long long b0 = (long long)blockIdx.x * SCATTER_SPAN;
  int4 v[SCATTER_QUADS];
#pragma unroll
  for (int j = 0; j < SCATTER_QUADS; ++j) {
    const long long e = b0 + 2LL * (j * SCATTER_THREADS + threadIdx.x);
    if (e + 1 < m)
      v[j] = __ldg(reinterpret_cast<const int4*>(pairs) + (e >> 1));
    else if (e < m)
      v[j] = make_int4(__ldg(pairs + 2 * e), __ldg(pairs + 2 * e + 1), -1, 0);
    else
      v[j] = make_int4(-1, 0, -1, 0);
  }
#pragma unroll
  for (int j = 0; j < SCATTER_QUADS; ++j) {
    if (v[j].x >= 0) rank[v[j].x] = v[j].y;
    if (v[j].z >= 0) rank[v[j].z] = v[j].w;
  }
}

unsigned blocks(long long m, long long span) {
  return (unsigned)((m + span - 1) / span);
}

}  // namespace

// One int64 key and the int32 suffix an entry (doubling_tile.cuh's
// SD_KEY_* modes).  Initial modes: src is the int32 text of n symbols
// (m = n); SD_KEY_FULL: src is rank [n] (m = n, sa_vals null);
// SD_KEY_TAIL: src is rank [n], sa_vals the m tied suffixes and heads
// their heads (rank[sa_vals]); hist, if not null, receives the count of
// the suffixes in each of `parts` parts of 2^shift (zeroed here first).
// Returns cudaGetLastError.
extern "C" int andix_sa_keys(int mode, const int* src, const int* sa_vals,
                             const int* heads, long long m, long long n,
                             long long k, int base, long long* key, int* vals,
                             int* hist, int shift, int parts, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode <= SD_KEY_WIDE) {
    const bool vec = aligned16(src) && aligned16(key) && aligned16(vals);
    initial_key_kernel<<<blocks(m, KEY_SPAN), KEY_THREADS, 0, s>>>(
        src, n, mode, base, vec, key, vals);
  } else if (mode == SD_KEY_FULL) {
    const bool vec = aligned16(src) && aligned16(key) && aligned16(vals);
    full_key_kernel<<<blocks(m, KEY_SPAN), KEY_THREADS, 0, s>>>(src, n, k,
                                                                vec, key,
                                                                vals);
  } else {
    if (hist) {
      const cudaError_t err =
          cudaMemsetAsync(hist, 0, (size_t)parts * sizeof(int), s);
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec = aligned16(sa_vals) && aligned16(heads) &&
                     aligned16(key) && aligned16(vals);
    tail_key_kernel<<<blocks(m, KEY_SPAN), KEY_THREADS, 0, s>>>(
        src, sa_vals, heads, m, n, k, vec, key, vals, hist, shift, parts);
  }
  return (int)cudaGetLastError();
}

// the int32 scratch a rerank of m entries over `parts` parts needs
extern "C" long long andix_sa_rerank_scratch_ints(long long m, int parts) {
  return sd_scratch_ints(sd_tiles(m, TILE), parts);
}

// One rerank pass over m entries (doubling_tile.cuh's SdArgs says which
// pointers each mode reads and writes; the others may be null).  pairs
// not null: the rank scatter is partitioned into `parts` parts of
// 2^shift suffixes (hist: a tail round's part counts), and
// andix_sa_pair_scatter then writes rank from the pairs.  scratch:
// andix_sa_rerank_scratch_ints(m, parts) int32, 16-byte aligned, its
// status words, counter and cursors zeroed here on the launch's stream.
// tied_out [1] receives the tied count.  Returns cudaGetLastError.
extern "C" int andix_sa_rerank(int mode, long long m, const long long* keys,
                               const int* order, const int* slots, int* rank,
                               int* sa, unsigned* bits, int* slots_out,
                               int* savals_out, int* heads_out, int* tied_out,
                               int* pairs, int shift, int parts,
                               const int* hist, int* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0) return (int)cudaMemsetAsync(tied_out, 0, sizeof(int), s);
  if (!pairs) parts = 0;
  if (parts > SD_MAX_PARTS) return (int)cudaErrorInvalidValue;
  const long long tiles = sd_tiles(m, TILE);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sd_status_ints(tiles, parts) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const SdArgs a{mode,      m,          keys,      order,    slots,
                 rank,      sa,         bits,      slots_out, savals_out,
                 heads_out, tied_out,   pairs,     shift,    parts,
                 hist};
  const SdScratch sc = sd_scratch(scratch, tiles, parts);
  const unsigned g = (unsigned)tiles;
  if (mode == SD_EXTRACT)
    rerank_kernel<SD_EXTRACT, false><<<g, THREADS, 0, s>>>(a, sc, tiles);
  else if (mode == SD_FULL && pairs)
    rerank_kernel<SD_FULL, true><<<g, THREADS, 0, s>>>(a, sc, tiles);
  else if (mode == SD_FULL)
    rerank_kernel<SD_FULL, false><<<g, THREADS, 0, s>>>(a, sc, tiles);
  else if (pairs)
    rerank_kernel<SD_TAIL, true><<<g, THREADS, 0, s>>>(a, sc, tiles);
  else
    rerank_kernel<SD_TAIL, false><<<g, THREADS, 0, s>>>(a, sc, tiles);
  return (int)cudaGetLastError();
}

// rank[pairs[2 i]] = pairs[2 i + 1] for the m pairs a partitioned rerank
// left (16-byte aligned).  Returns cudaGetLastError.
extern "C" int andix_sa_pair_scatter(const int* pairs, long long m, int* rank,
                                     void* stream) {
  if (m <= 0) return 0;
  pair_scatter_kernel<<<blocks(m, SCATTER_SPAN), SCATTER_THREADS, 0,
                        (cudaStream_t)stream>>>(pairs, m, rank);
  return (int)cudaGetLastError();
}
