// Packed event fetch on the card: the walk's int32 event buffers, sorted
// lane-major, encoded at 6 B an event with an escape list.
//
// Replaces andix/chain/evpack.py:_encode_fn (an XLA program there, used by
// andix/subject_pipeline.py:_fetch_walk on the subject-index schedule).
// andix sorts the lanes with jnp.sort; here CUB's radix sort of (lane,
// slot) pairs from the toolkit's headers takes that place, a library's
// sort and not a ported kernel, between the two hand kernels.
//
// What bounds it: bytes, 16 B a live event read and 6 B a slot written,
// 9 us at the largest 8 x 5 Mbp dispatch (1.27M events); below that,
// launches, the sort's passes and the gathers through the sorted slots
// set the time.  So the design is three steps on one stream, one C call:
//   1. evpack_key_kernel reads the cnt live lanes once, coalesced, and
//      writes them as the sort's int32 keys beside the slots 0 .. cnt - 1;
//      its threads also zero what the encode pass adds into or leaves
//      zero: the escape list and the lane counts in the output, the
//      look-back's status words and tile counter;
//   2. CUB's DeviceRadixSort::SortPairs of the live slots alone (dead
//      slots encode alike, whatever their order) over the key's low
//      bit_length(n_lanes - 1) bits (13 at 8192 lanes, two passes, where
//      torch.sort sorts all 32 bits and carries int64 indices), stable,
//      in two buffers of each (CUB's DoubleBuffer: no copy back);
//   3. evpack_encode_kernel, one pass: a block takes the next tile of 1024
//      pairs of sorted positions (a counter, so tiles start in order); a
//      thread takes pairs j = base + u * 32 + lane (u < 4), so a warp's
//      loads of lanes and slots are 8-byte, and its packed stores 4-byte,
//      words on consecutive addresses.  It gathers each live position's
//      (q, s, len) through its slot, takes the previous position's from
//      the neighbouring lane by a shuffle, computes both events
//      (evpack_lane.cuh), stores the three packed words, adds the lane
//      counts at the sorted runs' edges, and counts its escapes by
//      ballots; warp 0 publishes the tile's count and takes the escapes
//      before the tile from a decoupled look-back; then every escape is
//      written at its slot, from registers, in the same pass, and the
//      last tile writes n_esc and the overflow flag.  No atomic decides a
//      slot.
// The event bodies are in evpack_lane.cuh, shared with the host twin.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

#include "evpack_lane.cuh"

namespace {

constexpr int kKeyThreads = 256;
constexpr int kWarps = EVPACK_THREADS / 32;
constexpr int kWarpPairs = 32 * EVPACK_ITEMS;
constexpr unsigned kFull = 0xffffffffu;

struct EncodeArgs {
  const unsigned* lane_s;  // [m] sorted lanes
  const int* slot_s;       // [m] each sorted position's buffer slot
  const int* q;            // the walk's buffers, read at slot_s[i]
  const int* s;
  const int* len;
  long long cnt, kh;
  long long esc_cap;
  int* packed;  // [3][kh]
  int* esc;     // [4][esc_cap]
  int* counts;  // [n_lanes]
  int* tail;    // n_esc, the overflow flag
};

__global__ void __launch_bounds__(kKeyThreads)
    evpack_key_kernel(const int* __restrict__ lane, long long cnt,
                      unsigned* __restrict__ keys, int* __restrict__ slots,
                      int* __restrict__ zero_a, long long n_a,
                      int* __restrict__ zero_b, long long n_b) {
  const long long stride = (long long)gridDim.x * kKeyThreads;
  const long long t0 = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  for (long long i = t0; i < cnt; i += stride) {
    keys[i] = (unsigned)__ldg(lane + i);
    slots[i] = (int)i;
  }
  for (long long i = t0; i < n_a; i += stride) zero_a[i] = 0;
  for (long long i = t0; i < n_b; i += stride) zero_b[i] = 0;
}

// a neighbour's (lane, q, s): what an event takes from the one before
__device__ __forceinline__ EvpackSlot shfl_slot(const EvpackSlot& x,
                                                int src) {
  return {__shfl_sync(kFull, x.lane, src), __shfl_sync(kFull, x.q, src),
          __shfl_sync(kFull, x.s, src), 0};
}

__device__ __forceinline__ EvpackSlot shfl_up_slot(const EvpackSlot& x) {
  return {__shfl_up_sync(kFull, x.lane, 1), __shfl_up_sync(kFull, x.q, 1),
          __shfl_up_sync(kFull, x.s, 1), 0};
}

__device__ __forceinline__ EvpackSlot load_slot(const EncodeArgs& a,
                                                unsigned lane, int slot,
                                                bool live) {
  EvpackSlot x{(int)lane, 0, 0, 0};
  if (live) {
    x.q = __ldg(a.q + slot);
    x.s = __ldg(a.s + slot);
    x.len = __ldg(a.len + slot);
  }
  return x;
}

__global__ void __launch_bounds__(EVPACK_THREADS)
    evpack_encode_kernel(EncodeArgs a, EvpackScratch sc, long long tiles) {
  __shared__ long long s_tile;
  __shared__ int s_warp[kWarps];
  __shared__ int s_prefix;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long base = t * EVPACK_TILE_PAIRS + (long long)warp * kWarpPairs;

  // positions 2j and 2j + 1 of pair j = base + u * 32 + lane
  EvpackSlot x0[EVPACK_ITEMS], x1[EVPACK_ITEMS];
#pragma unroll
  for (int u = 0; u < EVPACK_ITEMS; ++u) {
    const long long j = base + u * 32 + lane;
    uint2 ln = make_uint2(0u, 0u);
    int2 sl = make_int2(0, 0);
    if (2 * j < a.cnt) {  // the second may be dead: read, not used
      ln = __ldg(reinterpret_cast<const uint2*>(a.lane_s) + j);
      sl = __ldg(reinterpret_cast<const int2*>(a.slot_s) + j);
    }
    x0[u] = load_slot(a, ln.x, sl.x, 2 * j < a.cnt);
    x1[u] = load_slot(a, ln.y, sl.y, 2 * j + 1 < a.cnt);
  }
  // the position before the warp's first
  EvpackSlot edge{0, 0, 0, 0};
  const long long p_edge = 2 * base - 1;
  if (lane == 0 && p_edge >= 0 && p_edge < a.cnt)
    edge = load_slot(a, a.lane_s[p_edge], a.slot_s[p_edge], true);

  unsigned esc_bits = 0;  // bit 2u + h: position 2j + h escapes
  int before[EVPACK_ITEMS];  // the warp's escapes before pair j's first
  int run = 0;
  EvpackEvent ev[EVPACK_ITEMS][2];
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int u = 0; u < EVPACK_ITEMS; ++u) {
    const long long j = base + u * 32 + lane;
    EvpackSlot prev = shfl_up_slot(x1[u]);
    const EvpackSlot last = shfl_slot(x1[u ? u - 1 : 0], 31);
    if (lane == 0) prev = u ? last : edge;
    const long long i0 = 2 * j;
    ev[u][0] = evpack_event(i0 < a.cnt, x0[u], i0 > 0, prev);
    ev[u][1] = evpack_event(i0 + 1 < a.cnt, x1[u], true, x0[u]);
    if (j < a.kh) {
      evpack_store_pair(a.packed, a.kh, j, ev[u][0], ev[u][1]);
      evpack_count(a.counts, i0, a.cnt, x0[u], i0 > 0, prev);
      evpack_count(a.counts, i0 + 1, a.cnt, x1[u], true, x0[u]);
    }
    const unsigned b0 = __ballot_sync(kFull, ev[u][0].esc);
    const unsigned b1 = __ballot_sync(kFull, ev[u][1].esc);
    esc_bits |= (ev[u][0].esc ? 1u : 0u) << (2 * u);
    esc_bits |= (ev[u][1].esc ? 1u : 0u) << (2 * u + 1);
    before[u] = run + __popc(b0 & lt) + __popc(b1 & lt);
    run += __popc(b0) + __popc(b1);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  if (warp == 0) {
    int agg = 0;
    for (int w = 0; w < kWarps; ++w) agg += s_warp[w];
    int prefix = 0;
    if (t == 0) {
      if (lane == 0) evpack_publish(sc, 0, agg, EVPACK_INCLUSIVE);
    } else {
      if (lane == 0) evpack_publish(sc, t, agg, EVPACK_AGGREGATE);
      prefix = evpack_lookback(sc, t, lane);
      if (lane == 0) evpack_publish(sc, t, prefix + agg, EVPACK_INCLUSIVE);
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (t == tiles - 1) {
        a.tail[0] = prefix + agg;
        a.tail[1] = prefix + agg > a.esc_cap ? 1 : 0;
      }
    }
  }
  __syncthreads();
  if (!esc_bits) return;
  long long slot0 = s_prefix;
  for (int w = 0; w < warp; ++w) slot0 += s_warp[w];
#pragma unroll
  for (int u = 0; u < EVPACK_ITEMS; ++u) {
    const long long i0 = 2 * (base + u * 32 + lane);
    long long slot = slot0 + before[u];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (esc_bits >> (2 * u + h) & 1u)
        evpack_store_escape(a.esc, a.esc_cap, slot++, i0 + h, ev[u][h]);
  }
}

// The sort's two key and two slot buffers, the look-back's scratch and
// CUB's, at 256-byte aligned offsets of one allocation.
struct Layout {
  size_t keys, keys_alt, slots, slots_alt, lookback, temp, temp_bytes, total;
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// m keys (at least 2 kh, so the encode's 8-byte loads stay inside)
Layout layout(long long m, int end_bit, long long tiles) {
  Layout l{};
  cub::DoubleBuffer<unsigned> k(nullptr, nullptr);
  cub::DoubleBuffer<int> v(nullptr, nullptr);
  cub::DeviceRadixSort::SortPairs(nullptr, l.temp_bytes, k, v, (int)m, 0,
                                  end_bit);
  const size_t arr = align256((size_t)m * 4);
  l.keys_alt = l.keys + arr;
  l.slots = l.keys_alt + arr;
  l.slots_alt = l.slots + arr;
  l.lookback = l.slots_alt + arr;
  l.temp = l.lookback + align256(evpack_scratch_ints(tiles) * 4);
  l.total = l.temp + l.temp_bytes;
  return l;
}

// the bits of the largest live lane, n_lanes - 1 (at least one)
int lane_bits(int n_lanes) {
  int b = 1;
  while ((n_lanes - 1) >> b) ++b;
  return b;
}

}  // namespace

// The scratch bytes one encode of k slots over n_lanes lanes takes.
extern "C" long long andix_evpack_scratch_bytes(long long k, int n_lanes) {
  const long long kh = (k + 1) / 2;
  return (long long)layout(2 * kh, lane_bits(n_lanes),
                           evpack_tiles(kh, EVPACK_TILE_PAIRS))
      .total;
}

// lane, q, s, len: the walk's buffers (at least k slots); out: packed
// int32[3][kh] (kh = (k + 1) / 2), then esc int32[4][esc_cap], counts
// int32[n_lanes], n_esc and the overflow flag; scratch:
// andix_evpack_scratch_bytes(k, n_lanes) bytes, 256-byte aligned.
// Returns the first CUDA error of the three steps.
extern "C" int andix_evpack_encode(const int* lane, const int* q,
                                   const int* s, const int* len,
                                   long long cnt, long long k, int n_lanes,
                                   int esc_cap, int* out, void* scratch,
                                   long long scratch_bytes, void* stream) {
  if (k <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long kh = (k + 1) / 2, m = 2 * kh;
  const long long tiles = evpack_tiles(kh, EVPACK_TILE_PAIRS);
  const int end_bit = lane_bits(n_lanes);
  const Layout l = layout(m, end_bit, tiles);
  if ((long long)l.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  unsigned* key_buf = reinterpret_cast<unsigned*>(base + l.keys);
  int* slot_buf = reinterpret_cast<int*>(base + l.slots);
  int* lookback = reinterpret_cast<int*>(base + l.lookback);
  int* esc = out + 3 * kh;
  const long long zero_a = 4LL * esc_cap + n_lanes;
  const long long zero_b = evpack_status_ints(tiles);
  const long long most = cnt > zero_a + zero_b ? cnt : zero_a + zero_b;
  const long long key_blocks = (most + 4LL * kKeyThreads - 1) /
                               (4 * kKeyThreads);  // about 4 items a thread
  evpack_key_kernel<<<(unsigned)key_blocks, kKeyThreads, 0, st>>>(
      lane, cnt, key_buf, slot_buf, esc, zero_a, lookback, zero_b);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cub::DoubleBuffer<unsigned> keys(
      key_buf, reinterpret_cast<unsigned*>(base + l.keys_alt));
  cub::DoubleBuffer<int> slots(slot_buf,
                               reinterpret_cast<int*>(base + l.slots_alt));
  if (cnt > 0) {
    size_t temp_bytes = l.temp_bytes;  // m's: enough for cnt <= m
    err = (int)cub::DeviceRadixSort::SortPairs(
        base + l.temp, temp_bytes, keys, slots, (int)cnt, 0, end_bit, st);
    if (!err) err = (int)cudaGetLastError();
    if (err) return err;
  }
  EncodeArgs a{keys.Current(), slots.Current(), q, s, len, cnt, kh, esc_cap,
               out, esc, esc + 4LL * esc_cap, esc + 4LL * esc_cap + n_lanes};
  evpack_encode_kernel<<<(unsigned)tiles, EVPACK_THREADS, 0, st>>>(
      a, evpack_scratch(lookback, tiles), tiles);
  return (int)cudaGetLastError();
}
