// Packed event fetch on the card: the walk's int32 event buffers, sorted
// lane-major, encoded at 6 B an event with an escape list.
//
// Replaces andix/chain/evpack.py:_encode_fn (an XLA program there, used by
// andix/subject_pipeline.py:_fetch_walk on the subject-index schedule),
// after the sort: the wrapper (chain/evpack.py) sorts the lanes with
// torch.sort(stable=True), as andix does with jnp.sort, and hands this
// kernel the sorted lanes and each sorted position's buffer slot.
//
// What bounds it: bytes.  Per event it must read the slot, the lane and
// the (q, s, len) triple (16 B with the sort's index, counted as the
// event's 16 B) and write 6 B of fields; the reads go through the sort's
// permutation, so they are gathers, mostly of neighbours (a lane's events
// lie near each other in the buffer).  Three launches on one stream:
//   1. fields: a thread a pair of events (the pairing of two 16-bit
//      fields into one int32 needs no atomics that way) computes both
//      events' deltas (evpack_lane.cuh) from its own and the previous
//      sorted position, writes the three packed words, a byte of escape
//      bits, and the block's escape count (warp sums, then one per block);
//   2. scan: one block scans the blocks' escape counts into their first
//      slots, writes n_esc and the overflow flag, the per-lane counts (two
//      binary searches of the sorted lanes a lane) and zeroes the escape
//      records past n_esc;
//   3. escapes: a block with escapes scans its pairs' bits and writes
//      their records at ascending sorted index, as andix's cumsum slots
//      place them.
// The event bodies are in evpack_lane.cuh, shared with the host twin.

#include <cuda_runtime.h>

#include "evpack_lane.cuh"

namespace {

constexpr int kScanThreads = 1024;

// inclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); `sums` holds 32 ints of shared memory; every thread calls
__device__ int block_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int d = 1; d < 32; d *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? sums[lane] : 0;
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += sums[warp - 1];
  __syncthreads();  // sums may be reused
  return v;
}

__global__ void __launch_bounds__(EVPACK_PAIRS)
    fields_kernel(EvpackIn in, long long kh, int* __restrict__ packed,
                  unsigned char* __restrict__ bits,
                  int* __restrict__ block_esc) {
  __shared__ int sums[32];
  const long long j = (long long)blockIdx.x * EVPACK_PAIRS + threadIdx.x;
  int b = 0;
  if (j < kh) {
    b = evpack_pair(in, j, kh, packed);
    bits[j] = (unsigned char)b;
  }
  const int total = block_scan(__popc(b), sums);
  if (threadIdx.x == EVPACK_PAIRS - 1) block_esc[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ block_esc, int nb,
                int* __restrict__ block_off, const int* __restrict__ lane_s,
                long long cnt, int n_lanes, int* __restrict__ counts,
                int* __restrict__ esc, int esc_cap, int* __restrict__ tail) {
  __shared__ int sums[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int x = base + threadIdx.x;
    const int v = x < nb ? block_esc[x] : 0;
    const int incl = block_scan(v, sums);
    const int c = carry;
    if (x < nb) block_off[x] = c + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = c + incl;
    __syncthreads();
  }
  const int n_esc = carry;
  if (threadIdx.x == 0) {
    tail[0] = n_esc;
    tail[1] = n_esc > esc_cap ? 1 : 0;
  }
  for (int l = threadIdx.x; l < n_lanes; l += kScanThreads)
    counts[l] = evpack_lane_count(lane_s, cnt, l);
  for (int x = (n_esc < esc_cap ? n_esc : esc_cap) + threadIdx.x;
       x < esc_cap; x += kScanThreads)
    for (int r = 0; r < 4; ++r) esc[(long long)r * esc_cap + x] = 0;
}

__global__ void __launch_bounds__(EVPACK_PAIRS)
    escapes_kernel(EvpackIn in, long long kh,
                   const unsigned char* __restrict__ bits,
                   const int* __restrict__ block_esc,
                   const int* __restrict__ block_off, int esc_cap,
                   int* __restrict__ esc) {
  __shared__ int sums[32];
  if (block_esc[blockIdx.x] == 0) return;  // the whole block
  const long long j = (long long)blockIdx.x * EVPACK_PAIRS + threadIdx.x;
  const int b = j < kh ? bits[j] : 0;
  const int n = __popc(b);
  const int incl = block_scan(n, sums);
  if (b)
    evpack_escapes(in, j, b, (long long)block_off[blockIdx.x] + incl - n,
                   esc_cap, esc);
}

}  // namespace

// out: packed int32[3][kh] (kh = (k + 1) / 2), then esc int32[4][esc_cap],
// counts int32[n_lanes], n_esc and the overflow flag.  Scratch: block_esc
// and block_off int32[nb], bits uint8[kh], nb = ceil(kh / EVPACK_PAIRS).
extern "C" int andix_evpack_encode(const int* lane_s, const long long* order,
                                   const int* q, const int* s,
                                   const int* len, long long cnt,
                                   long long k, int n_lanes, int esc_cap,
                                   int* out, int* block_esc, int* block_off,
                                   unsigned char* bits, void* stream) {
  if (k <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long kh = (k + 1) / 2;
  const int nb = (int)((kh + EVPACK_PAIRS - 1) / EVPACK_PAIRS);
  int* esc = out + 3 * kh;
  int* counts = esc + 4LL * esc_cap;
  EvpackIn in{lane_s, order, q, s, len, cnt, k};
  fields_kernel<<<nb, EVPACK_PAIRS, 0, st>>>(in, kh, out, bits, block_esc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, kScanThreads, 0, st>>>(block_esc, nb, block_off, lane_s,
                                          cnt, n_lanes, counts, esc, esc_cap,
                                          counts + n_lanes);
  err = (int)cudaGetLastError();
  if (err) return err;
  escapes_kernel<<<nb, EVPACK_PAIRS, 0, st>>>(in, kh, bits, block_esc,
                                              block_off, esc_cap, esc);
  return (int)cudaGetLastError();
}

extern "C" int andix_evpack_pairs() { return EVPACK_PAIRS; }
