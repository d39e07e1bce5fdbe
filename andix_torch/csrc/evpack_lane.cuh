// Bodies of the packed event fetch, shared by the CUDA kernels
// (evpack.cu) and their host twin (evpack_cpu.cpp, built with g++ for the
// tests).
//
// Semantics are those of andix/chain/evpack.py:_encode_fn over the first
// k slots of the walk's four int32 event buffers, cnt of them live (live
// lanes lie in [0, n_lanes)), in the stable lane-major order of a sort by
// lane, the dead slots after the live ones:
//   * per live event, dq = q - (the previous q of its lane, or 0 for its
//     lane's first) and dd = (s - q) - (the same of the previous event),
//     both in int64; it escapes when dq is outside [0, 0xFFFE], dd
//     outside [-BIAS, BIAS) or len outside [0, 0xFFFF];
//   * fields (dq16, dd16, len16) = (0xFFFF, 0, 0) for an escape, else
//     (dq, dd + BIAS, len); a dead slot, and the slot past an odd k,
//     carries those of an all-zero event after its lane's end, (0, BIAS,
//     0), as andix's zero-filled buffers give;
//   * packed[f][j] = field f of event 2j | field f of event 2j + 1 << 16;
//   * escape records (sorted index, dq, dd, len) at ascending sorted
//     index, the first esc_cap of them kept, the rest of the list zero;
//   * counts[l] = live events of lane l.
//
// The sort takes the cnt live slots alone, keyed by lane: a dead slot's
// event is fixed, so nothing is read at sorted positions from cnt on.
// The encode pass reads each live sorted position's lane and buffer
// slot, over kh = ceil(k / 2) pairs.  Escape slots are an exclusive count
// of the escapes in sorted order, folded across tiles by a decoupled
// look-back with the
// protocol of flag_scan_tile.cuh and doubling_tile.cuh: a status word (0
// not yet, EVPACK_AGGREGATE, EVPACK_INCLUSIVE) and two payloads a tile
// (its escape count, its inclusive count); a payload is stored before its
// status, with a fence between; a reader polls the status, fences, then
// reads the payload past the L1 cache.  The lane counts come from the
// sorted runs' edges: the position that starts a lane's run subtracts its
// index from that lane and adds it to the lane before; the last live
// position adds cnt to its own.  On zeroed counts each lane ends at its
// run's length; the additions are integers, so their order is free.

#pragma once

#ifdef __CUDACC__
#define EVPACK_HD __host__ __device__ __forceinline__
#else
#define EVPACK_HD inline
#endif

#define EVPACK_BIAS 32768
// the encode pass: threads a block, pairs of sorted positions a thread,
// pairs a tile (a block's)
#define EVPACK_THREADS 256
#define EVPACK_ITEMS 4
#define EVPACK_TILE_PAIRS (EVPACK_THREADS * EVPACK_ITEMS)
#define EVPACK_AGGREGATE 1
#define EVPACK_INCLUSIVE 2

// A sorted position's lane and (q, s, len) (those of its buffer slot).
struct EvpackSlot {
  int lane, q, s, len;
};

struct EvpackEvent {
  long long dq, dd;
  int len;
  bool esc;
  unsigned f[3];  // the 16-bit fields
};

// The event at a sorted position (live: before cnt) from its slot and,
// when it has one, the previous sorted position's.
EVPACK_HD EvpackEvent evpack_event(bool live, const EvpackSlot& x,
                                   bool has_prev, const EvpackSlot& p) {
  EvpackEvent e;
  e.dq = x.q;
  e.dd = (long long)x.s - x.q;
  e.len = x.len;
  if (has_prev && p.lane == x.lane) {
    e.dq -= p.q;
    e.dd -= (long long)p.s - p.q;
  }
  e.esc = live && (e.dq < 0 || e.dq > 0xFFFF - 1 || e.dd < -EVPACK_BIAS ||
                   e.dd >= EVPACK_BIAS || e.len < 0 || e.len > 0xFFFF);
  e.f[0] = 0;
  e.f[1] = EVPACK_BIAS;
  e.f[2] = 0;
  if (e.esc) {
    e.f[0] = 0xFFFF;
    e.f[1] = 0;
  } else if (live) {
    e.f[0] = (unsigned)e.dq;
    e.f[1] = (unsigned)(e.dd + EVPACK_BIAS);
    e.f[2] = (unsigned)e.len;
  }
  return e;
}

// pair j's three packed words into packed[3][kh]
EVPACK_HD void evpack_store_pair(int* packed, long long kh, long long j,
                                 const EvpackEvent& e0,
                                 const EvpackEvent& e1) {
  for (int r = 0; r < 3; ++r)
    packed[r * kh + j] = (int)(e0.f[r] | (e1.f[r] << 16));
}

// escape record `slot` (dropped at esc_cap and past) of sorted position i
EVPACK_HD void evpack_store_escape(int* esc, long long esc_cap,
                                   long long slot, long long i,
                                   const EvpackEvent& e) {
  if (slot >= esc_cap) return;
  esc[slot] = (int)i;
  esc[esc_cap + slot] = (int)e.dq;
  esc[2 * esc_cap + slot] = (int)e.dd;
  esc[3 * esc_cap + slot] = e.len;
}

EVPACK_HD void evpack_add(int* x, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(x, v);
#else
  *x += v;
#endif
}

// sorted position i's share of the lane counts (see the head)
EVPACK_HD void evpack_count(int* counts, long long i, long long cnt,
                            const EvpackSlot& x, bool has_prev,
                            const EvpackSlot& p) {
  if (i >= cnt) return;
  if (!has_prev || p.lane != x.lane) {
    evpack_add(counts + x.lane, -(int)i);
    if (has_prev) evpack_add(counts + p.lane, (int)i);
  }
  if (i == cnt - 1) evpack_add(counts + x.lane, (int)cnt);
}

struct EvpackScratch {
  int* status;   // [tiles]
  int* counter;  // the next tile id
  int* agg;      // [tiles]
  int* incl;     // [tiles]
};

EVPACK_HD long long evpack_tiles(long long kh, long long tile_pairs) {
  return (kh + tile_pairs - 1) / tile_pairs;
}

// scratch layout: status [tiles], the counter, padding to 16 bytes, the
// aggregates and the inclusive counts; the first evpack_status_ints ints
// must be zero when the pass starts
EVPACK_HD long long evpack_status_ints(long long tiles) {
  return (tiles + 1 + 3) / 4 * 4;
}

EVPACK_HD long long evpack_scratch_ints(long long tiles) {
  return evpack_status_ints(tiles) + 2 * tiles;
}

EVPACK_HD EvpackScratch evpack_scratch(int* base, long long tiles) {
  const long long st = evpack_status_ints(tiles);
  return {base, base + tiles, base + st, base + st + tiles};
}

// Publishes tile t's escape count or inclusive count: payload, fence,
// status.
EVPACK_HD void evpack_publish(const EvpackScratch& sc, long long t, int x,
                              int status) {
  int* p = (status == EVPACK_INCLUSIVE ? sc.incl : sc.agg) + t;
#ifdef __CUDA_ARCH__
  __stcg(p, x);
  __threadfence();
  *reinterpret_cast<volatile int*>(sc.status + t) = status;
#else
  *p = x;
  sc.status[t] = status;
#endif
}

// Reads a published payload (its status must have been seen first).
EVPACK_HD int evpack_read(const EvpackScratch& sc, long long t, int status) {
  const int* p = (status == EVPACK_INCLUSIVE ? sc.incl : sc.agg) + t;
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// The escapes before tile t > 0, from its predecessors' published counts
// (sd_lookback's windows).  On the card one warp calls it: lane L reads
// the status of tile e - 32 + L for a window ending at e (tiles below 0
// count as an inclusive 0), waits until the tiles above the nearest
// inclusive count (all 32 without one) have published, and the window's
// counts from there on are summed by shuffles.  Without an inclusive count
// in the window, the next window ends at its first tile.  The host twin
// reads the same windows one tile at a time; it calls this only once every
// predecessor has published (returns -1 if one has not).
EVPACK_HD int evpack_lookback(const EvpackScratch& sc, long long t, int lane) {
  int excl = 0;
  for (long long e = t;; e -= 32) {
#ifdef __CUDA_ARCH__
    const long long j = e - 32 + lane;
    const volatile int* ps = sc.status + (j >= 0 ? j : 0);
    int st = j >= 0 ? *ps : EVPACK_INCLUSIVE;
    unsigned inc;
    while (true) {
      const unsigned zero = __ballot_sync(0xffffffffu, st == 0);
      inc = __ballot_sync(0xffffffffu, st == EVPACK_INCLUSIVE);
      if (zero == 0 || (inc != 0 && __clz((int)inc) < __clz((int)zero)))
        break;
      __nanosleep(32);
      if (st == 0) st = *ps;
    }
    __threadfence();
    const int nearest = inc ? 31 - __clz((int)inc) : 0;
    int v = j >= 0 && lane >= nearest ? evpack_read(sc, j, st) : 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (inc) return excl;
#else
    (void)lane;
    for (long long j = e - 1; j >= e - 32; --j) {
      if (j < 0) return excl;
      const int st = sc.status[j];
      if (st == 0) return -1;
      excl += evpack_read(sc, j, st);
      if (st == EVPACK_INCLUSIVE) return excl;
    }
#endif
  }
}
