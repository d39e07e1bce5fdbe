// Event bodies of the packed event fetch, shared by the CUDA kernels
// (evpack.cu, a thread a pair of events) and their host twin
// (evpack_cpu.cpp, built with g++ for the tests, one caller that takes
// every pair of a block in order).
//
// Semantics are those of andix/chain/evpack.py:_encode_fn over the first
// k slots of the walk's four int32 event buffers, cnt of them live, in
// the stable lane-major order that a sort by lane gave (lane_s: the
// sorted lanes, dead slots keyed n_lanes so they sort last; order: the
// buffer slot of each sorted position):
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
//     index, the first esc_cap of them kept;
//   * counts[l] = live events of lane l.

#pragma once

#ifdef __CUDACC__
#define EVPACK_HD __host__ __device__ __forceinline__
#else
#define EVPACK_HD inline
#endif

#define EVPACK_BIAS 32768
// pairs of events a block of the kernels (and of the twin) takes
#define EVPACK_PAIRS 256

struct EvpackIn {
  const int* lane_s;      // [k] lanes in sorted order
  const long long* order; // [k] buffer slot of each sorted position
  const int* q;           // the walk's event buffers, read at order[i]
  const int* s;
  const int* len;
  long long cnt;  // live events (the first cnt sorted positions)
  long long k;    // slots encoded
};

struct EvpackEvent {
  long long dq, dd;
  int len;
  bool esc;
};

// sorted position i < cnt
EVPACK_HD EvpackEvent evpack_event(const EvpackIn& in, long long i) {
  const long long src = in.order[i];
  const long long q = in.q[src];
  long long dq = q, dd = (long long)in.s[src] - q;
  if (i > 0 && in.lane_s[i - 1] == in.lane_s[i]) {
    const long long p = in.order[i - 1];
    const long long pq = in.q[p];
    dq -= pq;
    dd -= (long long)in.s[p] - pq;
  }
  EvpackEvent e;
  e.dq = dq;
  e.dd = dd;
  e.len = in.len[src];
  e.esc = dq < 0 || dq > 0xFFFF - 1 || dd < -EVPACK_BIAS ||
          dd >= EVPACK_BIAS || e.len < 0 || e.len > 0xFFFF;
  return e;
}

// the pair j's two events into packed[3][kh]; returns its escape bits
// (bit 0: event 2j, bit 1: event 2j + 1)
EVPACK_HD int evpack_pair(const EvpackIn& in, long long j, long long kh,
                          int* packed) {
  unsigned f[3][2];
  int bits = 0;
  for (int h = 0; h < 2; ++h) {
    const long long i = 2 * j + h;
    f[0][h] = 0;
    f[1][h] = EVPACK_BIAS;
    f[2][h] = 0;
    if (i < in.cnt) {
      const EvpackEvent e = evpack_event(in, i);
      if (e.esc) {
        f[0][h] = 0xFFFF;
        f[1][h] = 0;
        bits |= 1 << h;
      } else {
        f[0][h] = (unsigned)e.dq;
        f[1][h] = (unsigned)(e.dd + EVPACK_BIAS);
        f[2][h] = (unsigned)e.len;
      }
    }
  }
  for (int r = 0; r < 3; ++r)
    packed[r * kh + j] = (int)(f[r][0] | (f[r][1] << 16));
  return bits;
}

// the pair j's escape records from its bits, the first into slot; those
// at slots past esc_cap are dropped
EVPACK_HD void evpack_escapes(const EvpackIn& in, long long j, int bits,
                              long long slot, long long esc_cap, int* esc) {
  for (int h = 0; h < 2; ++h) {
    if (!(bits >> h & 1)) continue;
    if (slot < esc_cap) {
      const long long i = 2 * j + h;
      const EvpackEvent e = evpack_event(in, i);
      esc[slot] = (int)i;
      esc[esc_cap + slot] = (int)e.dq;
      esc[2 * esc_cap + slot] = (int)e.dd;
      esc[3 * esc_cap + slot] = e.len;
    }
    ++slot;
  }
}

// first sorted position < cnt whose lane is >= l
EVPACK_HD long long evpack_lower(const int* lane_s, long long cnt, int l) {
  long long lo = 0, hi = cnt;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (lane_s[mid] < l)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

EVPACK_HD int evpack_lane_count(const int* lane_s, long long cnt, int l) {
  return (int)(evpack_lower(lane_s, cnt, l + 1) -
               evpack_lower(lane_s, cnt, l));
}
