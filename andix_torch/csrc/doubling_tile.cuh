// Bodies of the suffix-array doubling loop's two kernels, shared by the
// CUDA kernels (doubling.cu) and their host twin (doubling_cpu.cpp, built
// with g++ for the tests).
//
// sa_keys builds one int64 sort key an entry (sd_initial_key,
// sd_round_key), non-negative (the texts' symbols are), and the entry's
// suffix as the sort's value.  sa_rerank takes the sorted keys and
// suffixes and, in one pass, gives every entry its bucket head: the
// running max, over the entries whose key differs from the one before
// ("changed"), of a value that ascends with the entry (its sorted
// position in a full round, its SA slot in a tail round).  It counts the tied entries (groups of two or
// more) and, in the tail modes, compacts them in order by an exclusive
// count of the tied flags.  Both scans are one monoid, SdState (max,
// sum), folded across tiles by a decoupled look-back with the protocol
// of flag_scan_tile.cuh: a status word (0 not yet, SD_AGGREGATE,
// SD_INCLUSIVE) and two payloads a tile (its aggregate, its inclusive
// prefix); a payload is stored before its status, with a fence between;
// a reader polls the status, fences, then reads the payload past the L1
// cache.

#pragma once

#ifdef __CUDACC__
#define SD_HD __host__ __device__ __forceinline__
#else
#define SD_HD inline
#endif

// sa_keys modes
#define SD_KEY_WIDTH1 0   // the symbol (any alphabet)
#define SD_KEY_CLAMPED 1  // symbol << 30 over the next three, clamped
#define SD_KEY_WIDE 2     // base dense codes big-endian; padding by position
#define SD_KEY_FULL 3     // rank[i] (n + 1) + rank[i + k] + 1, every i
#define SD_KEY_TAIL 4     // the same at i = sa_vals[j], the tied entries

// sa_rerank modes
#define SD_FULL 0     // rank[order[t]] = head, sa[t] = order[t], count
#define SD_TAIL 1     // sa[slots] = sav, rank[sav] = head, compact
#define SD_EXTRACT 2  // the tied slots of sa under rank, compact

#define SD_PACK_CLAMP 1023
#define SD_PAD_BASE (1 << 20)
#define SD_AGGREGATE 1
#define SD_INCLUSIVE 2
#define SD_PAY 2  // ints a payload: head, tied

// The dense code of one symbol (doubling.py's _initial_ranks_plain): the
// block alphabet {!,#,;,A,C,G,T} to 1..7, separator 256 + g to 8 + g,
// capped at maxcode (padding takes the cap), anything else 0.
SD_HD long long sd_code(int s, long long maxcode) {
  switch (s) {
    case 33: return 1;
    case 35: return 2;
    case 59: return 3;
    case 65: return 4;
    case 67: return 5;
    case 71: return 6;
    case 84: return 7;
    default: break;
  }
  if (s >= 256) {
    const long long c = 8 + (long long)(s - 256);
    return c < maxcode ? c : maxcode;
  }
  return 0;
}

// The window value of symbol s: its dense code in wide mode (maxcode
// from the base width), the symbol itself otherwise.
SD_HD int sd_window_value(int mode, int s, int base) {
  return mode == SD_KEY_WIDE ? (int)sd_code(s, (1LL << (62 / base)) - 1) : s;
}

// The initial key of position i (symbol s) from its window w[j], the
// window value of s[i + j], 0 past the end (1 symbol in width-1 mode, 4
// clamped, `base` codes wide).
SD_HD long long sd_initial_key(int mode, const int* w, int s, long long i,
                               int base) {
  if (mode == SD_KEY_WIDTH1) return s;
  if (mode == SD_KEY_CLAMPED) {
    long long key = (long long)s << 30;
    for (int j = 1; j < 4; ++j) {
      const long long c = w[j] < SD_PACK_CLAMP ? w[j] : SD_PACK_CLAMP;
      key |= c << (30 - 10 * j);
    }
    return key;
  }
  if (s >= SD_PAD_BASE) return (1LL << 62) + i;
  const int bits = 62 / base;
  long long key = 0;
  for (int j = 0; j < base; ++j) key = (key << bits) | w[j];
  return key;
}

// sa_keys also writes each entry's suffix (i in the initial and full
// modes, sa_vals[j] in the tail mode) as the sort's int32 value, so the
// sort hands the rerank its suffixes in sorted order.
//
// A round's key of suffix i: (rank[i], rank[i + k] or -1 past the end),
// both below n, packed as rank[i] (n + 1) + rank[i + k] + 1 (< 2^62 for
// n < 2^31).
SD_HD long long sd_round_key(const int* rank, long long i, long long n,
                             long long k) {
  const long long r2 = i + k < n ? (long long)rank[i + k] + 1 : 0;
  return (long long)rank[i] * (n + 1) + r2;
}

struct SdArgs {
  int mode;
  long long m;            // entries
  const long long* keys;  // FULL, TAIL: the sorted keys [m]
  const int* order;       // FULL, TAIL: their suffixes, sorted with them
  const int* slots;       // TAIL: the tied SA slots, ascending [m]
  int* rank;              // FULL, TAIL: written; EXTRACT: read
  int* sa;                 // FULL, TAIL: written; EXTRACT: read
  int* slots_out;          // TAIL, EXTRACT: the still-tied slots
  int* savals_out;         // TAIL, EXTRACT: their suffixes
  int* tied_out;           // [1] the tied count
};

// (running max of the heads, count of tied entries)
struct SdState {
  int head, tied;
};

SD_HD SdState sd_identity() { return {-1, 0}; }

SD_HD SdState sd_combine(const SdState& a, const SdState& b) {
  return {a.head > b.head ? a.head : b.head, a.tied + b.tied};
}

// the key entry t is grouped by
SD_HD long long sd_key_at(const SdArgs& a, long long t) {
  return a.mode == SD_EXTRACT ? (long long)a.rank[a.sa[t]] : a.keys[t];
}

// the value a group's first entry makes the group's head
SD_HD int sd_val_at(const SdArgs& a, long long t) {
  return a.mode == SD_TAIL ? a.slots[t] : (int)t;
}

// Entry t's own state from its key and its neighbours' (kp at t - 1, kn
// at t + 1; ignored at the ends); *tied receives its tied flag.
SD_HD SdState sd_entry(long long t, long long m, long long kp, long long k,
                       long long kn, int val, int* tied) {
  const bool changed = t == 0 || k != kp;
  *tied = !changed || (t + 1 < m && kn == k) ? 1 : 0;
  return {changed ? val : -1, *tied};
}

// The outputs of entry t: its head, its place among the tied entries
// (the exclusive count) and its tied flag.
SD_HD void sd_emit(const SdArgs& a, long long t, int head, int pos, int tied,
                   int val) {
  if (a.mode == SD_FULL) {
    const int o = a.order[t];
    a.sa[t] = o;
    a.rank[o] = head;
  } else if (a.mode == SD_TAIL) {
    const int sv = a.order[t];
    a.sa[val] = sv;
    a.rank[sv] = head;
    if (tied) {
      a.slots_out[pos] = val;
      a.savals_out[pos] = sv;
    }
  } else if (tied) {
    a.slots_out[pos] = (int)t;
    a.savals_out[pos] = a.sa[t];
  }
}

struct SdScratch {
  int* status;   // [tiles]
  int* counter;  // the next tile id
  int* agg;      // [tiles, SD_PAY]
  int* incl;     // [tiles, SD_PAY]
};

SD_HD long long sd_tiles(long long m, long long tile) {
  return (m + tile - 1) / tile;
}

// scratch layout: status [tiles], the counter, padding to 16 bytes, then
// the aggregates and the inclusive prefixes; the first sd_status_ints
// ints must be zero when the pass starts
SD_HD long long sd_status_ints(long long tiles) {
  return (tiles + 1 + 3) / 4 * 4;
}

SD_HD long long sd_scratch_ints(long long tiles) {
  return sd_status_ints(tiles) + 2 * tiles * SD_PAY;
}

SD_HD SdScratch sd_scratch(int* base, long long tiles) {
  const long long st = sd_status_ints(tiles);
  return {base, base + tiles, base + st, base + st + tiles * SD_PAY};
}

// Publishes tile t's aggregate or inclusive prefix: payload, fence, status.
SD_HD void sd_publish(const SdScratch& sc, long long t, const SdState& x,
                      int status) {
  int* p = (status == SD_INCLUSIVE ? sc.incl : sc.agg) + t * SD_PAY;
#ifdef __CUDA_ARCH__
  __stcg(reinterpret_cast<int2*>(p), make_int2(x.head, x.tied));
  __threadfence();
  *reinterpret_cast<volatile int*>(sc.status + t) = status;
#else
  p[0] = x.head;
  p[1] = x.tied;
  sc.status[t] = status;
#endif
}

// Reads a published payload (its status must have been seen first).
SD_HD SdState sd_read(const SdScratch& sc, long long t, int status) {
  const int* p = (status == SD_INCLUSIVE ? sc.incl : sc.agg) + t * SD_PAY;
#ifdef __CUDA_ARCH__
  const int2 x = __ldcg(reinterpret_cast<const int2*>(p));
  return {x.x, x.y};
#else
  return {p[0], p[1]};
#endif
}

#ifdef __CUDACC__
__device__ __forceinline__ SdState sd_shfl_up(const SdState& x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.head, d),
          __shfl_up_sync(0xffffffffu, x.tied, d)};
}

__device__ __forceinline__ SdState sd_shfl_xor(const SdState& x, int d) {
  return {__shfl_xor_sync(0xffffffffu, x.head, d),
          __shfl_xor_sync(0xffffffffu, x.tied, d)};
}

__device__ __forceinline__ SdState sd_shfl(const SdState& x, int src) {
  return {__shfl_sync(0xffffffffu, x.head, src),
          __shfl_sync(0xffffffffu, x.tied, src)};
}
#endif

// The exclusive prefix of tile t > 0 from its predecessors' published
// states (fs_lookback's protocol).  On the card one warp calls it: lane L
// reads the status of tile e - 32 + L for a window ending at e (tiles
// below 0 count as an inclusive identity), waits until the tiles above
// the nearest inclusive prefix (all 32 without one) have published, and
// the window's states from there on are reduced by shuffles (max and sum
// commute, so the order does not matter).  Without an inclusive prefix in
// the window, the next window ends at its first tile.  The host twin
// reads the same windows one tile at a time (its tiles run in counter
// order, so every predecessor has published).
SD_HD SdState sd_lookback(const SdScratch& sc, long long t, int lane) {
  SdState excl = sd_identity();
  for (long long e = t;; e -= 32) {
#ifdef __CUDA_ARCH__
    const long long j = e - 32 + lane;
    const volatile int* ps = sc.status + (j >= 0 ? j : 0);
    int st = j >= 0 ? *ps : SD_INCLUSIVE;
    unsigned inc;
    while (true) {
      const unsigned zero = __ballot_sync(0xffffffffu, st == 0);
      inc = __ballot_sync(0xffffffffu, st == SD_INCLUSIVE);
      if (zero == 0 || (inc != 0 && __clz((int)inc) < __clz((int)zero)))
        break;
      __nanosleep(32);
      if (st == 0) st = *ps;
    }
    __threadfence();
    const int nearest = inc ? 31 - __clz((int)inc) : 0;
    SdState v = j >= 0 && lane >= nearest ? sd_read(sc, j, st)
                                          : sd_identity();
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v = sd_combine(v, sd_shfl_xor(v, d));
    excl = sd_combine(v, excl);
    if (inc) return excl;
#else
    (void)lane;
    bool inc = false;
    for (long long j = e - 1; j >= e - 32 && !inc; --j) {
      const int st = j >= 0 ? sc.status[j] : SD_INCLUSIVE;
      excl = sd_combine(j >= 0 ? sd_read(sc, j, st) : sd_identity(), excl);
      inc = st == SD_INCLUSIVE;
    }
    if (inc) return excl;
#endif
  }
}
