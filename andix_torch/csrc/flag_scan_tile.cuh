// Tile body and look-back of the one-pass flag scan, shared by the CUDA
// kernel (flag_scan.cu) and its host twin (flag_scan_cpu.cpp, built with
// g++ for the tests).
//
// The scan is the inclusive scan of the flag-window monoid _fs_combine
// (andix/esa/scans.py:22-43) over (value int32, flag bool, payload
// int32).  Positions are "virtual": scan position i is virtual position
// i + pad, and a chunk of FS_ITEMS virtual positions starting at a
// multiple of FS_ITEMS maps to one aligned chunk of memory.  Forward, pad
// is 0 and virtual position v is memory position v.  In reverse, pad is
// (-n) mod FS_ITEMS, nv = n + pad, and v is memory position nv - 1 - v,
// so a chunk is the mirror of an aligned memory chunk.  Virtual positions
// that fall outside [0, n) in memory hold (INF, 0, -1), which leaves every
// state unchanged at the start of the scan and is never stored at its end.
//
// A tile is FS_ITEMS * threads consecutive virtual positions; each thread
// holds one chunk.  Tiles publish their state for the look-back in
// scratch: a status word (0 not yet, FS_AGGREGATE, FS_INCLUSIVE) and two
// payloads of FS_PAY ints (the tile's aggregate, its inclusive prefix).
// A payload is stored before its status, with a fence between; a reader
// polls the status, fences, then reads the payload past the L1 cache.

#pragma once

#ifdef __CUDACC__
#define FS_HD __host__ __device__ __forceinline__
#else
#define FS_HD inline
#endif

#define FS_INF 2147483647
#define FS_ITEMS 16  // positions a thread: one 16-byte load of flags
#define FS_PAY 8     // ints a payload: the 5 fields, padded to 32 bytes
#define FS_AGGREGATE 1
#define FS_INCLUSIVE 2

struct FS {
  int k, pre, g, sa, suf;
};

FS_HD FS fs_identity() { return {0, FS_INF, FS_INF, -1, FS_INF}; }

FS_HD int fs_min(int a, int b) { return a < b ? a : b; }

// _fs_combine (scans.py:22-43): a comes before b in scan order
FS_HD FS fs_combine(const FS& a, const FS& b) {
  const bool has1 = a.k > 0, has2 = b.k > 0;
  const int bridge = fs_min(a.suf, b.pre);
  FS o;
  o.k = fs_min(a.k + b.k, 2);
  o.pre = has1 ? a.pre : fs_min(a.pre, b.pre);
  o.sa = has2 ? b.sa : a.sa;
  o.g = has2 ? (b.k >= 2 ? b.g : (has1 ? bridge : FS_INF)) : a.g;
  o.suf = has2 ? b.suf : (has1 ? bridge : FS_INF);
  return o;
}

// _fs_step (scans.py:191-203): combine with one element
FS_HD FS fs_step(const FS& s, int val, int fl, int sv) {
  const bool has = s.k > 0;
  const int bridge = fs_min(s.suf, val);
  FS o;
  o.k = fs_min(s.k + fl, 2);
  o.pre = has ? s.pre : fs_min(s.pre, val);
  o.sa = fl ? sv : s.sa;
  o.g = fl ? (has ? bridge : FS_INF) : s.g;
  o.suf = fl ? FS_INF : (has ? bridge : FS_INF);
  return o;
}

struct FsArgs {
  const int* values;
  const unsigned char* flags;
  const int* sa_vals;
  long long n;   // positions
  long long nv;  // virtual positions: n + pad
};

struct FsOut {
  int* k;
  int* g;
  int* sa;
  int* suf;
};

struct FsScratch {
  int* status;   // [tiles]
  int* counter;  // the next tile id
  int* agg;      // [tiles, FS_PAY]
  int* incl;     // [tiles, FS_PAY]
};

FS_HD long long fs_pad(long long n, int reverse) {
  return reverse ? (FS_ITEMS - n % FS_ITEMS) % FS_ITEMS : 0;
}

FS_HD long long fs_tiles(long long n, int reverse, long long tile) {
  return (n + fs_pad(n, reverse) + tile - 1) / tile;
}

// scratch layout: status [tiles], the counter, padding to 16 bytes, then
// the aggregates and the inclusive prefixes; the first fs_status_ints
// ints must be zero when the scan starts
FS_HD long long fs_status_ints(long long tiles) {
  return (tiles + 1 + 3) / 4 * 4;
}

FS_HD long long fs_scratch_ints(long long tiles) {
  return fs_status_ints(tiles) + 2 * tiles * FS_PAY;
}

FS_HD FsScratch fs_scratch(int* base, long long tiles) {
  const long long st = fs_status_ints(tiles);
  return {base, base + tiles, base + st, base + st + tiles * FS_PAY};
}

// memory position of the chunk's lowest address
template <bool REV>
FS_HD long long fs_chunk_mem(const FsArgs& a, long long vs) {
  return REV ? a.nv - FS_ITEMS - vs : vs;
}

// One chunk's inputs in memory order: values, payloads and the flag bytes
// packed four to a word (as the 16-byte load leaves them, so a thread
// keeps 36 registers of input, not 48).
struct FsChunk {
  int v[FS_ITEMS];
  int s[FS_ITEMS];
  unsigned f[FS_ITEMS / 4];
};

// the element at scan offset j of the chunk (a compile-time index once
// the loops are unrolled)
template <bool REV>
FS_HD FS fs_step_at(const FS& st, const FsChunk& c, int j) {
  const int m = REV ? FS_ITEMS - 1 - j : j;
  return fs_step(st, c.v[m], (c.f[m >> 2] >> (8 * (m & 3))) & 0xffu ? 1 : 0,
                 c.s[m]);
}

// Loads the chunk of virtual positions [vs, vs + FS_ITEMS) element by
// element (the host twin's path; the kernel loads a warp's chunks
// together, flag_scan.cu).
template <bool REV>
FS_HD void fs_load_chunk(const FsArgs& a, long long vs, FsChunk& c) {
  const long long m0 = fs_chunk_mem<REV>(a, vs);
  for (int m = 0; m < FS_ITEMS; ++m) {
    const long long i = m0 + m;
    const bool in = i >= 0 && i < a.n;
    c.v[m] = in ? a.values[i] : FS_INF;
    c.s[m] = in ? a.sa_vals[i] : -1;
    if ((m & 3) == 0) c.f[m >> 2] = 0;
    c.f[m >> 2] |= (in && a.flags[i] != 0 ? 1u : 0u) << (8 * (m & 3));
  }
}

// the fold of one chunk
template <bool REV>
FS_HD FS fs_fold(const FsChunk& c) {
  FS acc = fs_identity();
#pragma unroll
  for (int j = 0; j < FS_ITEMS; ++j) acc = fs_step_at<REV>(acc, c, j);
  return acc;
}

// Re-scans one chunk from the state before it; the outputs come out in
// memory order.
template <bool REV>
FS_HD void fs_scan_chunk(FS st, const FsChunk& c, int* rk, int* rg,
                         int* rsa, int* rsu) {
#pragma unroll
  for (int j = 0; j < FS_ITEMS; ++j) {
    st = fs_step_at<REV>(st, c, j);
    const int m = REV ? FS_ITEMS - 1 - j : j;
    rk[m] = st.k;
    rg[m] = st.g;
    rsa[m] = st.sa;
    rsu[m] = st.suf;
  }
}

// Re-scans one chunk and stores its outputs element by element (the host
// twin's path).
template <bool REV>
FS_HD void fs_emit(const FsArgs& a, const FsOut& o, long long vs, FS st,
                   const FsChunk& c) {
  int rk[FS_ITEMS], rg[FS_ITEMS], rsa[FS_ITEMS], rsu[FS_ITEMS];
  fs_scan_chunk<REV>(st, c, rk, rg, rsa, rsu);
  const long long m0 = fs_chunk_mem<REV>(a, vs);
  for (int m = 0; m < FS_ITEMS; ++m) {
    const long long i = m0 + m;
    if (i >= 0 && i < a.n) {
      o.k[i] = rk[m];
      o.g[i] = rg[m];
      o.sa[i] = rsa[m];
      o.suf[i] = rsu[m];
    }
  }
}

// Publishes tile t's aggregate or inclusive prefix: payload, fence, status.
FS_HD void fs_publish(const FsScratch& sc, long long t, const FS& x,
                      int status) {
  int* p = (status == FS_INCLUSIVE ? sc.incl : sc.agg) + t * FS_PAY;
#ifdef __CUDA_ARCH__
  __stcg(reinterpret_cast<int4*>(p), make_int4(x.k, x.pre, x.g, x.sa));
  __stcg(reinterpret_cast<int4*>(p) + 1, make_int4(x.suf, 0, 0, 0));
  __threadfence();
  *reinterpret_cast<volatile int*>(sc.status + t) = status;
#else
  p[0] = x.k;
  p[1] = x.pre;
  p[2] = x.g;
  p[3] = x.sa;
  p[4] = x.suf;
  sc.status[t] = status;
#endif
}

// Reads a published payload (its status must have been seen first).
FS_HD FS fs_read(const FsScratch& sc, long long t, int status) {
  const int* p = (status == FS_INCLUSIVE ? sc.incl : sc.agg) + t * FS_PAY;
#ifdef __CUDA_ARCH__
  const int4 x = __ldcg(reinterpret_cast<const int4*>(p));
  const int4 y = __ldcg(reinterpret_cast<const int4*>(p) + 1);
  return {x.x, x.y, x.z, x.w, y.x};
#else
  return {p[0], p[1], p[2], p[3], p[4]};
#endif
}

#ifdef __CUDACC__
__device__ __forceinline__ FS fs_shfl_up(const FS& x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.k, d),
          __shfl_up_sync(0xffffffffu, x.pre, d),
          __shfl_up_sync(0xffffffffu, x.g, d),
          __shfl_up_sync(0xffffffffu, x.sa, d),
          __shfl_up_sync(0xffffffffu, x.suf, d)};
}

__device__ __forceinline__ FS fs_shfl_down(const FS& x, int d) {
  return {__shfl_down_sync(0xffffffffu, x.k, d),
          __shfl_down_sync(0xffffffffu, x.pre, d),
          __shfl_down_sync(0xffffffffu, x.g, d),
          __shfl_down_sync(0xffffffffu, x.sa, d),
          __shfl_down_sync(0xffffffffu, x.suf, d)};
}

__device__ __forceinline__ FS fs_shfl(const FS& x, int src) {
  return {__shfl_sync(0xffffffffu, x.k, src),
          __shfl_sync(0xffffffffu, x.pre, src),
          __shfl_sync(0xffffffffu, x.g, src),
          __shfl_sync(0xffffffffu, x.sa, src),
          __shfl_sync(0xffffffffu, x.suf, src)};
}
#endif

// The exclusive prefix of tile t > 0 from its predecessors' published
// states, in scan order.  On the card one warp calls it: lane L reads the
// status of tile e - 32 + L for a window ending at e (tiles below 0 count
// as an inclusive identity), waits until the tiles above the nearest
// inclusive prefix (all 32 without one) have published, and the window's
// states from there on are folded in order by a shuffle reduction and put
// before what the earlier windows gave.  Without an inclusive prefix in
// the window, the next window ends at its first tile.  The host twin
// reads the same windows one tile at a time (its tiles run in counter
// order, so every predecessor has published).
FS_HD FS fs_lookback(const FsScratch& sc, long long t, int lane) {
  FS excl = fs_identity();
  for (long long e = t;; e -= 32) {
#ifdef __CUDA_ARCH__
    const long long j = e - 32 + lane;
    const volatile int* ps = sc.status + (j >= 0 ? j : 0);
    int st = j >= 0 ? *ps : FS_INCLUSIVE;
    unsigned inc;
    while (true) {
      // the window is usable once every tile above its nearest inclusive
      // prefix has published (all of them, without one)
      const unsigned zero = __ballot_sync(0xffffffffu, st == 0);
      inc = __ballot_sync(0xffffffffu, st == FS_INCLUSIVE);
      if (zero == 0 || (inc != 0 && __clz((int)inc) < __clz((int)zero)))
        break;
      __nanosleep(32);
      if (st == 0) st = *ps;
    }
    __threadfence();
    const int nearest = inc ? 31 - __clz((int)inc) : 0;
    FS val = j >= 0 && lane >= nearest ? fs_read(sc, j, st) : fs_identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const FS o = fs_shfl_down(val, d);
      if (lane + d < 32) val = fs_combine(val, o);
    }
    excl = fs_combine(fs_shfl(val, 0), excl);
    if (inc) return excl;
#else
    (void)lane;
    bool inc = false;
    FS win = fs_identity();
    for (long long j = e - 1; j >= e - 32 && !inc; --j) {
      const int st = j >= 0 ? sc.status[j] : FS_INCLUSIVE;
      win = fs_combine(j >= 0 ? fs_read(sc, j, st) : fs_identity(), win);
      inc = st == FS_INCLUSIVE;
    }
    excl = fs_combine(win, excl);
    if (inc) return excl;
#endif
  }
}
