// Tile bodies of the FASTA ingest and of the joint block's padded text,
// shared by the CUDA kernels (ingest.cu) and their host twin
// (ingest_cpu.cpp, built with g++ for the tests).
//
// The ingest reads the raw bytes of one or more FASTA files laid end to
// end, each followed by one '\n' that the host inserts (so every file's
// last line ends, and its first byte, a '>', starts a line).  Byte i is a
// header start (H) when it is '>' and byte i - 1 is '\n' (or i = 0).  A
// header line runs from its H to the next '\n', inclusive; every other
// byte is in a sequence region.  In a sequence region a non-whitespace
// byte counts in R; of those, a/c/g/t in either case are kept (K, written
// upper-cased to the compacted output) and C/G in either case count in G;
// any byte that is not a letter, '-' or '*' counts in V (a file that
// holds one is refused by the host).  An H whose next byte is whitespace
// (an empty name, or '>' at the end of a line) counts in V too.
//
// The scan state IG is the composition of the bytes' effects on (header
// flag, K, G, R, V, header count): a segment either contains an H or a
// '\n' (an "event", after which the header flag is known: 1 after an H, 0
// after a '\n') or not.  Counts of the bytes before the first event apply
// only when the flag entering the segment is 0 (`pre`); the others are
// fixed (`post`).  The composition is associative, so the kernel scans it
// with a decoupled look-back as flag_scan_tile.cuh does.  The whole buffer
// starts outside a header, so the state before byte i has counts pre +
// post and flag ev ? hout : 0.
//
// Records: at each H the exclusive counts (K, G, R, V) and i go to row nh
// of the record table (6 int32 a row), and the position of the '\n' that
// ends the header line to that row's second field; row `cap` receives the
// totals (nh, K, G, R, V).  Rows past `cap` are not written (the host runs
// again with a larger table).  Record r's kept bytes are
// [K_r, K_{r+1}) of the compacted output.
//
// The RS pass writes each record's revcomp + '#' + forward + 0 at
// 2 K_r + 2 r (sequence.catcomp's layout, one 0 after each record); in
// join mode each file's records joined by '!' as one RS, in the same
// bytes (below).
// The block text writes the int32 symbols of a joint block from its bytes
// (backend.pad_symbols(layout.sym, padded_n)): the byte, 256 + s at
// separator s (a 0 byte at ends[s]), pad_base + k past n.

#pragma once

#ifdef __CUDACC__
#define IG_HD __host__ __device__ __forceinline__
#else
#define IG_HD inline
#endif

#define IG_ITEMS 16        // bytes a chunk: one 16-byte load
#define IG_CHUNKS 4        // chunks a thread: 64 consecutive bytes
#define IG_SPAN (IG_ITEMS * IG_CHUNKS)
#define IG_PAY 12          // ints a payload: the 11 fields, padded to 48 B
#define IG_REC 6           // ints a record row: h, e, K, G, R, V
#define IG_AGGREGATE 1
#define IG_INCLUSIVE 2
#define IG_SEPARATOR_BASE 256

struct IG {
  int ev, hout, nh;
  int pk, pg, pr, pv;  // before the first event, if the flag entering is 0
  int qk, qg, qr, qv;  // from the first event on
};

IG_HD IG ig_identity() { return {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}; }

// a comes before b
IG_HD IG ig_combine(const IG& a, const IG& b) {
  IG o;
  o.ev = a.ev | b.ev;
  o.hout = b.ev ? b.hout : a.hout;
  o.nh = a.nh + b.nh;
  if (!a.ev) {
    o.pk = a.pk + b.pk;
    o.pg = a.pg + b.pg;
    o.pr = a.pr + b.pr;
    o.pv = a.pv + b.pv;
    o.qk = b.qk;
    o.qg = b.qg;
    o.qr = b.qr;
    o.qv = b.qv;
  } else {
    const int on = a.hout == 0 ? 1 : 0;  // b's leading bytes are sequence
    o.pk = a.pk;
    o.pg = a.pg;
    o.pr = a.pr;
    o.pv = a.pv;
    o.qk = a.qk + on * b.pk + b.qk;
    o.qg = a.qg + on * b.pg + b.qg;
    o.qr = a.qr + on * b.pr + b.qr;
    o.qv = a.qv + on * b.pv + b.qv;
  }
  return o;
}

IG_HD bool ig_ws(int c) { return c == 32 || (c >= 9 && c <= 13); }

// a/c/g/t in either case
IG_HD bool ig_keep(int c) {
  const int l = c | 32;
  return l == 'a' || l == 'c' || l == 'g' || l == 't';
}

IG_HD bool ig_gc(int c) {
  const int l = c | 32;
  return l == 'c' || l == 'g';
}

// a letter, '-' or '*': what a sequence region may hold besides whitespace
IG_HD bool ig_allowed(int c) {
  return (unsigned)((c | 32) - 'a') < 26u || c == '-' || c == '*';
}

// The counts a sequence-region byte adds (K, G, R, V).
IG_HD void ig_counts(int c, int& dk, int& dg, int& dr, int& dv) {
  dk = dg = dr = dv = 0;
  if (ig_ws(c)) return;
  dr = 1;
  if (ig_keep(c)) {
    dk = 1;
    dg = ig_gc(c) ? 1 : 0;
  } else if (!ig_allowed(c)) {
    dv = 1;
  }
}

// Appends byte c (prev: the byte before it, '\n' at the buffer's start;
// next: the byte after it, '\n' past the end) to state s.
IG_HD IG ig_step(IG s, int c, int prev, int next) {
  if (c == '>' && prev == '\n') {
    s.ev = 1;
    s.hout = 1;
    s.nh += 1;
    s.qv += ig_ws(next) ? 1 : 0;
    return s;
  }
  if (c == '\n') {
    s.ev = 1;
    s.hout = 0;
    return s;
  }
  int dk, dg, dr, dv;
  ig_counts(c, dk, dg, dr, dv);
  if (!s.ev) {
    s.pk += dk;
    s.pg += dg;
    s.pr += dr;
    s.pv += dv;
  } else if (s.hout == 0) {
    s.qk += dk;
    s.qg += dg;
    s.qr += dr;
    s.qv += dv;
  }
  return s;
}

// A chunk of a thread's bytes, four to a word as a 16-byte load leaves
// them: byte j at positions i0 + j for j < len, with the byte before and
// the byte after ('\n' outside the buffer).
struct IgChunk {
  unsigned w[IG_ITEMS / 4];
  int prev, next;
  int len;
};

IG_HD int ig_byte(const IgChunk& ch, int j) {
  return (ch.w[j >> 2] >> (8 * (j & 3))) & 0xff;
}

// s followed by the chunk's bytes
IG_HD IG ig_fold(IG s, const IgChunk& ch) {
#pragma unroll
  for (int j = 0; j < IG_ITEMS; ++j) {
    if (j < ch.len) {
      const int prev = j ? ig_byte(ch, j - 1) : ch.prev;
      const int next = j + 1 < ch.len ? ig_byte(ch, j + 1) : ch.next;
      s = ig_step(s, ig_byte(ch, j), prev, next);
    }
  }
  return s;
}

// The state before a chunk, as concrete values.
struct IgRun {
  int hdr, nh, k, g, r, v;
};

IG_HD IgRun ig_run(const IG& excl) {
  return {excl.ev ? excl.hout : 0, excl.nh, excl.pk + excl.qk,
          excl.pg + excl.qg, excl.pr + excl.qr, excl.pv + excl.qv};
}

struct IgOut {
  unsigned char* seq;  // kept bytes: seq[k - seq_base]
  long long seq_base;
  int* rec;            // [cap + 1, IG_REC]
  int cap;
};

// Re-scans one chunk from the state before it: kept bytes, record rows.
IG_HD IgRun ig_emit(IgRun st, const IgChunk& ch, long long i0,
                    const IgOut& o) {
#pragma unroll
  for (int j = 0; j < IG_ITEMS; ++j) {
    if (j >= ch.len) break;
    const int c = ig_byte(ch, j);
    const int prev = j ? ig_byte(ch, j - 1) : ch.prev;
    const int next = j + 1 < ch.len ? ig_byte(ch, j + 1) : ch.next;
    if (c == '>' && prev == '\n') {
      if (st.nh < o.cap) {
        int* row = o.rec + (long long)st.nh * IG_REC;
        row[0] = (int)(i0 + j);
        row[2] = st.k;
        row[3] = st.g;
        row[4] = st.r;
        row[5] = st.v;
      }
      st.v += ig_ws(next) ? 1 : 0;
      st.nh += 1;
      st.hdr = 1;
    } else if (st.hdr) {
      if (c == '\n') {
        if (st.nh - 1 < o.cap)
          o.rec[(long long)(st.nh - 1) * IG_REC + 1] = (int)(i0 + j);
        st.hdr = 0;
      }
    } else {
      int dk, dg, dr, dv;
      ig_counts(c, dk, dg, dr, dv);
      if (dk) o.seq[st.k - o.seq_base] = (unsigned char)(c & ~32);
      st.k += dk;
      st.g += dg;
      st.r += dr;
      st.v += dv;
    }
  }
  return st;
}

// the totals row, from the state after the buffer's last byte
IG_HD void ig_totals(const IgRun& st, const IgOut& o) {
  int* row = o.rec + (long long)o.cap * IG_REC;
  row[0] = st.nh;
  row[1] = 0;
  row[2] = st.k;
  row[3] = st.g;
  row[4] = st.r;
  row[5] = st.v;
}

// Loads the chunk of positions [i0, i0 + IG_ITEMS) of x[0, m) byte by
// byte (the twin's path, and the kernel's at the buffer's end).  A
// thread's span is IG_CHUNKS chunks from i0 = its first position.
IG_HD void ig_load_chunk(const unsigned char* x, long long m, long long i0,
                         IgChunk& ch) {
  ch.len = 0;
  for (int q = 0; q < IG_ITEMS / 4; ++q) ch.w[q] = 0;
  for (int j = 0; j < IG_ITEMS && i0 + j < m; ++j) {
    ch.w[j >> 2] |= (unsigned)x[i0 + j] << (8 * (j & 3));
    ch.len = j + 1;
  }
  ch.prev = i0 > 0 && i0 - 1 < m ? x[i0 - 1] : '\n';
  ch.next = i0 + IG_ITEMS < m ? x[i0 + IG_ITEMS] : '\n';
}

// ---- the decoupled look-back (flag_scan_tile.cuh's protocol) ----------

struct IgScratch {
  int* status;   // [tiles]
  int* counter;  // the next tile id
  int* agg;      // [tiles, IG_PAY]
  int* incl;     // [tiles, IG_PAY]
};

IG_HD long long ig_status_ints(long long tiles) {
  return (tiles + 1 + 3) / 4 * 4;
}

IG_HD long long ig_scratch_ints(long long tiles) {
  return ig_status_ints(tiles) + 2 * tiles * IG_PAY;
}

IG_HD IgScratch ig_scratch(int* base, long long tiles) {
  const long long st = ig_status_ints(tiles);
  return {base, base + tiles, base + st, base + st + tiles * IG_PAY};
}

IG_HD void ig_publish(const IgScratch& sc, long long t, const IG& x,
                      int status) {
  int* p = (status == IG_INCLUSIVE ? sc.incl : sc.agg) + t * IG_PAY;
#ifdef __CUDA_ARCH__
  int4* q = reinterpret_cast<int4*>(p);
  __stcg(q, make_int4(x.ev, x.hout, x.nh, x.pk));
  __stcg(q + 1, make_int4(x.pg, x.pr, x.pv, x.qk));
  __stcg(q + 2, make_int4(x.qg, x.qr, x.qv, 0));
  __threadfence();
  *reinterpret_cast<volatile int*>(sc.status + t) = status;
#else
  const int v[11] = {x.ev, x.hout, x.nh, x.pk, x.pg, x.pr,
                     x.pv, x.qk, x.qg, x.qr, x.qv};
  for (int k = 0; k < 11; ++k) p[k] = v[k];
  sc.status[t] = status;
#endif
}

IG_HD IG ig_read(const IgScratch& sc, long long t, int status) {
  const int* p = (status == IG_INCLUSIVE ? sc.incl : sc.agg) + t * IG_PAY;
#ifdef __CUDA_ARCH__
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 a = __ldcg(q), b = __ldcg(q + 1), c = __ldcg(q + 2);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z};
#else
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10]};
#endif
}

#ifdef __CUDACC__
__device__ __forceinline__ IG ig_shfl_up(const IG& x, int d) {
  const unsigned m = 0xffffffffu;
  return {__shfl_up_sync(m, x.ev, d), __shfl_up_sync(m, x.hout, d),
          __shfl_up_sync(m, x.nh, d), __shfl_up_sync(m, x.pk, d),
          __shfl_up_sync(m, x.pg, d), __shfl_up_sync(m, x.pr, d),
          __shfl_up_sync(m, x.pv, d), __shfl_up_sync(m, x.qk, d),
          __shfl_up_sync(m, x.qg, d), __shfl_up_sync(m, x.qr, d),
          __shfl_up_sync(m, x.qv, d)};
}

__device__ __forceinline__ IG ig_shfl_down(const IG& x, int d) {
  const unsigned m = 0xffffffffu;
  return {__shfl_down_sync(m, x.ev, d), __shfl_down_sync(m, x.hout, d),
          __shfl_down_sync(m, x.nh, d), __shfl_down_sync(m, x.pk, d),
          __shfl_down_sync(m, x.pg, d), __shfl_down_sync(m, x.pr, d),
          __shfl_down_sync(m, x.pv, d), __shfl_down_sync(m, x.qk, d),
          __shfl_down_sync(m, x.qg, d), __shfl_down_sync(m, x.qr, d),
          __shfl_down_sync(m, x.qv, d)};
}

__device__ __forceinline__ IG ig_shfl(const IG& x, int src) {
  const unsigned m = 0xffffffffu;
  return {__shfl_sync(m, x.ev, src), __shfl_sync(m, x.hout, src),
          __shfl_sync(m, x.nh, src), __shfl_sync(m, x.pk, src),
          __shfl_sync(m, x.pg, src), __shfl_sync(m, x.pr, src),
          __shfl_sync(m, x.pv, src), __shfl_sync(m, x.qk, src),
          __shfl_sync(m, x.qg, src), __shfl_sync(m, x.qr, src),
          __shfl_sync(m, x.qv, src)};
}
#endif

// The exclusive prefix of tile t > 0 from its predecessors' published
// states (fs_lookback's windows of 32 tiles: one warp on the card, one
// tile at a time in the host twin).
IG_HD IG ig_lookback(const IgScratch& sc, long long t, int lane) {
  IG excl = ig_identity();
  for (long long e = t;; e -= 32) {
#ifdef __CUDA_ARCH__
    const long long j = e - 32 + lane;
    const volatile int* ps = sc.status + (j >= 0 ? j : 0);
    int st = j >= 0 ? *ps : IG_INCLUSIVE;
    unsigned inc;
    while (true) {
      const unsigned zero = __ballot_sync(0xffffffffu, st == 0);
      inc = __ballot_sync(0xffffffffu, st == IG_INCLUSIVE);
      if (zero == 0 || (inc != 0 && __clz((int)inc) < __clz((int)zero)))
        break;
      __nanosleep(32);
      if (st == 0) st = *ps;
    }
    __threadfence();
    const int nearest = inc ? 31 - __clz((int)inc) : 0;
    IG val = j >= 0 && lane >= nearest ? ig_read(sc, j, st) : ig_identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const IG o = ig_shfl_down(val, d);
      if (lane + d < 32) val = ig_combine(val, o);
    }
    excl = ig_combine(ig_shfl(val, 0), excl);
    if (inc) return excl;
#else
    (void)lane;
    bool inc = false;
    IG win = ig_identity();
    for (long long j = e - 1; j >= e - 32 && !inc; --j) {
      const int st = j >= 0 ? sc.status[j] : IG_INCLUSIVE;
      win = ig_combine(j >= 0 ? ig_read(sc, j, st) : ig_identity(), win);
      inc = st == IG_INCLUSIVE;
    }
    excl = ig_combine(win, excl);
    if (inc) return excl;
#endif
  }
}

// ---- the RS pass ------------------------------------------------------

struct IgRecords {
  const int* rec;  // [cap + 1, IG_REC]
  int n;           // records (nh <= cap)
  int k_total;
};

IG_HD long long ig_rs_off(const IgRecords& r, int q) {
  return q < r.n ? 2LL * r.rec[(long long)q * IG_REC + 2] + 2LL * q
                 : 2LL * r.k_total + 2LL * r.n;
}

// the record holding RS byte o (o < ig_rs_off(r, r.n))
IG_HD int ig_rs_record(const IgRecords& r, long long o) {
  int lo = 0, hi = r.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (ig_rs_off(r, mid) <= o)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// sequence.revcomp's table
IG_HD unsigned char ig_revcomp(int b) {
  return (unsigned char)(b < 'A' ? ';' : b ^ ((b & 2) ? 4 : 21));
}

// A walk over RS bytes in ascending order: record q's bytes are
// [off, next), 2 len + 2 of them, its kept bytes seq[k0, k0 + len) with
// k0 = off / 2 - q.
struct IgRsCursor {
  int q;
  long long off, next;
};

IG_HD IgRsCursor ig_rs_seek(const IgRecords& r, long long o) {
  const int q = ig_rs_record(r, o);
  return {q, ig_rs_off(r, q), ig_rs_off(r, q + 1)};
}

// RS byte o (at or past the cursor's record start), the cursor moved on
// to its record
IG_HD unsigned char ig_rs_byte(const IgRecords& r, const unsigned char* seq,
                               IgRsCursor& c, long long o) {
  while (o >= c.next && c.q + 1 < r.n) {
    ++c.q;
    c.off = c.next;
    c.next = ig_rs_off(r, c.q + 1);
  }
  const long long local = o - c.off;
  if (local < 0) return 0;  // bytes before the first header own no RS
  const long long len = (c.next - c.off) / 2 - 1;
  const long long k0 = c.off / 2 - c.q;
  if (local < len) return ig_revcomp(seq[k0 + len - 1 - local]);
  if (local == len) return '#';
  if (local <= 2 * len) return seq[k0 + local - len - 1];
  return 0;
}

// ---- the RS pass in join mode -----------------------------------------
//
// Under -j the units are the files: file f owns the records whose headers
// lie in [starts[f], starts[f + 1]) (the first file also those before
// it).  Its records [r0, r1) join with one '!' between two records into
// J = K_r1 - K_r0 + (r1 - r0) - 1 symbols, and its RS, revcomp + '#' +
// joined + 0 (2 J + 2 bytes, '!' reversed to ';'), takes the RS bytes
// [ig_rs_off(r0), ig_rs_off(r1)) that its records' RS take without -j.
// Joined symbol h, counted in half-offsets from the buffer's start, lies
// in the record q with the largest ig_rs_off(q) / 2 <= h: seq[K_q + h -
// ig_rs_off(q) / 2], or '!' just past that record's kept bytes.

struct IgFiles {
  const long long* starts;  // each file's first raw byte, ascending
  int n;
};

// the first record whose header is at or after raw byte p
IG_HD int ig_record_at(const IgRecords& r, long long p) {
  int lo = 0, hi = r.n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (r.rec[(long long)mid * IG_REC] < p)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// file f's first record (r.n past the last file)
IG_HD int ig_unit_first(const IgRecords& r, const IgFiles& fl, int f) {
  if (f <= 0) return 0;
  return f < fl.n ? ig_record_at(r, fl.starts[f]) : r.n;
}

// the file that owns record q
IG_HD int ig_unit_of(const IgRecords& r, const IgFiles& fl, int q) {
  const long long p = r.rec[(long long)q * IG_REC];
  int lo = 0, hi = fl.n;  // the files that start at or before p
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (fl.starts[mid] <= p)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo > 0 ? lo - 1 : 0;
}

// A walk over one file's RS bytes: its records [r0, r1) and RS bytes
// [u, unext); q the record of the last joined symbol read, whose
// half-offsets are [lo_h, hi_h) (q < 0: not yet found).
struct IgJoinCursor {
  int r0, r1, q;
  long long u, unext, lo_h, hi_h;
};

IG_HD IgJoinCursor ig_join_seek(const IgRecords& r, const IgFiles& fl,
                                long long o) {
  const int f = ig_unit_of(r, fl, ig_rs_record(r, o));
  IgJoinCursor c;
  c.r0 = ig_unit_first(r, fl, f);
  c.r1 = ig_unit_first(r, fl, f + 1);
  c.q = -1;
  c.u = ig_rs_off(r, c.r0);
  c.unext = ig_rs_off(r, c.r1);
  c.lo_h = c.hi_h = 0;
  return c;
}

// joined symbol h of the cursor's file, the cursor moved to its record
IG_HD unsigned char ig_join_symbol(const IgRecords& r,
                                   const unsigned char* seq, IgJoinCursor& c,
                                   long long h) {
  if (c.q < 0) {
    int lo = c.r0, hi = c.r1 - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (ig_rs_off(r, mid) / 2 <= h)
        lo = mid;
      else
        hi = mid - 1;
    }
    c.q = lo;
    c.lo_h = ig_rs_off(r, lo) / 2;
    c.hi_h = ig_rs_off(r, lo + 1) / 2;
  }
  while (h < c.lo_h && c.q > c.r0) {
    --c.q;
    c.hi_h = c.lo_h;
    c.lo_h = ig_rs_off(r, c.q) / 2;
  }
  while (h >= c.hi_h && c.q + 1 < c.r1) {
    ++c.q;
    c.lo_h = c.hi_h;
    c.hi_h = ig_rs_off(r, c.q + 1) / 2;
  }
  const long long local = h - c.lo_h;
  return local < c.hi_h - c.lo_h - 1 ? seq[c.lo_h - c.q + local] : '!';
}

// RS byte o in join mode, the cursor moved to its file (seek it at o
// first)
IG_HD unsigned char ig_join_byte(const IgRecords& r, const IgFiles& fl,
                                 const unsigned char* seq, IgJoinCursor& c,
                                 long long o) {
  if (o >= c.unext) c = ig_join_seek(r, fl, o);
  const long long local = o - c.u;
  if (local < 0) return 0;  // bytes before the first header own no RS
  const long long j = (c.unext - c.u) / 2 - 1, h0 = c.u / 2;
  if (local < j)
    return ig_revcomp(ig_join_symbol(r, seq, c, h0 + j - 1 - local));
  if (local == j) return '#';
  if (local <= 2 * j) return ig_join_symbol(r, seq, c, h0 + local - j - 1);
  return 0;
}

// ---- the joint block's padded symbols ---------------------------------

// the first s with ends[s] >= i
IG_HD int ig_lower_bound(const long long* ends, int nseg, long long i) {
  int lo = 0, hi = nseg;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ends[mid] < i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Symbol i of the padded text, b being its byte (i < n); each 0 byte adds
// 1 to zeros, and one at no separator 1 to stray too.
IG_HD int ig_block_symbol(long long n, const long long* ends, int nseg,
                          int pad_base, long long i, int b, int& zeros,
                          int& stray) {
  if (i >= n) return pad_base + (int)(i - n);
  if (b) return b;
  ++zeros;
  const int s = ig_lower_bound(ends, nseg, i);
  if (s < nseg && ends[s] == i) return IG_SEPARATOR_BASE + s;
  ++stray;
  return 0;
}
