// Segment reduction of many state columns over one array of SORTED group
// ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_segment_reduce_pallas` /
// `segment_reduce` of trino_tpu/ops/pallas_kernels.py (SUM, MIN or MAX of
// one state column over segments given by non-decreasing int32 group ids:
// the engine's sorted gids, steps of at most 1 plus a trailing jump of
// invalid lanes to the dump segment), together with the per-column loop
// around it in trino_tpu/ops/hashtable.py `_hash_segment_reduce_impl` and
// the sort of the state columns into gid order before it. One call reduces
// every state column of a page: each column has its own dtype and kind, and
// may be read through the permutation `order` that sorted the gids
// (column i's row r is cols[i][order[r]]), so the caller gathers nothing.
// Every segment that no row names holds the identity of the reduction.
// Integer sums wrap in two's complement. Group ids outside
// [0, num_segments) are dropped.
//
// Bound: memory. The gids (4 B) and `order` (8 B) are read once per row,
// each column's value once per row and each column's segment written once;
// there is one operation per row and column. At the aggregation page of
// TPC-H q1 at SF1 (262,144 rows, 15 int64 SUM states, `order` given,
// 262,145 segments) that is 262,144 x 132 B + 262,145 x 120 B = 66.06 MB:
// 0.0197 ms at 3.35 TB/s; at its merge (8,388,608 rows) 2.11 GB, 0.631 ms.
//
// Design. The TPU kernel walks a sequential grid and accumulates into a
// 128-aligned output window with one-hot matrix products, because the TPU
// grid runs in order and its matrix unit is the fast path. Neither holds on
// Hopper: blocks run in parallel and in no order. Two launches per call,
// whatever the columns' dtypes and kinds; a table of column descriptors
// (pointer in, pointer out, dtype and kind) rides in the launch parameters
// (up to kInline columns) or in a device buffer the call fills with one
// host-to-device copy.
//   1. tile_kernel, one block per 2,048-row tile (kTile). The block loads
//      its tile's gids, and `order` when given, ONCE (16-byte vector loads
//      when the tile is whole and aligned), into registers: each thread
//      holds 8 consecutive rows. It works out the tile's segment structure
//      once: the run heads in each thread, each thread's first and last
//      gid, and the reset flags and shuffle steps of the block-wide
//      segmented scan. Then it walks the columns through a ring of kStages
//      column tiles in shared memory, filled by cp.async kStages - 1
//      columns ahead of the one it reduces: thread t copies rows t,
//      t + 256, ... (coalesced, and through `order`, read the same way,
//      all 8 gathers in flight at once) into stages laid out so that these
//      copies and each thread's 16-byte reads of its own 8 rows meet no
//      bank conflict. A column's reduction is a sequential pass over the
//      thread's 8 rows, a warp segmented scan in shuffles and one barrier
//      for the warps' partials, which also publishes the next column's
//      copies. Every segment wholly inside the tile is written straight
//      to the output; the partials of the tile's first and last segment,
//      which may go on in a neighbouring tile, go to the carry buffer (two
//      per tile and column, in tile order), unless the call has one tile.
//      The identity goes into every segment no row names, each once: a
//      gap between two gids is written by the tile that holds the row
//      after it, while the column's copies are in flight, but only within
//      the 2,048-segment chunks (kChunk) that also hold a named segment
//      (at most two chunks per gap); every chunk that no gid falls into is
//      written whole by one block, chunk j by block j mod the grid, after
//      its columns. Whether a chunk is unnamed, a 32-ary search of the
//      sorted gids by warp 0 says (unless tile j names it), one round per
//      column, its probe in flight while the column reduces. So a long
//      gap, such as the dump gap [groups, capacity) of a merge, is spread
//      over the whole grid.
//      A call of fewer than kSplitBelowTiles tiles is latency-bound, not
//      bound by its bytes: it splits its columns over up to 32 blocks per
//      tile (each reading the tile's gids again), as many columns side by
//      side as there are blocks.
//   2. carry_kernel (when there is more than one tile), a block per 256
//      carries and column. The carries are sorted by gid; each run of
//      equal gids is one segment that crosses a tile edge. A run of up to
//      kShortRun carries is folded by the thread at its head, in tile
//      order; up to kWarpRun by a warp, a longer one (the dump segment of
//      a merge spans thousands of tiles) by the whole block: each lane or
//      thread folds an equal share of the run in tile order, then an
//      in-order tree.
// Each output segment is written once: by the tile that holds it, by the
// fill, or (a tile's first and last segment) by the carry pass. The
// bytes: gids, `order` and each column read once per row (at calls of
// 32 tiles and more), each segment written once, plus 8 bytes per tile
// edge and column for the carries. No atomics:
// repeated runs give bit-identical results, floats included. A float sum
// associates by each row's position inside its aligned 2,048-row tile and
// by the tile's position inside its segment's run of tiles, never by the
// grid size or the SM count, so a problem laid at a tile edge inside a
// larger call reduces exactly as it does alone. Only sortedness is
// required of the gids; the steps-of-one property is not used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // consecutive rows per thread
constexpr int kTile = kThreads * kItems;      // rows per block
constexpr long long kChunk = 2048;            // segments per fill chunk
constexpr int kFillPerBlock = 4;              // fill chunks per block, at most
constexpr int kInline = 32;                   // descriptors passed by value
constexpr int kStages = 3;                    // column tiles in the ring
constexpr int kShortRun = 32;                 // carries one thread folds
constexpr int kWarpRun = 1024;                // carries one warp folds
constexpr long long kSplitBelowTiles = 32;    // see segment_reduce_columns

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

// One column, as the wrapper packs it: three int64 (24 bytes).
struct Column {
  const void* in;
  void* out;
  long long code;  // dtype * 3 + kind; dtype 0 int32, 1 int64, 2 float32,
                   // 3 float64; kind 0 sum, 1 min, 2 max
};

struct Params {
  const int32_t* gid;
  const long long* order;  // nullptr: row r of a column is col[r]
  long long n;
  long long num_segments;
  long long tiles;
  int ncols;
  int32_t* carry_gid;                 // 2 per tile
  unsigned long long* carry_val;      // per column, 2 per tile (raw bits)
  const Column* table;                // device table, or nullptr: `cols`
  Column cols[kInline];
};

__device__ __forceinline__ const Column& column(const Params& p, int c) {
  return p.table ? p.table[c] : p.cols[c];
}

__device__ __forceinline__ bool elem8(long long code) {
  return ((code / 3) & 1) != 0;  // int64 and float64
}

template <typename V> struct Limits;
template <> struct Limits<int32_t> {
  __device__ static int32_t lo() { return INT32_MIN; }
  __device__ static int32_t hi() { return INT32_MAX; }
};
template <> struct Limits<int64_t> {
  __device__ static int64_t lo() { return INT64_MIN; }
  __device__ static int64_t hi() { return INT64_MAX; }
};
template <> struct Limits<float> {
  __device__ static float lo() { return -INFINITY; }
  __device__ static float hi() { return INFINITY; }
};
template <> struct Limits<double> {
  __device__ static double lo() { return -INFINITY; }
  __device__ static double hi() { return INFINITY; }
};

template <typename V, int K>
__device__ __forceinline__ V identity() {
  if constexpr (K == kSum) {
    return V(0);
  } else if constexpr (K == kMin) {
    return Limits<V>::hi();
  } else {
    return Limits<V>::lo();
  }
}

// raw bits <-> values: a 4-byte value lives in the low half
__device__ __forceinline__ void from_bits(unsigned long long b, int32_t& v) {
  v = static_cast<int32_t>(static_cast<uint32_t>(b));
}
__device__ __forceinline__ void from_bits(unsigned long long b, int64_t& v) {
  v = static_cast<int64_t>(b);
}
__device__ __forceinline__ void from_bits(unsigned long long b, float& v) {
  v = __uint_as_float(static_cast<uint32_t>(b));
}
__device__ __forceinline__ void from_bits(unsigned long long b, double& v) {
  v = __longlong_as_double(static_cast<long long>(b));
}
template <typename V>
__device__ __forceinline__ V value_of(unsigned long long b) {
  V v;
  from_bits(b, v);
  return v;
}
__device__ __forceinline__ unsigned long long to_bits(int32_t v) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ unsigned long long to_bits(int64_t v) {
  return static_cast<unsigned long long>(v);
}
__device__ __forceinline__ unsigned long long to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}

template <typename V, int K>
__device__ __forceinline__ unsigned long long identity_bits() {
  return to_bits(identity<V, K>());
}

// The identity's raw bits for a column code.
__device__ unsigned long long identity_bits(long long code) {
  switch (code) {
    case 1: return identity_bits<int32_t, kMin>();
    case 2: return identity_bits<int32_t, kMax>();
    case 4: return identity_bits<int64_t, kMin>();
    case 5: return identity_bits<int64_t, kMax>();
    case 7: return identity_bits<float, kMin>();
    case 8: return identity_bits<float, kMax>();
    case 10: return identity_bits<double, kMin>();
    case 11: return identity_bits<double, kMax>();
    default: return 0;  // every SUM: 0 and 0.0 are all-zero bits
  }
}

// integer sums wrap in two's complement (signed overflow is undefined in
// C++, so add in the unsigned type of the same width)
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<unsigned long long>(a) +
                              static_cast<unsigned long long>(b));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }

template <typename V> __device__ __forceinline__ bool is_nan(V) {
  return false;
}
template <> __device__ __forceinline__ bool is_nan(float x) {
  return isnan(x);
}
template <> __device__ __forceinline__ bool is_nan(double x) {
  return isnan(x);
}

// `a` holds earlier rows than `b`; MIN and MAX propagate NaN
template <typename V, int K>
__device__ __forceinline__ V combine(V a, V b) {
  if constexpr (K == kSum) {
    return add(a, b);
  } else {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if constexpr (K == kMin) {
      return b < a ? b : a;
    } else {
      return b > a ? b : a;
    }
  }
}

template <typename V>
__device__ __forceinline__ V shfl_up(V v, int off) {
  if constexpr (sizeof(V) == 8) {
    return value_of<V>(__shfl_up_sync(0xffffffffu, to_bits(v), off));
  } else {
    return value_of<V>(__shfl_up_sync(
        0xffffffffu, static_cast<uint32_t>(to_bits(v)), off));
  }
}
template <typename V>
__device__ __forceinline__ V shfl_down(V v, int off) {
  if constexpr (sizeof(V) == 8) {
    return value_of<V>(__shfl_down_sync(0xffffffffu, to_bits(v), off));
  } else {
    return value_of<V>(__shfl_down_sync(
        0xffffffffu, static_cast<uint32_t>(to_bits(v)), off));
  }
}

template <typename V>
__device__ __forceinline__ void put(V* out, long long num_segments,
                                    long long g, V v) {
  if (g >= 0 && g < num_segments) out[g] = v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cp.async: a 4- or 8-byte copy from global to shared memory that this
// thread waits for (and alone reads) later
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool wide) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (wide) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Writes the raw identity `bits` into segments [lo, hi) of a column whose
// values are 8 (`wide`) or 4 bytes, with the block's threads in turn.
__device__ __forceinline__ void fill_range(void* out, bool wide,
                                           unsigned long long bits,
                                           long long lo, long long hi) {
  if (wide) {
    unsigned long long* o = static_cast<unsigned long long*>(out);
    for (long long s = lo + threadIdx.x; s < hi; s += kThreads) o[s] = bits;
  } else {
    uint32_t* o = static_cast<uint32_t*>(out);
    const uint32_t b = static_cast<uint32_t>(bits);
    for (long long s = lo + threadIdx.x; s < hi; s += kThreads) o[s] = b;
  }
}

// The segments of the gap between gids a < b (none named between them)
// that the tile owning the gap writes: those in the chunk of a and in the
// chunk of b, when a and b are named segments. Every other chunk of the gap
// holds no named segment and is written whole by the fill. Returns the two
// ranges [r[0], r[1]) and [r[2], r[3]), either possibly empty.
__device__ __forceinline__ void gap_ranges(long long a, long long b,
                                           long long ns, long long r[4]) {
  r[0] = r[1] = r[2] = r[3] = 0;
  if (a >= 0 && a < ns) {
    r[0] = a + 1;
    r[1] = min(b, min((a / kChunk + 1) * kChunk, ns));
  }
  if (b >= 0 && b < ns) {
    r[2] = max(max(a + 1, 0LL), max((b / kChunk) * kChunk, r[1]));
    r[3] = b;
  }
}

struct TileSmem {
  Column cols[kInline];        // the descriptors, when they ride in `p`
  int32_t first_gid[kThreads];
  int32_t last_gid[kThreads];
  int32_t warp_reset[kWarps];  // the warp's last lane starts its scan run
  int32_t warp_count[kWarps];  // gaps found by the warp
  int32_t ngaps;
  int32_t fill_mask;           // which of this block's chunks are unnamed
  unsigned long long agg[2][kWarps];  // warps' scan totals, by column parity
  int32_t gap_a[kTile + 1];    // the tile's gaps (a, b): no gid in between
  int32_t gap_b[kTile + 1];
  int32_t probe[2][kThreads];  // the block-wide search rounds' probes
};

// Dynamic shared memory of a tile block: the fixed part, then a ring of
// kStages column tiles, an 8-byte slot per row (see slot_of).
constexpr size_t kTileSmemBytes =
    sizeof(TileSmem) + static_cast<size_t>(kStages) * kTile * 8;

// A block-wide round of the search for chunk b's first row (see
// ChunkSearch): thread t probes row lo + t * step of [lo, hi]; `count` is
// how many probes lie below the chunk (from __syncthreads_count), and
// `probes` every thread's probed gid.
__device__ __forceinline__ void narrow(int count, long long step,
                                       const int32_t* probes, long long& lo,
                                       long long& hi, int32_t& hi_gid) {
  const long long qc = lo + count * step;
  if (count < kThreads && qc < hi) {
    hi = qc;
    hi_gid = probes[count];
  }
  if (count > 0) lo += (count - 1) * step + 1;
}

// A column's descriptor in the tile kernel: read from shared memory (or
// the device table), not through a pointer into the parameter space on
// every use.
__device__ __forceinline__ const Column& tile_column(const Params& p,
                                                     const TileSmem& sm,
                                                     int c) {
  return p.table ? p.table[c] : sm.cols[c];
}

// What one thread knows of its tile, worked out once for every column.
struct Rows {
  int32_t g[kItems];
  long long o[kItems];  // `order` at rows t, t + 256, ... (the copies')
  long long base;      // the tile's first row
  int nv;              // rows of this thread below n
  uint32_t heads;      // bit i: row i starts a new gid (i >= 1)
  int32_t fg, lg;      // the thread's first and last gid
  int32_t tile_fg, tile_lg;
  bool single;         // one gid over the thread's rows
  bool cont_in;        // the first gid goes on from the previous thread
  bool cont_out;       // the last gid goes on in the next thread
  bool alone;          // the call's only tile: no carries
  uint32_t take;       // bit s: the scan's step s combines
  bool need_prefix;    // the scan run began in an earlier warp
  int prefix_from;     // the first warp of that run
};

// The 8-byte slot of tile row r in a ring stage: 16-byte chunks of two
// rows, chunk c at c ^ ((c >> 3) & 7), so that the copies of rows t,
// t + 256, ... (a warp's 32 consecutive rows) and a thread's 16-byte reads
// of its own 8 rows both meet no bank conflict.
__device__ __forceinline__ int chunk_at(int c) { return c ^ ((c >> 3) & 7); }
__device__ __forceinline__ int slot_of(int r) {
  return (chunk_at(r >> 1) << 1) | (r & 1);
}

// Issues this thread's copies of a column into a ring stage: rows t,
// t + 256, ... of the tile (coalesced), col[order[r]] through `order`,
// else col[r]; rows at or past n are not copied (the reduction takes the
// identity there). A 4-byte value fills the low half of its slot.
template <bool kOrder>
__device__ __forceinline__ void issue_column(unsigned char* stage,
                                             const Column& c,
                                             const Rows& x, long long n) {
  const bool wide = elem8(c.code);
  const int size = wide ? 8 : 4;
  const unsigned char* in = static_cast<const unsigned char*>(c.in);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = i * kThreads + threadIdx.x;
    if (x.base + r < n) {
      const long long src = kOrder ? x.o[i] : x.base + r;
      copy_async(stage + slot_of(r) * 8, in + src * size, wide);
    }
  }
}

// Reduces one column of the tile from its ring stage: writes every segment
// wholly inside the tile and leaves the tile's first and last partial in
// carry[0], carry[1] (or, for the call's only tile, writes them too). One
// barrier; `parity` picks the half of sm.agg this column uses.
template <typename V, int K>
__device__ __forceinline__ void reduce_column(
    const Rows& x, const unsigned char* stage, V* out, long long ns,
    unsigned long long* carry, TileSmem& sm, int parity) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const ulonglong2* chunks = reinterpret_cast<const ulonglong2*>(stage);
  V v[kItems];
#pragma unroll
  for (int k = 0; k < kItems / 2; ++k) {
    const ulonglong2 pair = chunks[chunk_at(t * (kItems / 2) + k)];
    v[2 * k] = 2 * k < x.nv ? value_of<V>(pair.x) : identity<V, K>();
    v[2 * k + 1] = 2 * k + 1 < x.nv ? value_of<V>(pair.y) : identity<V, K>();
  }
  // sequential pass: the run of the first gid, the run of the last gid,
  // and every run strictly between (written now: it is inside the thread)
  V first = identity<V, K>();
  V cur = combine<V, K>(identity<V, K>(), v[0]);
  bool seen = false;
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
    if ((x.heads >> i) & 1u) {
      if (!seen) {
        first = cur;
        seen = true;
      } else {
        put(out, ns, x.g[i - 1], cur);
      }
      cur = combine<V, K>(identity<V, K>(), v[i]);
    } else {
      cur = combine<V, K>(cur, v[i]);
    }
  }
  // segmented scan of the last-run partials: after it, acc is the total of
  // gid lg over the rows of threads <= t
  V acc = cur;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const V pv = shfl_up(acc, 1 << s);
    if ((x.take >> s) & 1u) acc = combine<V, K>(pv, acc);
  }
  if (lane == 31) sm.agg[parity][warp] = to_bits(acc);
  __syncthreads();
  V prefix = identity<V, K>();  // the scan total at the previous warp's end
  if (warp > 0 && (x.need_prefix || lane == 0)) {
    prefix = value_of<V>(sm.agg[parity][x.prefix_from]);
    for (int w = x.prefix_from + 1; w < warp; ++w) {
      prefix = combine<V, K>(prefix, value_of<V>(sm.agg[parity][w]));
    }
  }
  if (x.need_prefix) acc = combine<V, K>(prefix, acc);
  V before = shfl_up(acc, 1);  // the scan total at the previous thread
  if (lane == 0) before = prefix;

  // the tile's first and last gid go to the carries, unless the tile is
  // the call's only one
  auto edge = [&](int slot, int32_t g, V value) {
    if (x.alone) {
      put(out, ns, g, value);
    } else {
      carry[slot] = to_bits(value);
    }
  };
  // this thread's first run ends inside it when it holds more than one gid
  if (!x.single) {
    const V total = x.cont_in ? combine<V, K>(before, first) : first;
    if (x.fg == x.tile_fg) {
      edge(0, x.fg, total);
    } else {
      put(out, ns, x.fg, total);
    }
  }
  // its last run ends at its last row unless the next thread goes on with
  // it
  if (t == kThreads - 1) {
    edge(1, x.lg, acc);
  } else if (!x.cont_out) {
    if (x.lg == x.tile_fg) {
      edge(0, x.lg, acc);
    } else {
      put(out, ns, x.lg, acc);
    }
  }
  if (t == 0 && x.tile_fg == x.tile_lg && !x.alone) {
    carry[0] = identity_bits<V, K>();
  }
}

__device__ __forceinline__ void reduce_dispatch(
    long long code, const Rows& x, const unsigned char* stage, void* out,
    long long ns, unsigned long long* carry, TileSmem& sm, int parity) {
#define SR_CASE(C, V, K)                                                  \
  case C:                                                                 \
    reduce_column<V, K>(x, stage, static_cast<V*>(out), ns, carry, sm,    \
                        parity);                                          \
    break;
  switch (code) {
    SR_CASE(0, int32_t, kSum)
    SR_CASE(1, int32_t, kMin)
    SR_CASE(2, int32_t, kMax)
    SR_CASE(3, int64_t, kSum)
    SR_CASE(4, int64_t, kMin)
    SR_CASE(5, int64_t, kMax)
    SR_CASE(6, float, kSum)
    SR_CASE(7, float, kMin)
    SR_CASE(8, float, kMax)
    SR_CASE(9, double, kSum)
    SR_CASE(10, double, kMin)
    default:
      reduce_column<double, kMax>(x, stage, static_cast<double*>(out), ns,
                                  carry, sm, parity);
  }
#undef SR_CASE
}

// Writes the identity into one column's chunks this block fills: chunk
// blockIdx.x + i * gridDim.x for each bit i of `mask`.
__device__ __forceinline__ void fill_chunks(const Column& col, int mask,
                                            long long first,
                                            long long stride,
                                            long long ns) {
  const bool wide = elem8(col.code);
  const unsigned long long bits = identity_bits(col.code);
  for (int i = 0; i < kFillPerBlock; ++i) {
    if (!((mask >> i) & 1)) continue;
    const long long lo = (first + i * stride) * kChunk;
    fill_range(col.out, wide, bits, lo, min(lo + kChunk, ns));
  }
}

// Warp 0's search for which of its block's fill chunks (block b's chunks
// are b, b + grid, ..., at most kFillPerBlock) hold no gid: for each, the
// first row r with gid[r] >= the chunk's first segment, by rounds of 32
// evenly spaced probes (5 rounds at 8.4M rows). A round's probe is issued
// (`issue`) and consumed (`consume`) apart, so its latency hides behind a
// column's reduction.
struct ChunkSearch {
  long long lo, hi;   // r lies in [lo, hi]
  int32_t hi_gid;     // gid[hi] once hi < n
  long long q;        // this lane's probe, and its gid
  int32_t q_gid;
  int i;              // the chunk searched, kFillPerBlock when done
  int mask;           // bit i: chunk i holds no gid

  // chunk 0's search goes on from [lo0, hi0] (the block-wide rounds);
  // skipped when the block's tile names chunk 0
  __device__ void start(const Params& p, bool skip_first, long long lo0,
                        long long hi0, int32_t hi_gid0) {
    mask = 0;
    i = skip_first ? 1 : 0;
    next(p);
    if (i == 0) {
      lo = lo0;
      hi = hi0;
      hi_gid = hi_gid0;
    }
  }
  // the next chunk's whole range, or none left
  __device__ void next(const Params& p) {
    const long long chunks = (p.num_segments + kChunk - 1) / kChunk;
    if (i < kFillPerBlock &&
        blockIdx.x + static_cast<long long>(i) * gridDim.x >= chunks) {
      i = kFillPerBlock;
    }
    lo = 0;
    hi = p.n;
  }
  __device__ bool active() const { return i < kFillPerBlock; }
  __device__ void issue(const Params& p) {
    const long long step = (hi - lo + 31) / 32;
    q = lo + (threadIdx.x & 31) * step;
    q_gid = q < hi ? __ldg(p.gid + q) : 0;
  }
  __device__ void consume(const Params& p) {
    const long long x =
        (blockIdx.x + static_cast<long long>(i) * gridDim.x) * kChunk;
    if (hi > lo) {
      const long long step = (hi - lo + 31) / 32;
      const bool less = q < hi && q_gid < x;
      const int c = __popc(__ballot_sync(0xffffffffu, less));
      const int32_t at_c = __shfl_sync(0xffffffffu, q_gid, c & 31);
      const long long qc = lo + c * step;
      if (c < 32 && qc < hi) {
        hi = qc;
        hi_gid = at_c;
      }
      if (c > 0) lo += (c - 1) * step + 1;
    }
    if (hi == lo) {
      if (hi == p.n || hi_gid >= min(x + kChunk, p.num_segments)) {
        mask |= 1 << i;
      }
      ++i;
      next(p);
    }
  }
};

// Writes the identity into the gap ranges of the tile for one column.
__device__ __forceinline__ void fill_gaps(const Column& col,
                                          const TileSmem& sm, long long ns) {
  const bool wide = elem8(col.code);
  const unsigned long long bits = identity_bits(col.code);
  for (int i = 0; i < sm.ngaps; ++i) {
    long long r[4];
    gap_ranges(sm.gap_a[i], sm.gap_b[i], ns, r);
    fill_range(col.out, wide, bits, r[0], r[1]);
    fill_range(col.out, wide, bits, r[2], r[3]);
  }
}

// Block (b, y): tile b (when b < tiles), and the fill of the unnamed
// chunks b, b + grid, ... (at most kFillPerBlock), over the columns y,
// y + groups, ... (groups = gridDim.y: one, unless the call has few tiles,
// when the columns are split over several blocks per tile).
template <bool kOrder>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem);
  unsigned char* ring = smem + sizeof(TileSmem);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long n = p.n;
  const long long ns = p.num_segments;
  const long long tile = blockIdx.x;
  const bool has_tile = tile < p.tiles;
  const int groups = gridDim.y;
  // this block's columns: y, y + groups, ...
  const int y = static_cast<int>(blockIdx.y);
  const int mine = p.ncols > y ? (p.ncols - y + groups - 1) / groups : 0;
  auto col_of = [&](int j) { return y + j * groups; };
  if (!p.table && t < p.ncols) sm.cols[t] = p.cols[t];
  __syncthreads();
  Rows x;
  x.base = tile * kTile;
  x.alone = p.tiles == 1;
  long long a0 = -1;  // the gid before this thread's first row
  bool names_chunk = false;  // a gid of this thread lies in chunk b
  // the first round of the search for chunk b's first row, block-wide:
  // its probe load goes out with the tile's own loads
  const long long x_chunk = static_cast<long long>(blockIdx.x) * kChunk;
  long long slo = 0, shi = n;
  int32_t shi_gid = 0;
  long long step = (shi - slo + kThreads - 1) / kThreads;
  long long q = slo + t * step;
  int32_t q_gid = q < shi ? __ldg(p.gid + q) : 0;

  if (has_tile) {
    const long long row0 = x.base + t * kItems;
    x.nv = static_cast<int>(max(0LL, min(static_cast<long long>(kItems),
                                         n - row0)));
    if (t == 0 && tile > 0) a0 = __ldg(p.gid + x.base - 1);
    if (x.base + kTile <= n && aligned16(p.gid)) {
      const int4* gp = reinterpret_cast<const int4*>(p.gid + row0);
      const int4 a = __ldg(gp), b = __ldg(gp + 1);
      x.g[0] = a.x; x.g[1] = a.y; x.g[2] = a.z; x.g[3] = a.w;
      x.g[4] = b.x; x.g[5] = b.y; x.g[6] = b.z; x.g[7] = b.w;
    } else {
      // rows at or past n go on with the last gid (and the identity)
      const int32_t tail = __ldg(p.gid + n - 1);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        x.g[i] = i < x.nv ? __ldg(p.gid + row0 + i) : tail;
      }
    }
    if constexpr (kOrder) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long r = x.base + i * kThreads + t;
        x.o[i] = r < n ? __ldg(p.order + r) : 0;
      }
    }
    // the first columns' copies go out as soon as `order` is in
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < mine) {
        issue_column<kOrder>(ring + s * kTile * 8,
                             tile_column(p, sm, col_of(s)), x, n);
      }
      copy_commit();
    }
    x.heads = 0;
#pragma unroll
    for (int i = 1; i < kItems; ++i) {
      if (x.g[i] != x.g[i - 1]) x.heads |= 1u << i;
    }
    x.fg = x.g[0];
    x.lg = x.g[kItems - 1];
    x.single = x.heads == 0;
    sm.first_gid[t] = x.fg;
    sm.last_gid[t] = x.lg;
    const long long lo = tile * kChunk, hi = min(lo + kChunk, ns);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      names_chunk = names_chunk || (x.g[i] >= lo && x.g[i] < hi);
    }
  }
  sm.probe[0][t] = q_gid;
  narrow(__syncthreads_count(q < shi && q_gid < x_chunk), step, sm.probe[0],
         slo, shi, shi_gid);

  if (has_tile) {
    x.tile_fg = sm.first_gid[0];
    x.tile_lg = sm.last_gid[kThreads - 1];
    const int32_t prev_lg = t > 0 ? sm.last_gid[t - 1] : 0;
    x.cont_in = t > 0 && prev_lg == x.fg;
    x.cont_out = t < kThreads - 1 && sm.first_gid[t + 1] == x.lg;
    // the scan's steps: which combine, worked out once from the flags
    int reset = (!x.single || !x.cont_in) ? 1 : 0;
    x.take = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int off = 1 << s;
      const int prev = __shfl_up_sync(0xffffffffu, reset, off);
      if (lane >= off && !reset) {
        x.take |= 1u << s;
        reset = prev;
      }
    }
    x.need_prefix = warp > 0 && !reset;
    if (lane == 31) sm.warp_reset[warp] = reset;
    // the second block-wide round's probe
    step = (shi - slo + kThreads - 1) / kThreads;
    q = slo + t * step;
    q_gid = q < shi ? __ldg(p.gid + q) : 0;

    // the gaps this thread owns: before its first row (from the previous
    // thread's last gid; tile 0's first row from segment 0), before each of
    // its run heads, and, in the last tile's last thread, after the last row
    if (t > 0) a0 = prev_lg;
    const bool tail = tile == p.tiles - 1 && t == kThreads - 1;
    auto gap_at = [&](int i, long long& a, long long& b) {
      if (i < kItems) {
        a = i == 0 ? a0 : x.g[i - 1];
        b = x.g[i];
      } else {
        a = x.lg;
        b = tail ? ns : a;
      }
      if (b <= a + 1) return false;
      long long r[4];
      gap_ranges(a, b, ns, r);
      return r[1] > r[0] || r[3] > r[2];
    };
    int ng = 0;
#pragma unroll
    for (int i = 0; i <= kItems; ++i) {
      long long a, b;
      ng += gap_at(i, a, b) ? 1 : 0;
    }
    // place them in the tile's list, in thread order
    int incl = ng;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    if (lane == 31) sm.warp_count[warp] = incl;
    sm.probe[1][t] = q_gid;
    narrow(__syncthreads_count(q < shi && q_gid < x_chunk), step,
           sm.probe[1], slo, shi, shi_gid);
    int at = incl - ng;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += sm.warp_count[w];
      total += sm.warp_count[w];
    }
#pragma unroll
    for (int i = 0; i <= kItems; ++i) {
      long long a, b;
      if (gap_at(i, a, b)) {
        sm.gap_a[at] = static_cast<int32_t>(a);
        sm.gap_b[at] = static_cast<int32_t>(b);
        ++at;
      }
    }
    if (t == 0) sm.ngaps = total;
    x.prefix_from = 0;
    for (int w = warp - 1; w > 0; --w) {
      if (sm.warp_reset[w]) {
        x.prefix_from = w;
        break;
      }
    }
    if (t == 0 && !x.alone && y == 0) {
      p.carry_gid[2 * tile] = x.tile_fg;
      p.carry_gid[2 * tile + 1] = x.tile_lg;
    }
  }

  // warp 0 goes on searching for this block's unnamed fill chunks, one
  // round per column, while the columns' copies are in flight (chunk b
  // needs no search when tile b names it)
  // chunk b is named when a gid of tile b lies in it; the barrier also
  // publishes the gap list and the first column's copies
  copy_wait<kStages - 2>();
  names_chunk = __syncthreads_or(names_chunk);
  ChunkSearch search;
  if (warp == 0) search.start(p, names_chunk, slo, shi, shi_gid);

  if (has_tile) {
    // the columns: copies kStages - 1 columns ahead of the reduction, and
    // each column's gap stores while its copies are in flight. Column j's
    // copies, every thread's, are in when its reduction starts: each
    // thread waits for its own before the previous column's barrier.
    const long long carries = 2 * p.tiles;
    for (int j = 0; j < mine; ++j) {
      const int ahead = j + kStages - 1;
      if (ahead < mine) {
        issue_column<kOrder>(ring + (ahead % kStages) * kTile * 8,
                             tile_column(p, sm, col_of(ahead)), x, n);
      }
      copy_commit();
      const int c = col_of(j);
      const Column& col = tile_column(p, sm, c);
      fill_gaps(col, sm, ns);
      const bool searching = warp == 0 && search.active();
      if (searching) search.issue(p);
      copy_wait<kStages - 2>();  // column j + 1's, for the next column
      reduce_dispatch(col.code, x, ring + (j % kStages) * kTile * 8,
                      col.out, ns, p.carry_val + c * carries + 2 * tile, sm,
                      j & 1);
      if (searching) search.consume(p);
    }
  }
  // the unnamed chunks, every column of this block
  if (warp == 0) {
    while (search.active()) {
      search.issue(p);
      search.consume(p);
    }
    if (lane == 0) sm.fill_mask = search.mask;
  }
  __syncthreads();
  for (int j = 0; j < mine; ++j) {
    fill_chunks(tile_column(p, sm, col_of(j)), sm.fill_mask, blockIdx.x,
                gridDim.x, ns);
  }
}

// First index in [lo, hi) whose carry gid is above g (hi when none).
__device__ long long carry_run_end(const int32_t* cg, long long lo,
                                   long long hi, int32_t g) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (cg[mid] > g) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

struct CarrySmem {
  long long run_at[kThreads];    // the long runs starting in this block
  long long run_len[kThreads];
  int32_t warp_count[kWarps];
  unsigned long long part[kWarps];
};

// In-order fold of vals[lo, hi) from the identity.
template <typename V, int K>
__device__ __forceinline__ V fold(const unsigned long long* vals,
                                  long long lo, long long hi) {
  V v = identity<V, K>();
#pragma unroll 4
  for (long long q = lo; q < hi; ++q) {
    v = combine<V, K>(v, value_of<V>(vals[q]));
  }
  return v;
}

// In-order tree over a warp's lanes: lane 0 ends with the fold of every
// lane's value, lower lanes on the left.
template <typename V, int K>
__device__ __forceinline__ V warp_fold(V v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V o = shfl_down(v, off);
    if ((lane & (2 * off - 1)) == 0) v = combine<V, K>(v, o);
  }
  return v;
}

// Folds the runs of one column's carries that start in this block (see
// carry_kernel). A run's association depends on its length alone: up to
// kShortRun carries, one thread in tile order; up to kWarpRun, 32 lanes
// each folding an equal share in order, then an in-order tree; longer, the
// same over the block's 256 threads, then its 8 warps in order.
template <typename V, int K>
__device__ __forceinline__ void fold_carries(const Params& p,
                                             const unsigned long long* vals,
                                             V* out, CarrySmem& sm,
                                             long long block) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long m = 2 * p.tiles;
  const long long ns = p.num_segments;
  const int32_t* cg = p.carry_gid;
  const long long k = block * kThreads + t;
  long long len = 0;
  if (k < m) {
    const int32_t g = cg[k];
    if ((k == 0 || cg[k - 1] != g) && g >= 0 && g < ns) {
      // the run's end: 8 carries probed at once, then a binary search
      int same = 0;
      bool open = true;
#pragma unroll
      for (int i = 1; i <= 8; ++i) {
        const bool eq = k + i < m && cg[k + i] == g;
        open = open && eq;
        same += open ? 1 : 0;
      }
      const long long end =
          open ? carry_run_end(cg, k + 9, m, g) : k + 1 + same;
      len = end - k;
      if (len <= kShortRun) {
        out[g] = fold<V, K>(vals, k, end);
        len = 0;
      }
    }
  }
  // the longer runs, listed in carry order
  const unsigned mask = __ballot_sync(0xffffffffu, len > 0);
  if (lane == 0) sm.warp_count[warp] = __popc(mask);
  __syncthreads();
  int at = __popc(mask & ((1u << lane) - 1));
  int runs = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) at += sm.warp_count[w];
    runs += sm.warp_count[w];
  }
  if (len > 0) {
    sm.run_at[at] = k;
    sm.run_len[at] = len;
  }
  __syncthreads();
  // runs of up to kWarpRun carries: one warp each
  for (int r = warp; r < runs; r += kWarps) {
    const long long k0 = sm.run_at[r], l = sm.run_len[r];
    if (l > kWarpRun) continue;
    const long long share = (l + 31) / 32;
    const long long lo = min(k0 + lane * share, k0 + l);
    const V v = warp_fold<V, K>(fold<V, K>(vals, lo, min(lo + share, k0 + l)));
    if (lane == 0) out[cg[k0]] = v;
  }
  // longer runs: the whole block
  for (int r = 0; r < runs; ++r) {
    const long long k0 = sm.run_at[r], l = sm.run_len[r];
    if (l <= kWarpRun) continue;
    const long long share = (l + kThreads - 1) / kThreads;
    const long long lo = min(k0 + t * share, k0 + l);
    const V v = warp_fold<V, K>(fold<V, K>(vals, lo, min(lo + share, k0 + l)));
    if (lane == 0) sm.part[warp] = to_bits(v);
    __syncthreads();
    if (t == 0) {
      V total = value_of<V>(sm.part[0]);
      for (int w = 1; w < kWarps; ++w) {
        total = combine<V, K>(total, value_of<V>(sm.part[w]));
      }
      out[cg[k0]] = total;
    }
    __syncthreads();
  }
}

// Block x + c * carry blocks folds the runs of column c's carries that
// start among carries [256x, 256x + 256). Each run is one segment that
// crosses a tile edge; its carries are folded in tile order.
__global__ void __launch_bounds__(kThreads)
carry_kernel(const __grid_constant__ Params p) {
  __shared__ CarrySmem sm;
  const long long carry_blocks = (2 * p.tiles + kThreads - 1) / kThreads;
  const long long b = blockIdx.x;
  const int c = static_cast<int>(b / carry_blocks);
  const long long block = b % carry_blocks;
  const Column& col = column(p, c);
  const unsigned long long* vals =
      p.carry_val + static_cast<long long>(c) * 2 * p.tiles;
#define SR_CASE(C, V, K)                                               \
  case C:                                                              \
    fold_carries<V, K>(p, vals, static_cast<V*>(col.out), sm, block);  \
    break;
  switch (col.code) {
    SR_CASE(0, int32_t, kSum)
    SR_CASE(1, int32_t, kMin)
    SR_CASE(2, int32_t, kMax)
    SR_CASE(3, int64_t, kSum)
    SR_CASE(4, int64_t, kMin)
    SR_CASE(5, int64_t, kMax)
    SR_CASE(6, float, kSum)
    SR_CASE(7, float, kMin)
    SR_CASE(8, float, kMax)
    SR_CASE(9, double, kSum)
    SR_CASE(10, double, kMin)
    default:
      fold_carries<double, kMax>(p, vals, static_cast<double*>(col.out), sm,
                                 block);
  }
#undef SR_CASE
}

// The tile kernel's dynamic shared memory is above the 48 KB default:
// allowed once per device.
template <bool kOrder>
cudaError_t allow_tile_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(tile_kernel<kOrder>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTileSmemBytes));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Rows per tile (the wrapper sizes the carries from it) and the most
// columns whose descriptors ride in the launch parameters.
int segment_reduce_tile_rows() { return kTile; }
int segment_reduce_inline_columns() { return kInline; }

// Reduces ncols state columns over one array of n sorted int32 gids into
// num_segments segments. table: ncols descriptors on the host, three int64
// each: the column's device pointer, its output's device pointer (room for
// num_segments values) and its code, dtype * 3 + kind (dtype 0 int32,
// 1 int64, 2 float32, 3 float64; kind 0 sum, 1 min, 2 max). order: NULL,
// or n int64 row indices on the device, and then column i's row r is
// col_i[order[r]]. Scratch on the device: carry_gid holds 2 * tiles int32
// and carry_val 16-byte aligned ncols * 2 * tiles entries of 8 bytes
// (tiles = ceil(n / tile rows)); device_table room for the table when
// ncols is above the inline count (else unused). Launches the tile kernel
// and, when n > 0, the carry kernel on `stream`, and returns the first
// error (0 = cudaSuccess); a bad code or size returns cudaErrorInvalidValue
// and launches nothing.
int segment_reduce_columns(const long long* table, int ncols,
                           const void* gid, const void* order, long long n,
                           long long num_segments, void* carry_gid,
                           void* carry_val, void* device_table,
                           void* stream) {
  if (ncols < 0 || ncols > 65535 || n < 0 || num_segments < 0 ||
      num_segments >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < ncols; ++i) {
    if (table[3 * i + 2] < 0 || table[3 * i + 2] > 11) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (ncols == 0 || num_segments == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.gid = static_cast<const int32_t*>(gid);
  p.order = static_cast<const long long*>(order);
  p.n = n;
  p.num_segments = num_segments;
  p.tiles = (n + kTile - 1) / kTile;
  p.ncols = ncols;
  p.carry_gid = static_cast<int32_t*>(carry_gid);
  p.carry_val = static_cast<unsigned long long*>(carry_val);
  const size_t table_bytes = sizeof(Column) * static_cast<size_t>(ncols);
  if (ncols <= kInline) {
    for (int i = 0; i < ncols; ++i) {
      p.cols[i].in = reinterpret_cast<const void*>(table[3 * i]);
      p.cols[i].out = reinterpret_cast<void*>(table[3 * i + 1]);
      p.cols[i].code = table[3 * i + 2];
    }
  } else {
    // the host table is pageable: the copy is staged before this returns
    const cudaError_t err = cudaMemcpyAsync(
        device_table, table, table_bytes, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.table = static_cast<const Column*>(device_table);
  }
  const long long chunks = (num_segments + kChunk - 1) / kChunk;
  const long long fill_blocks = (chunks + kFillPerBlock - 1) / kFillPerBlock;
  const long long grid = p.tiles > fill_blocks ? p.tiles : fill_blocks;
  const long long carry_grid =
      (2 * p.tiles + kThreads - 1) / kThreads * ncols;
  if (grid >= (1LL << 31) || carry_grid >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = order ? allow_tile_smem<true>() : allow_tile_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a call of few tiles splits its columns over several blocks per tile
  // (each reading the tile's gids again), so its columns reduce side by
  // side and not one after another in one block
  long long groups = 1;
  if (p.tiles < kSplitBelowTiles) {
    groups = (kSplitBelowTiles + p.tiles - 1) / (p.tiles > 0 ? p.tiles : 1);
    if (groups > ncols) groups = ncols;
  }
  const dim3 blocks(static_cast<unsigned>(grid),
                    static_cast<unsigned>(groups));
  if (order) {
    tile_kernel<true><<<blocks, kThreads, kTileSmemBytes, s>>>(p);
  } else {
    tile_kernel<false><<<blocks, kThreads, kTileSmemBytes, s>>>(p);
  }
  err = cudaGetLastError();
  // one tile writes its own edges: no carries
  if (err != cudaSuccess || p.tiles <= 1) return static_cast<int>(err);
  carry_kernel<<<static_cast<unsigned>(carry_grid), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
