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
// 0.0197 ms at 3.35 TB/s. Two things keep the kernel above that: the fill
// writes every output once before the tiles write it again (31.5 MB more at
// the page; folding the fill into the tile pass is left to a later change),
// and the gather through `order` reads partial sectors. Measured on an H100
// (PERF.md), the tile pass also falls short of the memory rate at the
// merge's 8.4M rows: `load_tile` reads each thread's rows one after
// another, two dependent loads each with `order`.
//
// Design. The TPU kernel walks a sequential grid and accumulates into a
// 128-aligned output window with one-hot matrix products, because the TPU
// grid runs in order and its matrix unit is the fast path. Neither holds on
// Hopper: blocks run in parallel and in no order. So, for each (dtype, kind)
// among the columns and each chunk of up to kMaxCols such columns, whose
// pointers travel in a table passed by value:
//   0. fill: every output segment takes the identity (coalesced writes;
//      blockIdx.y is the column).
//   1. tiles: grid (tiles, columns). Each block loads 2,048 consecutive rows
//      of one column into shared memory (gids coalesced, values through
//      `order` when it is given), reduces them with a per-thread sequential
//      pass and a block-wide segmented scan, and writes every segment that
//      lies wholly inside the tile straight to the output. The partials of
//      the tile's first and last segment, which may continue in a
//      neighbouring tile, go to the column's carry buffer (two entries per
//      tile, in tile order); the carry gids are the same for every column,
//      and column 0's blocks write them.
//   2. carries: one block per column runs the same tile reduction over that
//      column's carry buffer, in order, and writes the segments that
//      crossed tile edges.
// So a call makes three launches per (dtype, kind) and chunk. No atomics:
// repeated runs give bit-identical results, floats included. Only
// sortedness is required of the gids; the steps-of-one property is not
// used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // consecutive rows per thread
constexpr int kTile = kThreads * kItems;    // rows per block
constexpr int kMaxCols = 32;                // columns per launch

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

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
struct TileSmem {
  int32_t gid[kTile];
  V val[kTile];
  V scan[kThreads];
  int32_t first_gid[kThreads];
  int32_t last_gid[kThreads];
  int32_t reset[kThreads];
  V tile_first;     // partial of the tile's first segment (identity when the
                    // whole tile is one segment)
  V tile_last;      // partial of the tile's last segment
};

template <typename V>
__device__ __forceinline__ void put(V* out, long long num_segments,
                                    int32_t g, V v) {
  if (g >= 0 && g < num_segments) out[g] = v;
}

// Loads rows [base, base + kTile) of (gid, col) into shared memory; row r's
// value is col[order[r]] when `order` is given, else col[r]. Rows at or past
// n continue the last segment with the identity, so the ragged tail needs
// no special case below.
template <typename V, int K>
__device__ void load_tile(TileSmem<V>& sm, const int32_t* gid, const V* col,
                          const int64_t* order, long long base, long long n) {
  const int32_t tail_gid = gid[n - 1];
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    if (r < n) {
      sm.gid[i] = gid[r];
      sm.val[i] = col[order ? order[r] : r];
    } else {
      sm.gid[i] = tail_gid;
      sm.val[i] = identity<V, K>();
    }
  }
  __syncthreads();
}

// Reduces the tile held in `sm`. Writes every segment other than the tile's
// first and last to `out`, and leaves those two partials in sm.tile_first /
// sm.tile_last. Ends with a barrier.
template <typename V, int K>
__device__ void reduce_tile(TileSmem<V>& sm, V* out, long long num_segments) {
  const int t = threadIdx.x;
  const int32_t* g = sm.gid + t * kItems;
  const V* v = sm.val + t * kItems;
  const int32_t tile_first_gid = sm.gid[0];
  if (t == 0) sm.tile_first = identity<V, K>();

  // sequential pass over this thread's rows: the run of its first gid, the
  // run of its last gid, and every segment strictly between (written now:
  // it cannot reach outside this thread, so it is no edge of the tile)
  const int32_t fg = g[0];
  int32_t cg = fg;
  V first = identity<V, K>();
  V cur = identity<V, K>();
  bool single = true;
  for (int i = 0; i < kItems; ++i) {
    if (g[i] != cg) {
      if (single) {
        first = cur;
        single = false;
      } else {
        put(out, num_segments, cg, cur);
      }
      cur = identity<V, K>();
      cg = g[i];
    }
    cur = combine<V, K>(cur, v[i]);
  }
  const int32_t lg = cg;

  // block-wide inclusive segmented scan of the last-run partials: after it,
  // scan[t] is the total of gid lg over the rows of threads <= t
  sm.first_gid[t] = fg;
  sm.last_gid[t] = lg;
  __syncthreads();
  int32_t reset = (!single || t == 0 || sm.last_gid[t - 1] != fg) ? 1 : 0;
  V acc = cur;
  sm.scan[t] = acc;
  sm.reset[t] = reset;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    V prev_v = acc;
    int32_t prev_r = 1;
    if (t >= off) {
      prev_v = sm.scan[t - off];
      prev_r = sm.reset[t - off];
    }
    __syncthreads();
    if (t >= off && !reset) {
      acc = combine<V, K>(prev_v, acc);
      reset = prev_r;
    }
    sm.scan[t] = acc;
    sm.reset[t] = reset;
    __syncthreads();
  }

  // this thread's first segment ends inside it when the thread holds more
  // than one segment
  if (!single) {
    V total = first;
    if (t > 0 && sm.last_gid[t - 1] == fg) {
      total = combine<V, K>(sm.scan[t - 1], first);
    }
    if (fg == tile_first_gid) {
      sm.tile_first = total;
    } else {
      put(out, num_segments, fg, total);
    }
  }
  // this thread's last segment ends at its last row unless the next thread
  // goes on with it; the tile's last segment is left to the caller
  if (t == kThreads - 1) {
    sm.tile_last = acc;
  } else if (sm.first_gid[t + 1] != lg) {
    if (lg == tile_first_gid) {
      sm.tile_first = acc;
    } else {
      put(out, num_segments, lg, acc);
    }
  }
  __syncthreads();
}

// Pointers of up to kMaxCols columns of one dtype and kind, passed to the
// kernels by value (768 bytes of the 4 KB parameter space).
template <typename V>
struct Columns {
  const V* in[kMaxCols];
  V* out[kMaxCols];
  V* carry_val[kMaxCols];  // 2 entries per tile
};

template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
fill_kernel(Columns<V> cols, long long num_segments) {
  V* out = cols.out[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_segments; i += stride) {
    out[i] = identity<V, K>();
  }
}

template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
tile_kernel(Columns<V> cols, const int32_t* gid, const int64_t* order,
            long long n, long long num_segments, int32_t* carry_gid) {
  __shared__ TileSmem<V> sm;
  const int c = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  load_tile<V, K>(sm, gid, cols.in[c], order, base, n);
  reduce_tile<V, K>(sm, cols.out[c], num_segments);
  if (threadIdx.x == 0) {
    V* carry_val = cols.carry_val[c];
    carry_val[2 * blockIdx.x] = sm.tile_first;
    carry_val[2 * blockIdx.x + 1] = sm.tile_last;
    if (c == 0) {
      carry_gid[2 * blockIdx.x] = sm.gid[0];
      carry_gid[2 * blockIdx.x + 1] = sm.gid[kTile - 1];
    }
  }
}

// One block per column walks that column's carry buffer in tile order,
// holding the running partial of the segment that crosses from one carry
// tile into the next.
template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
carry_kernel(Columns<V> cols, const int32_t* carry_gid, long long m,
             long long num_segments) {
  __shared__ TileSmem<V> sm;
  const V* carry_val = cols.carry_val[blockIdx.x];
  V* out = cols.out[blockIdx.x];
  int32_t run_gid = 0;
  V run_val = identity<V, K>();
  bool run = false;
  for (long long base = 0; base < m; base += kTile) {
    load_tile<V, K>(sm, carry_gid, carry_val, nullptr, base, m);
    reduce_tile<V, K>(sm, out, num_segments);
    if (threadIdx.x == 0) {
      const int32_t first_gid = sm.gid[0];
      const int32_t last_gid = sm.gid[kTile - 1];
      V first = sm.tile_first;
      if (run && run_gid == first_gid) {
        first = combine<V, K>(run_val, first);
      } else if (run) {
        put(out, num_segments, run_gid, run_val);
      }
      if (first_gid == last_gid) {
        run_val = combine<V, K>(first, sm.tile_last);
      } else {
        put(out, num_segments, first_gid, first);
        run_val = sm.tile_last;
      }
      run_gid = last_gid;
      run = true;
    }
    __syncthreads();  // the next load overwrites sm
  }
  if (threadIdx.x == 0 && run) put(out, num_segments, run_gid, run_val);
}

// One call's arguments, as the C entry below takes them.
struct Call {
  const void* const* cols;
  void* const* outs;
  const int* dtypes;
  const int* kinds;
  int ncols;
  const int32_t* gid;
  const int64_t* order;
  long long n;
  long long num_segments;
  int32_t* carry_gid;
  char* carry_val;
  cudaStream_t stream;
};

template <typename V> struct DtypeCode;
template <> struct DtypeCode<int32_t> { static constexpr int value = 0; };
template <> struct DtypeCode<int64_t> { static constexpr int value = 1; };
template <> struct DtypeCode<float> { static constexpr int value = 2; };
template <> struct DtypeCode<double> { static constexpr int value = 3; };

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// fill, tile and carry over the k columns of one table
template <typename V, int K>
cudaError_t launch_table(const Columns<V>& t, int k, const Call& a) {
  if (a.num_segments > 0) {
    long long blocks = (a.num_segments + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    fill_kernel<V, K><<<dim3(static_cast<unsigned>(blocks), k), kThreads, 0,
                        a.stream>>>(t, a.num_segments);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n <= 0) return cudaSuccess;
  const long long tiles = tiles_of(a.n);
  tile_kernel<V, K><<<dim3(static_cast<unsigned>(tiles), k), kThreads, 0,
                      a.stream>>>(t, a.gid, a.order, a.n, a.num_segments,
                                  a.carry_gid);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<V, K><<<k, kThreads, 0, a.stream>>>(t, a.carry_gid, 2 * tiles,
                                                   a.num_segments);
  return cudaGetLastError();
}

// every column of dtype V and kind K, kMaxCols columns per table
template <typename V, int K>
cudaError_t launch_group(const Call& a) {
  const long long carry_bytes = 2 * tiles_of(a.n) * 8;
  Columns<V> t{};
  int k = 0;
  for (int i = 0; i < a.ncols; ++i) {
    if (a.dtypes[i] != DtypeCode<V>::value || a.kinds[i] != K) continue;
    t.in[k] = static_cast<const V*>(a.cols[i]);
    t.out[k] = static_cast<V*>(a.outs[i]);
    t.carry_val[k] = reinterpret_cast<V*>(a.carry_val + i * carry_bytes);
    if (++k == kMaxCols) {
      const cudaError_t err = launch_table<V, K>(t, k, a);
      if (err != cudaSuccess) return err;
      k = 0;
    }
  }
  return k > 0 ? launch_table<V, K>(t, k, a) : cudaSuccess;
}

template <typename V>
cudaError_t launch_dtype(const Call& a) {
  cudaError_t err = launch_group<V, kSum>(a);
  if (err == cudaSuccess) err = launch_group<V, kMin>(a);
  if (err == cudaSuccess) err = launch_group<V, kMax>(a);
  return err;
}

}  // namespace

extern "C" {

// Rows per tile: the caller sizes the carry buffers from it (below).
int segment_reduce_tile_rows() { return kTile; }

// Reduces ncols state columns over one array of n sorted int32 gids into
// num_segments segments. Per column i: cols[i] (device pointer to its
// values), outs[i] (device pointer to num_segments outputs), dtypes[i]
// (0 int32, 1 int64, 2 float32, 3 float64) and kinds[i] (0 sum, 1 min,
// 2 max); the arrays themselves live on the host. order: NULL, or n int64
// row indices on the device, and then column i's row r is cols[i][order[r]].
// Scratch on the device: carry_gid holds 2 * ceil(n / tile) int32,
// carry_val ncols * 2 * ceil(n / tile) entries of 8 bytes.
// Launches fill, tile and carry kernels for each (dtype, kind) among the
// columns and each chunk of 32 such columns, on `stream`, and returns the
// first launch's error (0 = cudaSuccess); an unknown dtype or kind returns
// cudaErrorInvalidValue and launches nothing.
int segment_reduce_columns(const void* const* cols, void* const* outs,
                           const int* dtypes, const int* kinds, int ncols,
                           const void* gid, const void* order, long long n,
                           long long num_segments, void* carry_gid,
                           void* carry_val, void* stream) {
  for (int i = 0; i < ncols; ++i) {
    if (dtypes[i] < 0 || dtypes[i] > 3 || kinds[i] < 0 || kinds[i] > 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Call a{cols, outs, dtypes, kinds, ncols,
               static_cast<const int32_t*>(gid),
               static_cast<const int64_t*>(order), n, num_segments,
               static_cast<int32_t*>(carry_gid),
               static_cast<char*>(carry_val),
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = launch_dtype<int32_t>(a);
  if (err == cudaSuccess) err = launch_dtype<int64_t>(a);
  if (err == cudaSuccess) err = launch_dtype<float>(a);
  if (err == cudaSuccess) err = launch_dtype<double>(a);
  return static_cast<int>(err);
}

const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
