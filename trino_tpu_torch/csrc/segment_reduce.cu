// Segment reduction over SORTED group ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_segment_reduce_pallas` /
// `segment_reduce` of trino_tpu/ops/pallas_kernels.py: SUM, MIN or MAX of
// one state column over segments given by non-decreasing int32 group ids
// (the engine's sorted gids: steps of at most 1, plus a trailing jump of
// invalid lanes to the dump segment). Every segment that no row names holds
// the identity of the reduction. Integer sums wrap in two's complement.
// Group ids outside [0, num_segments) are dropped.
//
// Bound: memory. Each row is read once (value + 4-byte gid) and each
// segment written once; there is one operation per row. At the aggregation
// page of TPC-H q1 at SF1 (262,144 rows, int64 states, 262,145 segments)
// that is 3.1 MB read and 2.1 MB written: about 1.6 us at 3.35 TB/s. At that
// size the three launches below cost more than the bytes.
//
// Design. The TPU kernel walks a sequential grid and accumulates into a
// 128-aligned output window with one-hot matrix products, because the TPU
// grid runs in order and its matrix unit is the fast path. Neither holds on
// Hopper: blocks run in parallel and in no order. So:
//   0. fill: every output segment takes the identity (coalesced writes).
//   1. tiles: each block loads 2,048 consecutive rows into shared memory with
//      coalesced loads, reduces them with a per-thread sequential pass and a
//      block-wide segmented scan, and writes every segment that lies wholly
//      inside the tile straight to the output. The partials of the tile's
//      first and last segment, which may continue in a neighbouring tile, go
//      to a carry buffer (two entries per tile, in tile order).
//   2. carries: one block runs the same tile reduction over the carry
//      buffer, in order, and writes the segments that crossed tile edges.
// No atomics, so repeated runs give bit-identical results, floats included.
// Only sortedness is required of the gids; the steps-of-one property is not
// used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // consecutive rows per thread
constexpr int kTile = kThreads * kItems;    // rows per block

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

// Loads rows [base, base + kTile) of (gid, col) into shared memory. Rows at
// or past n continue the last segment with the identity, so the ragged
// tail needs no special case below.
template <typename V, int K>
__device__ void load_tile(TileSmem<V>& sm, const int32_t* gid, const V* col,
                          long long base, long long n) {
  const int32_t tail_gid = gid[n - 1];
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    if (r < n) {
      sm.gid[i] = gid[r];
      sm.val[i] = col[r];
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

template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
fill_kernel(V* out, long long num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < num_segments; i += stride) {
    out[i] = identity<V, K>();
  }
}

template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const V* col, const int32_t* gid, long long n, V* out,
            long long num_segments, int32_t* carry_gid, V* carry_val) {
  __shared__ TileSmem<V> sm;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  load_tile<V, K>(sm, gid, col, base, n);
  reduce_tile<V, K>(sm, out, num_segments);
  if (threadIdx.x == 0) {
    carry_gid[2 * blockIdx.x] = sm.gid[0];
    carry_val[2 * blockIdx.x] = sm.tile_first;
    carry_gid[2 * blockIdx.x + 1] = sm.gid[kTile - 1];
    carry_val[2 * blockIdx.x + 1] = sm.tile_last;
  }
}

// One block walks the carry buffer in tile order, holding the running
// partial of the segment that crosses from one carry tile into the next.
template <typename V, int K>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const int32_t* carry_gid, const V* carry_val, long long m,
             V* out, long long num_segments) {
  __shared__ TileSmem<V> sm;
  int32_t run_gid = 0;
  V run_val = identity<V, K>();
  bool run = false;
  for (long long base = 0; base < m; base += kTile) {
    load_tile<V, K>(sm, carry_gid, carry_val, base, m);
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

template <typename V, int K>
void launch(const void* col, const int32_t* gid, long long n, void* out,
            long long num_segments, void* carry_gid, void* carry_val,
            cudaStream_t stream) {
  V* o = static_cast<V*>(out);
  if (num_segments > 0) {
    long long blocks = (num_segments + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    fill_kernel<V, K><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(o, num_segments);
  }
  if (n <= 0) return;
  const long long tiles = (n + kTile - 1) / kTile;
  int32_t* cg = static_cast<int32_t*>(carry_gid);
  V* cv = static_cast<V*>(carry_val);
  tile_kernel<V, K><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const V*>(col), gid, n, o, num_segments, cg, cv);
  carry_kernel<V, K><<<1, kThreads, 0, stream>>>(cg, cv, 2 * tiles, o,
                                                 num_segments);
}

template <typename V>
void launch_kind(int kind, const void* col, const int32_t* gid, long long n,
                 void* out, long long num_segments, void* carry_gid,
                 void* carry_val, cudaStream_t stream) {
  switch (kind) {
    case kSum:
      launch<V, kSum>(col, gid, n, out, num_segments, carry_gid, carry_val,
                      stream);
      break;
    case kMin:
      launch<V, kMin>(col, gid, n, out, num_segments, carry_gid, carry_val,
                      stream);
      break;
    case kMax:
      launch<V, kMax>(col, gid, n, out, num_segments, carry_gid, carry_val,
                      stream);
      break;
  }
}

}  // namespace

extern "C" {

// Rows per tile: the caller sizes the carry buffers as 2 * ceil(n / tile).
int segment_reduce_tile_rows() { return kTile; }

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; kind: 0 sum, 1 min, 2 max.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess); an
// unknown dtype or kind returns cudaErrorInvalidValue and launches nothing.
int segment_reduce(const void* col, const void* gid, long long n, void* out,
                   long long num_segments, int dtype, int kind,
                   void* carry_gid, void* carry_val, void* stream) {
  if (dtype < 0 || dtype > 3 || kind < 0 || kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* g = static_cast<const int32_t*>(gid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_kind<int32_t>(kind, col, g, n, out, num_segments, carry_gid,
                           carry_val, s);
      break;
    case 1:
      launch_kind<int64_t>(kind, col, g, n, out, num_segments, carry_gid,
                           carry_val, s);
      break;
    case 2:
      launch_kind<float>(kind, col, g, n, out, num_segments, carry_gid,
                         carry_val, s);
      break;
    case 3:
      launch_kind<double>(kind, col, g, n, out, num_segments, carry_gid,
                          carry_val, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
