// Insert-or-lookup of every row of one page in an open-addressing hash
// table: the linear-probe rounds of the engine's GROUP BY hash path, for
// Hopper (sm_90a).
//
// Replaces the probe loop of trino_tpu/ops/hashtable.py
// `_hash_group_ids_impl` (:111-155), which runs its rounds on the device as
// one jit `jax.lax.while_loop` (:153): not a Pallas kernel, but a device
// loop that eager PyTorch has no counterpart for. Run as a Python loop of
// PyTorch ops, each round costs a handful of launches and one host read to
// decide whether to go on; this kernel runs every round in one launch and
// reads nothing on the host.
//
// What it computes, bit for bit the reference's (the port's tests and the
// engine's first-occurrence group ids rely on it):
//   - the hash: h = 0, then h = splitmix64(h ^ x) for each key operand x,
//     the operand's value sign-extended (bool and uint8 zero-extended) to
//     64 bits, in uint64; the row's first slot is h & (tsize - 1), tsize the
//     power of two the wrapper gives (2 * capacity rounded up);
//   - lockstep rounds. In round r every row still active (valid and not
//     yet resolved) probes slot (first + r) & (tsize - 1):
//       1. where the slot has no owner it claims it with
//          atomicMin(slot, row) (the claims of one warp on one slot
//          reduced to their least row first: one atomic per slot and warp,
//          as a global aggregation's rows all claim one slot), so the slot
//          goes to the smaller row index, as the reference's scatter-min
//          gives it, and never to whichever thread wins a race;
//       2. it reads the slot again: the owner, or the smallest claimant,
//          which then installs itself. It compares every key operand with
//          the owner row's: equal keys resolve the row into the owner's
//          group (rep = owner), others probe on in the next round.
//     The loop stops after `rounds` rounds, or before a round when no row
//     is active: the while_loop's own condition (:146-148). Rows still
//     active then keep rep = capacity and resolved = false (the caller's
//     overflow or singleton groups).
//   Outputs: rep (int32, the owner row per row; capacity for an unresolved
//   row, the row itself for an invalid one), resolved (bool) and the number
//   of rounds run.
//
// Bound: memory. The key operands are read twice (the hash, and the
// compare against the owner row), the valid mask once, the table (tsize
// int32) written once, rep and resolved written once. At TPC-H q1's
// aggregation page at SF1 (262,144 rows, two keys as (uint8, int64)
// operand pairs, tsize 524,288) that is
// 2 x 4,718,592 + 262,144 + 524,288 x 4 + 1,048,576 + 262,144
// = 13,107,200 bytes, 0.0039 ms at 3.35 TB/s. A round's work is a few
// random 4-byte accesses per active row, far below the card's rates; a
// call that resolves in one round is bound by its grid barriers instead
// (three per call), which this first version does not try to avoid.
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel), its grid
// as large as the device keeps resident at once (the occupancy the runtime
// reports, times the SMs) but no larger than the rows need; every loop
// walks the rows (or the slots) grid-stride, so a row stays with one thread
// for the whole call and its rep, resolved and first slot are that
// thread's alone. cooperative_groups' grid.sync() separates the phases: a
// prologue (an empty table, each row's hash, rep and resolved), then two
// phases per round. A slot holds `cap` while empty, a claimant's row while
// claimed in this round, and its owner's row with the sign bit set once
// installed: an owner is negative, so a claim's atomicMin never beats it,
// and the claims need no array of their own. The count of active rows that
// decides the next round is a partial per block, written in phase 2 (and
// the prologue) and summed by every block after the barrier: no atomics
// and no reset. The table and partials are written by other blocks during
// the call, so they are read through L2 (__ldcg), never the non-coherent
// read-only path; the key operands are inputs and use it. The table lives
// in device memory; keeping it in shared memory for small pages, and fewer
// barriers per round, are later work.

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOperands = 240;      // descriptors passed by value
constexpr int kMaxGrid = 4096;         // blocks at most: the partials' room
constexpr int kMaxDevices = 64;        // devices whose resident grid is cached
constexpr int32_t kOwned = INT32_MIN;  // the tag of an installed owner

// One key operand, as the wrapper packs it: two int64 (16 bytes).
struct Operand {
  const void* ptr;
  long long code;  // 0 bool or uint8, 1 int8, 2 int16, 3 int32, 4 int64
};

struct Params {
  const uint8_t* valid;    // n bools
  int32_t* rep;            // n
  uint8_t* resolved;       // n bools
  int32_t* taken;          // 1: rounds run
  int32_t* slots;          // tsize: the hash table (see Design)
  int32_t* first;          // n: each row's first slot
  int32_t* partial;        // gridDim.x: active rows per block
  long long n;
  long long tsize;         // a power of two
  int nops;
  int rounds;
  Operand ops[kMaxOperands];
};
// the launch parameters' limit on every toolkit
static_assert(sizeof(Params) <= 4096, "Params exceeds 4 KB");

// The operand's value at row i, extended to 64 bits as the reference's
// astype(uint64) extends it.
__device__ __forceinline__ long long value(const Operand& op, long long i) {
  switch (op.code) {
    case 0: return __ldg(static_cast<const unsigned char*>(op.ptr) + i);
    case 1: return __ldg(static_cast<const signed char*>(op.ptr) + i);
    case 2: return __ldg(static_cast<const short*>(op.ptr) + i);
    case 3: return __ldg(static_cast<const int*>(op.ptr) + i);
    default: return __ldg(static_cast<const long long*>(op.ptr) + i);
  }
}

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// The sum of v over the block, in every thread. Leaves `smem` free for the
// next call.
__device__ int block_sum(int v, int* smem) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += smem[w];
  __syncthreads();
  return total;
}

// The active rows of the whole grid: the blocks' partials, written before
// the last barrier, summed by this block.
__device__ int grid_total(const Params& p, int* smem) {
  int v = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    v += __ldcg(p.partial + b);
  }
  return block_sum(v, smem);
}

__global__ void __launch_bounds__(kThreads) probe_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int smem[kWarps];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int32_t cap = static_cast<int32_t>(p.n);
  const int32_t mask = static_cast<int32_t>(p.tsize - 1);

  // prologue: an empty table, each row's first slot
  for (long long s = start; s < p.tsize; s += stride) p.slots[s] = cap;
  int active = 0;
  for (long long i = start; i < p.n; i += stride) {
    const bool live = p.valid[i] != 0;
    uint64_t h = 0;
    for (int j = 0; j < p.nops; ++j) {
      h = splitmix64(h ^ static_cast<uint64_t>(value(p.ops[j], i)));
    }
    p.first[i] = static_cast<int32_t>(h & static_cast<uint64_t>(mask));
    p.rep[i] = live ? cap : static_cast<int32_t>(i);
    p.resolved[i] = live ? 0 : 1;
    active += live;
  }
  active = block_sum(active, smem);
  if (threadIdx.x == 0) p.partial[blockIdx.x] = active;
  grid.sync();

  int r = 0;
  for (; r < p.rounds && grid_total(p, smem) > 0; ++r) {
    // 1. active rows whose slot has no owner claim it; the lanes of a
    //    warp that claim one slot agree on their smallest row first, so
    //    a slot takes one atomic per warp (a global aggregation's rows,
    //    or a few groups', all claim a handful of slots at once)
    for (long long i = start; i < p.n; i += stride) {
      if (p.resolved[i]) continue;
      const int32_t slot = (p.first[i] + r) & mask;
      if (__ldcg(p.slots + slot) >= 0) {
        const cg::coalesced_group claiming = cg::coalesced_threads();
        const auto same = cg::labeled_partition(claiming, slot);
        const int32_t least = cg::reduce(same, static_cast<int32_t>(i),
                                         cg::less<int32_t>());
        if (same.thread_rank() == 0) atomicMin(p.slots + slot, least);
      }
    }
    grid.sync();
    // 2. the smallest claimant installs itself; every row compares its
    //    keys with the owner's (a row racing the install reads the owner
    //    untagged or tagged: the same row either way)
    int left = 0;
    for (long long i = start; i < p.n; i += stride) {
      if (p.resolved[i]) continue;
      const int32_t row = static_cast<int32_t>(i);
      const int32_t slot = (p.first[i] + r) & mask;
      const int32_t held = __ldcg(p.slots + slot);
      const int32_t owner = held & ~kOwned;
      if (held == row) p.slots[slot] = row | kOwned;
      bool eq = owner < cap;
      for (int j = 0; eq && owner != row && j < p.nops; ++j) {
        eq = value(p.ops[j], i) == value(p.ops[j], owner);
      }
      if (eq) {
        p.rep[i] = owner;
        p.resolved[i] = 1;
      } else {
        ++left;
      }
    }
    left = block_sum(left, smem);
    if (threadIdx.x == 0) p.partial[blockIdx.x] = left;
    grid.sync();
  }
  if (start == 0) *p.taken = r;
}

// Blocks of probe_kernel the device keeps resident at once (0: unknown).
int resident_grid(int device, cudaError_t* err) {
  static int cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    return cached[device];
  }
  int sms = 0, per_sm = 0, cooperative = 0;
  *err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                                device);
  if (*err != cudaSuccess) return 0;
  if (!cooperative) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                       kThreads, 0);
  if (*err != cudaSuccess) return 0;
  const int grid = sms * per_sm;
  if (device >= 0 && device < kMaxDevices) cached[device] = grid;
  return grid;
}

}  // namespace

extern "C" {

// The most operand descriptors a call takes, and the most blocks a call's
// grid has (the room the wrapper leaves for the partials).
int hash_insert_max_operands() { return kMaxOperands; }
int hash_insert_max_grid() { return kMaxGrid; }

// Inserts or looks up the n rows of one page. table: nops (at most
// kMaxOperands) descriptors on the host, two int64 each: the operand's
// device pointer (n values) and its code (0 bool or uint8, 1 int8,
// 2 int16, 3 int32, 4 int64). valid: n bools. Outputs on the device: rep
// (n int32), resolved (n bools), taken (1 int32, the rounds run). tsize:
// the table's slots, a power of two above n. scratch: room for
// tsize + n + max grid int32. Launches one cooperative kernel on `stream`
// and returns the first error (0 = cudaSuccess); a bad size, count or code
// returns cudaErrorInvalidValue and launches nothing.
int hash_insert(const long long* table, int nops, const void* valid,
                long long n, int rounds, void* rep, void* resolved,
                void* taken, long long tsize, void* scratch, void* stream) {
  if (nops < 0 || nops > kMaxOperands || n < 0 || n >= (1LL << 31) - 1 ||
      rounds < 0 || tsize < 2 || tsize > (1LL << 31) ||
      (tsize & (tsize - 1)) != 0 || tsize < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < nops; ++j) {
    if (table[2 * j + 1] < 0 || table[2 * j + 1] > 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = resident_grid(device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (grid < 1) grid = 1;

  Params p{};
  p.valid = static_cast<const uint8_t*>(valid);
  p.rep = static_cast<int32_t*>(rep);
  p.resolved = static_cast<uint8_t*>(resolved);
  p.taken = static_cast<int32_t*>(taken);
  p.slots = static_cast<int32_t*>(scratch);
  p.first = p.slots + tsize;
  p.partial = p.first + n;
  p.n = n;
  p.tsize = tsize;
  p.nops = nops;
  p.rounds = rounds;
  for (int j = 0; j < nops; ++j) {
    p.ops[j].ptr = reinterpret_cast<const void*>(table[2 * j]);
    p.ops[j].code = table[2 * j + 1];
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(probe_kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* hash_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
