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
//     yet resolved) probes slot (first + r) & (tsize - 1). Where the slot
//     was empty at the start of the round, the smallest row among the
//     round's claimants takes it (the reference's scatter-min), never
//     whichever thread wins a race. Every active row then compares its key
//     operands with the slot owner's: equal keys resolve the row into the
//     owner's group (rep = owner), others probe on in the next round.
//     The loop stops after `rounds` rounds, or before a round when no row
//     is active: the while_loop's own condition (:146-148). Rows still
//     active then keep rep = capacity and resolved = false (the caller's
//     overflow or singleton groups).
//   Outputs: rep (int32, the owner row per row; capacity for an unresolved
//   row, the row itself for an invalid one), resolved (bool), and two
//   int32: the rounds run and the barriers run.
//
// Round-tagged claims. A table entry holds (round << bits) | row, bits the
// width of the largest row index, so an entry claimed in an earlier round
// compares smaller; an empty slot is all ones. A claim in round r is an
// atomicMin of (r, row): it never beats an owner of an earlier round, and
// among the claims of one round the smallest row wins. So a claim needs no
// install step, and the compare of round r - 1 fuses with the claim of
// round r into one phase: in phase k every active row reads its round
// k - 1 slot's owner (the entry's low bits), compares keys, and, if still
// unresolved and k < rounds, claims its round k slot. This keeps the
// lockstep: the slot a row reads in phase k was claimed in round k - 1 or
// earlier, before the barrier that ended phase k - 1, so its entry is
// final (the round k - 1 minimum, or an earlier owner); every claim made in
// phase k carries round k, larger than that entry's round, so no claim of
// the phase can change what the phase reads, in whatever order the two
// run. Phase 0 hashes and claims round 0. A call runs phases 0..taken and
// one barrier after each phase but the last of a call that spends its
// whole budget: taken + 1 barriers, or `rounds` at the budget (the stop
// test needs the barrier; a call at the budget stops without one). The
// entry is 32 bits where (rounds << bits) < 2^32, every page up to 2^26
// lanes at the 32-round budget, else 64 bits; the wrapper chooses.
//
// One kernel, in device memory, under one cooperative launch
// (cudaLaunchCooperativeKernel: every block resident) of as many blocks as
// the device keeps resident, fewer for a small page. The call's buffer
// (the wrapper's `hash_plan` sizes it, this entry re-checks the size)
// holds rep and the rounds and barriers run, then the table and the
// barrier's three words, which a cudaMemsetAsync on the same stream fills
// with all ones before the launch, then the worklists where they spill;
// resolved is an allocation of its own. Block b owns the tiles of 512
// rows b, b + grid, b + 2 grid, ..., so the live rows of a merge, bunched
// in its partials' stretches, spread over every block. Phase 0 writes each row's rep and resolved and
// keeps the block's active rows, with their first slot, in a worklist: in
// shared memory where its tiles hold at most 4,096 rows (every page up to
// 4,096 x the resident grid: 2,162,688 lanes on an H100's 528 blocks),
// else in its place in the buffer. Each later phase walks only the list,
// in tiles, compacting the rows still active in place (a tile is read
// before the __syncthreads that lets any of its entries be overwritten),
// so a row costs nothing after the round it resolves in. A claim is
// reduced per warp (cg::labeled_partition, the least of the lanes that
// name one slot, whatever their order), then goes to a block cache of
// 1,024 hot slots (a shared atomicMin) flushed to the table once per
// phase: a few-group page or a global aggregation takes about one global
// atomic per block and slot; a slot that misses the cache is claimed
// directly; a claim reads the entry first and skips the atomic when it is
// already smaller. The barrier is the kernel's own, one atomicAdd per
// block: it adds (count << 32) | 1, count the block's claims of the
// phase, to a word the memset left all ones, so the word's low half
// counts the arrivals and its high half sums the grid's claims, the stop
// test, with no second pass; phase k uses word k % 3 and block 0 sets word
// (k + 1) % 3, last read before the previous barrier, back to all ones.
// The table is written by other blocks during the call, so it is read
// through L2 (__ldcg); the key operands are inputs and take the read-only
// path. Bound by its barriers (one a phase) and, on the largest pages, by
// the compare's random reads of owner keys. Two other designs were built
// and timed against it and left out (PERF.md, section 6): a 16-block
// cluster tier (the table in distributed shared memory), slower at every
// page it could hold, and a one-block tier (the table in shared memory),
// faster by at most a few microseconds on pages of up to 512 lanes and
// slower above them.
//
// Bound: memory. The key operands of the live rows are read twice (the
// hash, and the compare against the owner row; no row reads a dead lane's
// keys), the valid mask once, the table (tsize int32) written once, rep
// and resolved written once. At TPC-H q1's aggregation page at SF1 with
// every lane live (262,144 rows, two keys as (uint8, int64) operand
// pairs, tsize 524,288) that is
// 2 x 4,718,592 + 262,144 + 524,288 x 4 + 1,048,576 + 262,144
// = 13,107,200 bytes, 0.0039 ms at 3.35 TB/s. A round's work is a few
// random accesses per active row, far below the card's rates; what a
// call pays beyond its bytes is its launch and its barriers, one a round.

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOperands = 240;      // descriptors passed by value
constexpr int kMaxGrid = 4096;         // blocks at most
constexpr int kMaxDevices = 64;        // devices whose set-up is cached
constexpr int kGridThreads = 512;      // threads of a block
constexpr int kListRows = 4096;        // a block's list in shared memory
constexpr int kCacheSlots = 1024;      // a block's cache of hot slots
constexpr int kSyncWords = 3;          // the grid barrier's words, in turn

using E64 = unsigned long long;

// One key operand, as the wrapper packs it: two int64 (16 bytes).
struct Operand {
  const void* ptr;
  long long code;  // 0 bool or uint8, 1 int8, 2 int16, 3 int32, 4 int64
};

struct Params {
  const uint8_t* valid;    // n bools
  int32_t* rep;            // n
  uint8_t* resolved;       // n bools
  int32_t* stats;          // 2: rounds run, barriers run
  void* table;             // tsize entries
  E64* sync;               // kSyncWords barrier words
  int2* list;              // a (row, first slot) pair a row, whole tiles,
                           // where the lists spill; else null
  long long n;
  long long tsize;         // a power of two
  int nops;
  int rounds;
  int bits;                // of the largest row index
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

// Row i's first slot.
__device__ __forceinline__ int32_t first_slot(const Params& p, long long i) {
  uint64_t h = 0;
  for (int j = 0; j < p.nops; ++j) {
    h = splitmix64(h ^ static_cast<uint64_t>(value(p.ops[j], i)));
  }
  return static_cast<int32_t>(h & static_cast<uint64_t>(p.tsize - 1));
}

// Whether row i belongs to owner's group: the owner itself, or every key
// operand equal.
__device__ __forceinline__ bool same_group(const Params& p, int32_t i,
                                           int32_t owner) {
  bool eq = true;
  for (int j = 0; eq && owner != i && j < p.nops; ++j) {
    eq = value(p.ops[j], i) == value(p.ops[j], owner);
  }
  return eq;
}

template <typename E>
__device__ __forceinline__ E tag(int round, int32_t row, int bits) {
  return (static_cast<E>(round) << bits) | static_cast<E>(row);
}

// ---------------------------------------------------------------------------
// the kernel

template <typename E>
struct GridShared {
  int2 list[kListRows];       // the block's worklist, where its rows fit
  int32_t key[kCacheSlots];   // the cache's slots (-1: free)
  E least[kCacheSlots];       // the least claim of each cached slot
  long long total;            // the grid's claims, after a barrier
  int count[2];               // rows appended to the list, by phase parity
};

// A claim of a table entry in device memory: skipped when the entry is
// already smaller (entries only decrease).
template <typename E>
__device__ __forceinline__ void claim_global(E* at, E v) {
  if (__ldcg(at) > v) atomicMin(at, v);
}

// One claim through the block's cache of hot slots, the claims of one
// slot by the lanes of a warp reduced to their least first.
template <typename E>
__device__ __forceinline__ void block_claim(GridShared<E>& s, E* table,
                                            int32_t slot, E v) {
  const cg::coalesced_group claiming = cg::coalesced_threads();
  const auto same = cg::labeled_partition(claiming, slot);
  v = cg::reduce(same, v, cg::less<E>());
  if (same.thread_rank() != 0) return;
  const int h = slot & (kCacheSlots - 1);
  const int32_t held = atomicCAS(&s.key[h], -1, slot);
  if (held == -1 || held == slot) {
    atomicMin(&s.least[h], v);
  } else {
    claim_global(table + slot, v);
  }
}

// The grid barrier of phase k, which also sums the blocks' counts: each
// block adds (count << 32) | 1 to word k % 3, which the wrapper's memset
// left all ones, and waits for the grid's arrivals. All ones plus the sum
// x of the adds is x - 1, so the arrivals are complete at gridDim.x - 1 in
// the low half, and the high half is then the grid's count. Block 0 sets
// word (k + 1) % 3, last read before the barrier of phase k - 1, back to
// all ones for phase k + 1. Every thread of the block gets the count.
template <typename E>
__device__ long long grid_barrier(GridShared<E>& s, E64* sync, int k,
                                  int count) {
  __syncthreads();  // the block's claims, appends and stores are made
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) {
      *static_cast<volatile E64*>(sync + (k + 1) % kSyncWords) = ~0ULL;
    }
    __threadfence();
    E64* word = sync + k % kSyncWords;
    const E64 add = (static_cast<E64>(count) << 32) | 1ULL;
    E64 seen = atomicAdd(word, add) + add;
    while ((seen & 0xffffffffULL) != gridDim.x - 1) {
      __nanosleep(32);
      seen = *static_cast<volatile E64*>(word);
    }
    __threadfence();
    s.total = static_cast<long long>(seen >> 32);
  }
  __syncthreads();
  return s.total;
}

template <typename E>
__global__ void __launch_bounds__(kGridThreads) grid_kernel(const Params p) {
  __shared__ GridShared<E> s;
  E* table = static_cast<E*>(p.table);
  const int tid = threadIdx.x;
  // the block's rows: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
  // kGridThreads rows, so live rows bunched in a stretch of the page (a
  // merge's partials) spread over every block; its list has room for
  // them at its place in p.list, after the tiles of the blocks before it
  const long long tiles = (p.n + kGridThreads - 1) / kGridThreads;
  const long long block = blockIdx.x;
  const long long per = tiles / gridDim.x, extra = tiles % gridDim.x;
  const long long mine = per + (block < extra ? 1 : 0);
  const long long place = block * per + (block < extra ? block : extra);
  int2* list = mine * kGridThreads <= kListRows
      ? s.list : p.list + place * kGridThreads;
  const int32_t cap = static_cast<int32_t>(p.n);
  const int32_t mask = static_cast<int32_t>(p.tsize - 1);
  const E rowmask = (E(1) << p.bits) - 1;
  for (int h = tid; h < kCacheSlots; h += kGridThreads) {
    s.key[h] = -1;
    s.least[h] = ~E(0);
  }
  if (tid < 2) s.count[tid] = 0;
  __syncthreads();

  // phase 0: rep and resolved of every row; each active row's first slot,
  // its round-0 claim and its place in the list
  for (long long t = block; t < tiles; t += gridDim.x) {
    const long long i = t * kGridThreads + tid;
    if (i >= p.n) continue;
    const bool live = p.valid[i] != 0;
    p.rep[i] = live ? cap : static_cast<int32_t>(i);
    p.resolved[i] = live ? 0 : 1;
    if (live && p.rounds > 0) {
      const int32_t first = first_slot(p, i);
      block_claim(s, table, first, tag<E>(0, static_cast<int32_t>(i), p.bits));
      list[atomicAdd(&s.count[0], 1)] = make_int2(static_cast<int>(i), first);
    }
  }
  int k = 0, taken = 0, barriers = 0;
  while (p.rounds > 0) {
    // end of phase k: the claims flushed, then the barrier and its count
    __syncthreads();
    const int count = s.count[k & 1];
    for (int h = tid; h < kCacheSlots; h += kGridThreads) {
      const int32_t slot = s.key[h];
      if (slot >= 0) {
        claim_global(table + slot, s.least[h]);
        s.key[h] = -1;
        s.least[h] = ~E(0);
      }
    }
    // read by every thread before the last barrier
    if (tid == 0) s.count[(k + 1) & 1] = 0;
    ++barriers;
    if (grid_barrier(s, p.sync, k, count) == 0) {
      taken = k;
      break;
    }
    // phase k + 1: compare round k, claim round k + 1 under the budget
    ++k;
    const bool claims = k < p.rounds;
    for (int base = 0; base < count; base += kGridThreads) {
      const int j = base + tid;
      const bool have = j < count;
      int2 e = make_int2(0, 0);
      if (have) e = list[j];
      __syncthreads();  // the tile is read before any entry is overwritten
      if (!have) continue;
      const int32_t row = e.x;
      const E held = __ldcg(table + ((e.y + k - 1) & mask));
      const int32_t owner = static_cast<int32_t>(held & rowmask);
      if (held != ~E(0) && same_group(p, row, owner)) {
        p.rep[row] = owner;
        p.resolved[row] = 1;
      } else if (claims) {
        block_claim(s, table, (e.y + k) & mask, tag<E>(k, row, p.bits));
        list[atomicAdd(&s.count[k & 1], 1)] = e;
      }
    }
    if (!claims) {
      taken = k;
      break;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    p.stats[0] = taken;
    p.stats[1] = barriers;
  }
}

// ---------------------------------------------------------------------------
// set-up, once per device

// Blocks of grid_kernel<E> the device keeps resident at once (0: unknown).
template <typename E>
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
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grid_kernel<E>, kGridThreads, 0);
  if (*err != cudaSuccess) return 0;
  const int grid = sms * per_sm;
  if (device >= 0 && device < kMaxDevices) cached[device] = grid;
  return grid;
}

int bits_of(long long n) {
  int b = 0;
  while (b < 63 && (1LL << b) < n) ++b;  // rows 0..n-1 fit in b bits
  return b;
}

// Where the call's buffer puts each part (the wrapper's `hash_layout`
// computes the same): rep (n int32) at 0, the rounds and barriers run (2
// int32) after it, the table (tsize entries) at the next multiple of 256
// bytes, the barrier's words after the table, and the lists (a pair a
// row, whole tiles), where they spill, after the words. Returns the
// buffer's bytes.
long long layout(long long n, long long tsize, int width, bool spills,
                 long long* table_at, long long* list_at) {
  *table_at = (4 * n + 8 + 255) / 256 * 256;
  *list_at = *table_at + tsize * (width / 8) + 8 * kSyncWords;
  const long long tiles = (n + kGridThreads - 1) / kGridThreads;
  return *list_at + (spills ? 8 * tiles * kGridThreads : 0);
}

}  // namespace

extern "C" {

// The most operand descriptors a call takes, the most blocks of a call,
// its threads a block and the rows of a block's list in shared memory.
int hash_insert_max_operands() { return kMaxOperands; }
int hash_insert_max_grid() { return kMaxGrid; }
int hash_insert_grid_threads() { return kGridThreads; }
int hash_insert_list_rows() { return kListRows; }

// The blocks of the kernel with `width`-bit entries the current device
// keeps resident at once (what a call's grid may hold), or minus a CUDA
// error.
int hash_insert_resident_grid(int width) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (width != 32 && width != 64) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = width == 32 ? resident_grid<uint32_t>(device, &err)
                               : resident_grid<E64>(device, &err);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return grid;
}

// Inserts or looks up the n rows of one page. table: nops (at most
// kMaxOperands) descriptors on the host, two int64 each: the operand's
// device pointer (n values) and its code (0 bool or uint8, 1 int8,
// 2 int16, 3 int32, 4 int64). valid: n bools. The plan, as the wrapper's
// `hash_plan` makes it: the entry width (32 or 64), the blocks (at most
// the resident grid: the launch is cooperative) and the bytes of `out`,
// the call's buffer (see `layout`): rep (n int32, the owner row per row),
// the rounds run and the barriers run, then the table, its barrier's
// words and the spilled lists as scratch. resolved: n bools. tsize: the
// table's slots, a power of two at least n. Launches on `stream` (a
// memset of the table and the barrier's words, then one cooperative
// kernel) and returns the first error (0 = cudaSuccess); a plan that
// does not hold the call, or a bad size, count or code, returns
// cudaErrorInvalidValue and launches nothing.
int hash_insert(const long long* table, int nops, const void* valid,
                long long n, int rounds, int width, int blocks, void* out,
                void* resolved, long long out_bytes, long long tsize,
                void* stream) {
  if (nops < 0 || nops > kMaxOperands || n < 0 || n >= (1LL << 31) - 1 ||
      rounds < 0 || tsize < 2 || tsize > (1LL << 31) ||
      (tsize & (tsize - 1)) != 0 || tsize < n || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < nops; ++j) {
    if (table[2 * j + 1] < 0 || table[2 * j + 1] > 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int bits = bits_of(n);
  const bool narrow = (static_cast<E64>(rounds) << bits) < (1ULL << 32);
  const long long tiles = (n + kGridThreads - 1) / kGridThreads;
  if ((width != 32 && width != 64) || (width == 32 && !narrow) ||
      blocks < 1 || blocks > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = width == 32 ? resident_grid<uint32_t>(device, &err)
                                   : resident_grid<E64>(device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > resident) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  // a block's tiles: (tiles + blocks - 1) / blocks at most
  const bool spills = (tiles + blocks - 1) / blocks * kGridThreads > kListRows;
  long long table_at = 0, list_at = 0;
  const long long need = layout(n, tsize, width, spills, &table_at, &list_at);
  if (out_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  char* base = static_cast<char*>(out);
  Params p{};
  p.valid = static_cast<const uint8_t*>(valid);
  p.rep = reinterpret_cast<int32_t*>(base);
  p.stats = p.rep + n;
  p.resolved = static_cast<uint8_t*>(resolved);
  p.table = base + table_at;
  p.sync = reinterpret_cast<E64*>(base + table_at + tsize * (width / 8));
  p.list = spills ? reinterpret_cast<int2*>(base + list_at) : nullptr;
  p.n = n;
  p.tsize = tsize;
  p.nops = nops;
  p.rounds = rounds;
  p.bits = bits;
  for (int j = 0; j < nops; ++j) {
    p.ops[j].ptr = reinterpret_cast<const void*>(table[2 * j]);
    p.ops[j].code = table[2 * j + 1];
  }
  void* args[] = {&p};
  const void* kernel = width == 32
      ? reinterpret_cast<const void*>(grid_kernel<uint32_t>)
      : reinterpret_cast<const void*>(grid_kernel<E64>);
  err = cudaMemsetAsync(p.table, 0xFF,
                        static_cast<size_t>(list_at - table_at), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kGridThreads), args,
      0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* hash_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
