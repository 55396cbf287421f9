"""Hand-written CUDA kernels of the torch engine, and their plain versions.

The counterpart of ``trino_tpu/ops/pallas_kernels.py``. Each kernel has:

- its CUDA source under ``trino_tpu_torch/csrc/``, compiled for Hopper
  (``sm_90a``) at first use into ``trino_tpu_torch/_build/`` as a shared
  library with a plain C interface, loaded with ``ctypes``;
- a plain PyTorch version of the same function (``*_reference``), which
  the wrapper runs for tensors on the CPU and nothing on the CUDA path
  calls;
- a wrapper that launches the kernel for CUDA tensors and counts its
  launches in a plain integer attribute (``segment_reduce.launches``);
  the library call runs through the program profiler as the JAX
  engine's ``segment_reduce_pallas`` program, so under profiling its
  calls equal its launches and its device time is read from CUDA
  events around the launch alone.

A CUDA tensor never reaches the plain version: a wrong dtype, layout or
device, a failed build and a failed launch all raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: every kernel source, one library each
SEGMENT_SOURCE = "segment_reduce.cu"
HASH_SOURCE = "hash_insert.cu"
SOURCES = (SEGMENT_SOURCE, HASH_SOURCE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_hash_lib: Optional[ctypes.CDLL] = None
#: wall ms of each library's build (when this process built it) and load,
#: by source; charged once per process to its kernel's first profiler entry
_load_ms = {}
_load_ms_charged = set()
_build_lock = threading.Lock()
#: guards the launch counters: a server runs statements on several
#: threads, and ``launches += 1`` is not atomic under threads
_count_lock = threading.Lock()
#: per kernel, while a list: a copy of the inputs of every call that
#: launches it, in launch order (``record_calls``)
_recorded = {"segment_reduce": None, "hash_insert": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(source: str) -> str:
    """The build output of ``source``, named by a hash of the source and
    the flags, so an edited source never loads a stale library."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build() -> List[str]:
    """Compile every source of ``SOURCES`` whose library does not exist,
    one ``nvcc`` per source, all started together; returns the
    libraries' paths in the order of ``SOURCES``. Raises with the
    compiler's output if a build fails."""
    paths = [_library_path(source) for source in SOURCES]
    todo = [(source, path) for source, path in zip(SOURCES, paths)
            if not os.path.exists(path)]
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for source, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        running.append((source, path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for source, path, tmp, proc in running:
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{source}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, path)  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def _open(source: str) -> ctypes.CDLL:
    """Build (if need be) and load the library of ``source``, keeping the
    wall it took. Call under the build lock."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(build()[SOURCES.index(source)])
    _load_ms[source] = (time.perf_counter() - t0) * 1e3
    return lib


def _check_constants(lib, kernel: str, names, want) -> None:
    """Raises unless the library's compile-time constants ``names`` (C
    functions of no argument) are the values the wrapper was written
    for."""
    for name in names:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    got = tuple(getattr(lib, name)() for name in names)
    if got != want:
        raise RuntimeError(f"{kernel} library: {', '.join(names)} = {got}, "
                           f"the wrapper expects {want}")


def _library() -> ctypes.CDLL:
    global _lib
    with _build_lock:
        if _lib is None:
            lib = _open(SEGMENT_SOURCE)
            vp = ctypes.c_void_p
            lib.segment_reduce_columns.argtypes = [
                ctypes.c_char_p, ctypes.c_int, vp, vp, ctypes.c_longlong,
                ctypes.c_longlong, vp, vp, vp, vp]
            lib.segment_reduce_columns.restype = ctypes.c_int
            lib.segment_reduce_error_string.argtypes = [ctypes.c_int]
            lib.segment_reduce_error_string.restype = ctypes.c_char_p
            _check_constants(lib, "segment_reduce",
                             ("segment_reduce_tile_rows",
                              "segment_reduce_inline_columns"),
                             (TILE_ROWS, INLINE_COLUMNS))
            _lib = lib
        return _lib


def _hash_library() -> ctypes.CDLL:
    global _hash_lib
    with _build_lock:
        if _hash_lib is None:
            lib = _open(HASH_SOURCE)
            vp = ctypes.c_void_p
            lib.hash_insert.argtypes = [
                ctypes.c_char_p, ctypes.c_int, vp, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp,
                ctypes.c_longlong, ctypes.c_longlong, vp]
            lib.hash_insert.restype = ctypes.c_int
            lib.hash_insert_resident_grid.argtypes = [ctypes.c_int]
            lib.hash_insert_resident_grid.restype = ctypes.c_int
            lib.hash_insert_error_string.argtypes = [ctypes.c_int]
            lib.hash_insert_error_string.restype = ctypes.c_char_p
            _check_constants(lib, "hash_insert",
                             ("hash_insert_max_operands",
                              "hash_insert_max_grid",
                              "hash_insert_grid_threads",
                              "hash_insert_list_rows"),
                             (HASH_MAX_OPERANDS, HASH_MAX_GRID,
                              HASH_GRID_THREADS, HASH_LIST_ROWS))
            _hash_lib = lib
        return _hash_lib


def _charge(source: str) -> float:
    """The build + load wall of ``source``'s library, the first time it is
    asked for after the library loaded (once per process), else 0."""
    with _build_lock:
        if source in _load_ms_charged or source not in _load_ms:
            return 0.0
        _load_ms_charged.add(source)
        return _load_ms[source]


def _charge_load_ms() -> float:
    return _charge(SEGMENT_SOURCE)


def _charge_hash_load_ms() -> float:
    return _charge(HASH_SOURCE)


# ---------------------------------------------------------------------------
# segment reduce
#
# Replaces trino_tpu/ops/pallas_kernels.py `segment_reduce` (:226), which
# launches `_segment_reduce_pallas` (:172) / `_kernel` (:100), and the
# per-column loop around it (trino_tpu/ops/hashtable.py
# `_hash_segment_reduce_impl`): one call reduces every state column of a
# page, reading the columns through the gid sort's permutation. Bound on
# Hopper: memory — the gids and the permutation are read once per row,
# each column once per row, each column's segments written once. At q1's
# aggregation page (262,144 rows, 15 int64 SUM states, 262,145 segments)
# that is 66.06 MB, 0.0197 ms at 3.35 TB/s. The design, described in
# csrc/segment_reduce.cu: at most two launches per call whatever the
# columns' dtypes and kinds; a block per 2,048-row tile reads the gids and
# the permutation once for every column (through a cp.async ring), writes
# each segment inside its tile and the identity into the unnamed segments
# near its gids, while the grid's blocks share the long unnamed stretches;
# a second launch folds the tile-edge carries in tile order. No atomics.
# The wrapper's host work per call: the checks, one output block per
# dtype (the carries' scratch carved from the first), one packed
# descriptor table (``plan_columns`` lays it all out, cached per shape)
# and the library call, profiled under the plan's key rather than a
# token of every tensor argument.

SEGMENT_KINDS = ("sum", "min", "max")
_KIND_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}
#: rows per tile of csrc/segment_reduce.cu (``kTile``) and the most
#: columns whose descriptors ride in the launch parameters (``kInline``);
#: the library's own values are checked against these when it loads
TILE_ROWS = 2048
INLINE_COLUMNS = 32
#: bytes of one column descriptor: input pointer, output pointer, code
DESCRIPTOR_BYTES = 24


def segment_identity(kind: str, dtype: torch.dtype):
    """The value an empty segment holds: 0 for SUM, the dtype's largest
    value (or +inf) for MIN, its smallest (or -inf) for MAX."""
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce_reference(col: torch.Tensor, gid: torch.Tensor,
                             num_segments: int, kind: str) -> torch.Tensor:
    """Plain PyTorch version: the reduction of ``col`` per group id in
    ``[0, num_segments)``, the identity in empty segments, out-of-range
    ids dropped. Takes gids in any order."""
    out = torch.full((num_segments,), segment_identity(kind, col.dtype),
                     dtype=col.dtype, device=col.device)
    keep = (gid >= 0) & (gid < num_segments)
    idx = gid[keep].to(torch.int64)
    vals = col[keep]
    if kind == "sum":
        return out.index_add_(0, idx, vals)
    return out.scatter_reduce_(0, idx, vals,
                               "amin" if kind == "min" else "amax",
                               include_self=True)


def segment_reduce_columns_reference(cols: Sequence[torch.Tensor],
                                     gid: torch.Tensor, num_segments: int,
                                     kinds: Sequence[str],
                                     order: Optional[torch.Tensor] = None
                                     ) -> List[torch.Tensor]:
    """Plain PyTorch version of ``segment_reduce_columns``: per column,
    ``segment_reduce_reference`` of the column read through ``order``."""
    return [segment_reduce_reference(col if order is None else col[order],
                                     gid, num_segments, kind)
            for col, kind in zip(cols, kinds)]


class ColumnsPlan(NamedTuple):
    """Where one call's outputs, scratch and descriptors go (see
    ``plan_columns``)."""
    #: per column: dtype code * 3 + kind code, as the kernel reads it
    codes: Tuple[int, ...]
    #: per output block: (dtype, rows); a block's rows are its columns'
    #: outputs of ``num_segments`` values each, and block 0 has extra rows
    #: holding the scratch
    blocks: Tuple[Tuple[torch.dtype, int], ...]
    #: per column: (block, row) of its output
    slots: Tuple[Tuple[int, int], ...]
    #: per output block: the rows that are outputs
    out_rows: Tuple[int, ...]
    #: byte offsets into block 0 of the carries' gids (2 per tile), their
    #: values (8 bytes per tile edge and column) and the device copy of the
    #: descriptor table (-1: the descriptors ride in the launch)
    carry_gid_offset: int
    carry_val_offset: int
    table_offset: int
    #: the descriptor table's layout: three int64 per column
    table: struct.Struct
    #: (dtypes, kinds, n, num_segments): what the call's shapes are, the
    #: profiled library call's signature
    key: tuple


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def plan_columns(dtypes: Sequence[torch.dtype], kinds: Sequence[str],
                 n: int, num_segments: int) -> ColumnsPlan:
    """The layout of one ``segment_reduce_columns`` call of ``n`` rows into
    ``num_segments`` segments: one output block per dtype (in the order
    the dtypes first appear), its columns as rows; the kernel's scratch
    (the tile-edge carries and, past ``INLINE_COLUMNS`` columns, the
    descriptor table) in extra rows of block 0, 16-byte aligned, so a call
    makes one allocation per dtype. A pure function of its arguments
    (cached): raises on a dtype or kind the kernel does not take."""
    return _plan(tuple(dtypes), tuple(kinds), n, num_segments)


@functools.lru_cache(maxsize=1024)
def _plan(dtypes: tuple, kinds: tuple, n: int,
          num_segments: int) -> ColumnsPlan:
    codes, slots, block_of, counts = [], [], {}, []
    for dtype, kind in zip(dtypes, kinds):
        code = _DTYPE_CODE.get(dtype)
        if code is None:
            raise TypeError(f"segment_reduce: unsupported dtype {dtype}")
        if kind not in _KIND_CODE:
            raise ValueError(f"segment_reduce: unknown kind {kind!r}")
        codes.append(code * 3 + _KIND_CODE[kind])
        b = block_of.setdefault(dtype, len(block_of))
        if b == len(counts):
            counts.append(0)
        slots.append((b, counts[b]))
        counts[b] += 1
    codes, slots = tuple(codes), tuple(slots)
    blocks = tuple(zip(block_of, counts))
    table = struct.Struct(f"<{3 * len(codes)}q")
    k = len(codes)
    key = (dtypes, kinds, n, num_segments)
    out_rows = tuple(rows for _, rows in blocks)
    if not blocks or num_segments == 0:
        # nothing is written, so nothing is launched and no scratch needed
        return ColumnsPlan(codes, blocks, slots, out_rows, 0, 0, -1, table,
                           key)
    carries = 2 * -(-n // TILE_ROWS)
    dtype0, rows0 = blocks[0]
    row_bytes = num_segments * dtype0.itemsize
    gid_off = _align16(rows0 * row_bytes)
    val_off = _align16(gid_off + 4 * carries)
    end = val_off + 8 * carries * k
    table_off = -1
    if k > INLINE_COLUMNS:
        table_off, end = end, end + DESCRIPTOR_BYTES * k
    return ColumnsPlan(
        codes, ((dtype0, -(-end // row_bytes)),) + blocks[1:], slots,
        out_rows, gid_off, val_off, table_off, table, key)


def _check(cols, gid, order, num_segments: int) -> None:
    """Raises on tensors the kernel does not take (dtypes and kinds are
    checked by ``plan_columns``). Cheap tensor attributes only: this runs
    on every call."""
    d = gid.get_device()
    if d < 0 or any(c.get_device() != d for c in cols) or \
            (order is not None and order.get_device() != d):
        raise ValueError(
            "segment_reduce: col on "
            f"{sorted({str(c.device) for c in cols})}, gid on {gid.device}, "
            f"order on {None if order is None else order.device}; all must "
            "be on one CUDA device (or all on the CPU)")
    if gid.dtype != torch.int32:
        raise TypeError(f"segment_reduce: gid must be int32, not {gid.dtype}")
    shape = gid.shape
    if len(shape) != 1 or not gid.is_contiguous():
        raise ValueError("segment_reduce: gid must be 1-D and contiguous")
    for col in cols:
        if col.shape != shape:
            raise ValueError(
                f"segment_reduce: col {tuple(col.shape)} and gid "
                f"{tuple(shape)} must be 1-D and of one length")
        if not col.is_contiguous():
            raise ValueError("segment_reduce: col must be contiguous")
    if order is not None:
        if order.dtype != torch.int64:
            raise TypeError(
                f"segment_reduce: order must be int64, not {order.dtype}")
        if order.shape != shape or not order.is_contiguous():
            raise ValueError(
                f"segment_reduce: order {tuple(order.shape)} must be 1-D, "
                f"contiguous and of gid's length {shape[0]}")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"segment_reduce: num_segments {num_segments} "
                         "out of range")


def segment_reduce_columns(cols: Sequence[torch.Tensor], gid: torch.Tensor,
                           num_segments: int, kinds: Sequence[str],
                           order: Optional[torch.Tensor] = None
                           ) -> List[torch.Tensor]:
    """SUM, MIN or MAX (``kinds[i]``) of every column ``cols[i]`` over
    segments of SORTED int32 group ids (non-decreasing; the engine's gids
    step by at most 1, then jump to the dump segment), identity in empty
    segments, int sums wrapping. With ``order`` (int64 row indices, the
    permutation that sorted the gids), row r of a column is
    ``col[order[r]]``, so the caller gathers nothing.

    CPU tensors take the plain version. CUDA tensors launch the Hopper
    kernel once for all columns (one call of the library, counted in
    ``segment_reduce.launches``); unsorted gids on CUDA give undefined
    (but in-bounds) results, as do indices in ``order`` outside
    ``[0, len(gid))``."""
    cols = list(cols)
    if len(cols) != len(kinds):
        raise ValueError(f"segment_reduce: {len(cols)} columns, "
                         f"{len(kinds)} kinds")
    for kind in kinds:
        if kind not in _KIND_CODE:
            raise ValueError(f"segment_reduce: unknown kind {kind!r}")
    if not (gid.is_cuda or any(c.is_cuda for c in cols)
            or (order is not None and order.is_cuda)):
        return segment_reduce_columns_reference(cols, gid, num_segments,
                                                kinds, order)
    _check(cols, gid, order, num_segments)
    plan = plan_columns([c.dtype for c in cols], kinds, gid.shape[0],
                        num_segments)
    if not cols:
        return []
    if _recorded["segment_reduce"] is not None:
        _record("segment_reduce", (
            [c.clone() for c in cols], gid.clone(), num_segments,
            list(kinds), None if order is None else order.clone()))
    return _launch(cols, gid, num_segments, tuple(kinds), order, plan)


def allocate_outputs(plan: ColumnsPlan, num_segments: int, device):
    """The call's outputs (1-D views of ``num_segments`` values into one
    block per dtype, in column order), each output's address, and the
    address of the scratch block (block 0)."""
    blocks = [torch.empty((rows, num_segments), dtype=dtype, device=device)
              for dtype, rows in plan.blocks]
    # a block's views in one op: block 0's scratch rows are one or two
    # when the segments are about as many as the rows, and then a view
    # each costs less than slicing them off first
    views = [b.unbind(0) if b.shape[0] - rows <= 2 else b[:rows].unbind(0)
             for b, rows in zip(blocks, plan.out_rows)]
    bases = [b.data_ptr() for b in blocks]
    pitch = [num_segments * dtype.itemsize for dtype, _ in plan.blocks]
    outs = [views[b][r] for b, r in plan.slots]
    ptrs = [bases[b] + r * pitch[b] for b, r in plan.slots]
    return outs, ptrs, bases[0]


def _launch(cols, gid, num_segments: int, kinds: tuple, order,
            plan: ColumnsPlan) -> List[torch.Tensor]:
    """One launch of the kernel's library over checked CUDA tensors: the
    outputs and the scratch are allocated and the descriptor table packed
    here, then ``_run`` makes the library call."""
    if _lib is None:  # qlint: ignore[cache-coherence] load-once handle: set once, under the build lock, before the first launch; no cached value depends on it
        _library()  # qlint: ignore[trace-purity] the kernel's load-once: build and load on a process's first launch, as a jitted program compiles on its first trace
    outs, ptrs, scratch = allocate_outputs(plan, num_segments, gid.device)
    table = plan.table.pack(*[v for c, o, code in zip(cols, ptrs,
                                                      plan.codes)
                              for v in (c.data_ptr(), o, code)])
    _run(cols, gid, order, outs, num_segments, kinds, plan, table, scratch)
    return outs


def _run_ops(cols, gid, *_):
    """One operation per state column per row: the count
    ``chip_smoke.py`` bounds the kernel with."""
    return len(cols) * gid.shape[0]


def _run_signature(cols, gid, order, outs, num_segments, kinds,
                   plan: ColumnsPlan, *_):
    """The library call's program signature: the call's dtypes, kinds,
    rows and segments, and whether it reads through ``order``."""
    return plan.key, order is None


def _run(cols, gid, order, outs, num_segments: int, kinds: tuple,
         plan: ColumnsPlan, table: bytes, scratch: int) -> None:
    """The library call: the tile and carry kernels of every column into
    ``outs``, on the current stream."""
    rc = _lib.segment_reduce_columns(  # qlint: ignore[cache-coherence] load-once handle (see _launch)
        table, len(cols), gid.data_ptr(),
        None if order is None else order.data_ptr(), gid.shape[0],
        num_segments, scratch + plan.carry_gid_offset,
        scratch + plan.carry_val_offset,
        None if plan.table_offset < 0 else scratch + plan.table_offset,
        _current_stream(gid.get_device()))
    if rc != 0:
        msg = _lib.segment_reduce_error_string(rc).decode(errors="replace")  # qlint: ignore[cache-coherence] load-once handle (see _launch)
        raise RuntimeError(f"segment_reduce launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _count_lock:  # qlint: ignore[trace-purity] the launch counter a run reads to show its path went through the kernel: one update per launch, by design
        segment_reduce.launches += 1


def _current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on the device (the
    binding Triton launches with: no Stream object per call)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


# the library call, profiled as the JAX engine's Pallas program
# (trino_tpu/ops/pallas_kernels.py ``segment_reduce_pallas``): recorded on
# every launch, even inside another profiled program. The outputs are
# allocated before it, so its event span holds the launch alone: when
# the stream is idle as the call begins (as on q1's pages), a span
# around the allocation would time the host's allocation instead. Its
# bytes are the inputs and the outputs, each once.
_run = instrument("segment_reduce_pallas", _run, flops=_run_ops,
                  kernel=True, compile_ms=_charge_load_ms,
                  signature=_run_signature)


def segment_tile_rows(device) -> int:
    """Rows per tile of the kernel on ``device`` (1 on the CPU, whose
    plain version has no tiles). A caller that lays several independent
    problems end to end in one call starts each at a multiple of this,
    so every problem sees the kernel's tile edges where it would see
    them alone, and a float sum associates in the same order."""
    if torch.device(device).type != "cuda":
        return 1
    _library()  # qlint: ignore[trace-purity] the kernel's load-once (see _launch)
    return TILE_ROWS


def segment_reduce(col: torch.Tensor, gid: torch.Tensor, num_segments: int,
                   kind: str) -> torch.Tensor:
    """``segment_reduce_columns`` of the one column ``col``."""
    return segment_reduce_columns([col], gid, num_segments, [kind])[0]


#: calls of the CUDA kernel's library since the last reset, one per
#: ``segment_reduce_columns`` call on the card (the CPU path never counts):
#: how a run shows that its main path went through the kernel
segment_reduce.launches = 0


# ---------------------------------------------------------------------------
# hash insert
#
# Replaces the probe loop of trino_tpu/ops/hashtable.py
# `_hash_group_ids_impl` (:111-155), a jit `jax.lax.while_loop` (:153), not
# a Pallas kernel: eager PyTorch has no device loop, and the same rounds as
# a Python loop of PyTorch ops read the device once per round to decide
# whether to go on. One call of csrc/hash_insert.cu runs every round on the
# device in the reference's lockstep order (the smallest row wins a
# contended slot), so its (rep, resolved, rounds run) equal the plain
# version's bit for bit. A table entry is (round << bits) | row, so a claim
# is one atomicMin that never beats an earlier round's owner, and the key
# compare of round r - 1 shares a phase with the claim of round r: the slot
# a phase compares against was claimed before the last barrier, and the
# phase's own claims carry a later round, so they cannot change it. One
# barrier a round (taken + 1 a call, `rounds` at the budget). One
# cooperative launch whose blocks keep worklists (in shared memory up to
# 4,096 rows a block, else spilled into the call's buffer), a block cache
# of hot slots and the kernel's own barrier that also sums the stop test;
# bound by its barriers and, at the largest pages, by the random reads of
# owner keys. ``hash_plan`` sizes the call from the rows, the budget and
# the card's resident grid (once per rows, budget and card). Bound on
# Hopper: memory — the live rows' key operands read twice, the valid mask
# once, the table (2 * capacity rounded up to a power of two, int32)
# written once, rep and resolved written once: at q1's page with every
# lane live (262,144 rows, four operands) 13.1 MB, 0.0039 ms at 3.35
# TB/s. The wrapper's host work per
# call: the checks, the plan (cached), two allocations (rep and the
# rounds and barriers run, with the kernel's table, barrier words and
# spilled worklists after them; resolved), one packed descriptor table
# and the library call.


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)
_M3 = _i64(0x9E3779B97F4A7C15)  # golden-ratio increment
#: the most operand descriptors a call takes, all passed in the launch
#: parameters (csrc/hash_insert.cu ``kMaxOperands``: 120 key columns), the
#: most blocks of a call (``kMaxGrid``), its threads a block
#: (``kGridThreads``) and the rows of a block's worklist in shared memory
#: (``kListRows``); the library's own values are checked when it loads
HASH_MAX_OPERANDS = 240
HASH_MAX_GRID = 4096
HASH_GRID_THREADS = 512
HASH_LIST_ROWS = 4096
_OPERAND_CODE = {torch.bool: 0, torch.uint8: 0, torch.int8: 1,
                 torch.int16: 2, torch.int32: 3, torch.int64: 4}


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 lanes holding uint64 bits:
    multiplication and addition wrap like uint64, and a logical right
    shift is the arithmetic shift masked to the bits that remain."""
    x = x + _M3
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def mix_operands(key_ops: Sequence[torch.Tensor], n: int, device
                 ) -> torch.Tensor:
    """Combine the flattened (tag, key) operand columns into one 64-bit
    hash per row. Zero key columns (global aggregation) hash to 0."""
    h = torch.zeros((n,), dtype=torch.int64, device=device)
    for op in key_ops:
        h = splitmix64(h ^ op.to(torch.int64))
    return h


def table_size(cap: int) -> int:
    """Slots of the hash table of a page of ``cap`` lanes: 2x capacity
    rounded up to a power of two (pages are pow2-padded already; an odd
    capacity still gets a sound ``& (size - 1)`` mask)."""
    return 1 << max(2 * cap - 1, 1).bit_length()


class HashPlan(NamedTuple):
    """How one ``hash_insert`` call runs on the card (``hash_plan``)."""
    width: int      # bits of a table entry, 32 or 64
    blocks: int     # the cooperative launch's blocks
    spills: bool    # a block's worklist outgrows its shared memory, so
                    # the lists take their place in the buffer
    nbytes: int     # the call's buffer (``hash_layout``)


def hash_entry_width(n: int, rounds: int) -> int:
    """Bits of a table entry ``(round << bits) | row`` of a call of ``n``
    rows and ``rounds`` rounds, ``bits`` the width of the largest row
    index: 32 while every tag stays below the all-ones empty entry of 32
    bits, else 64."""
    bits = max(n - 1, 0).bit_length()
    return 32 if rounds << bits < 1 << 32 else 64


def hash_layout(n: int, width: int, spills: bool) -> Tuple[int, int, int]:
    """(table offset, list offset, bytes) of the buffer of a call of ``n``
    rows (csrc/hash_insert.cu ``layout``): rep (n int32) at 0, the rounds
    and barriers run (two int32), the table (``table_size(n)`` entries of
    ``width`` bits) at the next multiple of 256 bytes, its barrier's three
    8-byte words, then, where they spill, the worklists (an 8-byte pair a
    row, whole tiles). A multiple of 8 bytes."""
    table_at = -(-(4 * n + 8) // 256) * 256
    list_at = table_at + table_size(n) * width // 8 + 24
    tiles = -(-n // HASH_GRID_THREADS)
    return table_at, list_at, list_at + (
        8 * tiles * HASH_GRID_THREADS if spills else 0)


def hash_plan(n: int, rounds: int, resident: int) -> HashPlan:
    """The plan of a ``hash_insert`` call of ``n`` rows and a budget of
    ``rounds`` on a card that keeps ``resident`` blocks of the kernel
    resident at once: a function of the three alone. A block a tile of
    ``HASH_GRID_THREADS`` rows, as many as the card holds (at most
    ``HASH_MAX_GRID``); a block's tiles (the ceiling of tiles over blocks)
    spill their worklist past ``HASH_LIST_ROWS`` rows. The C entry
    re-checks the plan against the call."""
    if resident < 1:
        raise ValueError(f"hash_plan: a resident grid of {resident} blocks")
    width = hash_entry_width(n, rounds)
    tiles = -(-n // HASH_GRID_THREADS)
    blocks = max(1, min(tiles, resident, HASH_MAX_GRID))
    spills = -(-tiles // blocks) * HASH_GRID_THREADS > HASH_LIST_ROWS
    return HashPlan(width, blocks, spills, hash_layout(n, width, spills)[2])


def hash_insert_reference(key_ops: Sequence[torch.Tensor],
                          valid: torch.Tensor, rounds: int):
    """Plain PyTorch version of ``hash_insert``: the rounds as a Python
    loop, each fully vectorized over the page, reading the device once
    per round to stop early."""
    device = valid.device
    cap = valid.shape[0]
    tsize = table_size(cap)
    row_idx = torch.arange(cap, dtype=torch.int32, device=device)
    slot0 = mix_operands(key_ops, cap, device) & (tsize - 1)

    # slot -> owning row index; ``cap`` = empty; slot ``tsize`` is the
    # dummy that absorbs scatters from masked-off lanes
    table = torch.full((tsize + 1,), cap, dtype=torch.int32, device=device)
    rep = torch.where(valid, cap, row_idx)  # resolved rows' owner row
    resolved = ~valid
    dummy = torch.tensor(tsize, dtype=torch.int64, device=device)

    # typical pages resolve in 1-3 rounds; the loop exits as soon as
    # every row found its group, paying the full budget only under
    # adversarial collision chains (one host read per round)
    taken = 0
    for r in range(rounds):
        active = ~resolved
        if not host_scalar(active.any(), "kernels.hash_round"):  # qlint: ignore[recompile] the plain version: a CUDA page runs the kernel, which reads nothing on the host
            break
        slot = torch.where(active, (slot0 + r) & (tsize - 1), dummy)
        owner = table[slot]
        empty = active & (owner == cap)
        # claim empty slots: smallest probing row index wins the install
        claim = torch.full((tsize + 1,), cap, dtype=torch.int32,
                           device=device)
        claim.scatter_reduce_(0, torch.where(empty, slot, dummy), row_idx,
                              "amin", include_self=True)
        winner = empty & (claim[slot] == row_idx)
        table.index_put_((torch.where(winner, slot, dummy),), row_idx)
        owner = table[slot]
        # full-key compare against the (possibly just-installed) owner
        owner_safe = torch.clamp(owner, 0, cap - 1).to(torch.int64)
        eq = active & (owner < cap)
        for op in key_ops:
            eq = eq & (op == op[owner_safe])
        rep = torch.where(eq, owner, rep)
        resolved = resolved | eq
        taken = r + 1
    return rep, resolved, torch.tensor(taken, dtype=torch.int32,
                                       device=device)


def _check_hash(key_ops, valid, rounds: int) -> None:
    """Raises on tensors the kernel does not take. Cheap tensor attributes
    only: this runs on every call."""
    d = valid.get_device()
    if d < 0 or any(op.get_device() != d for op in key_ops):
        raise ValueError(
            "hash_insert: key operands on "
            f"{sorted({str(op.device) for op in key_ops})}, valid on "
            f"{valid.device}; all must be on one CUDA device (or all on "
            "the CPU)")
    if valid.dtype != torch.bool:
        raise TypeError(f"hash_insert: valid must be bool, not {valid.dtype}")
    shape = valid.shape
    if len(shape) != 1 or not valid.is_contiguous():
        raise ValueError("hash_insert: valid must be 1-D and contiguous")
    if shape[0] >= 2 ** 31 - 1:
        raise ValueError(f"hash_insert: {shape[0]} rows, more than int32 "
                         "row indices hold")
    for op in key_ops:
        if op.dtype not in _OPERAND_CODE:
            raise TypeError(f"hash_insert: key operand of dtype {op.dtype} "
                            "(integer and bool operands only)")
        if op.shape != shape or not op.is_contiguous():
            raise ValueError(
                f"hash_insert: key operand {tuple(op.shape)} and valid "
                f"{tuple(shape)} must be 1-D, contiguous and of one length")
    if not 0 <= rounds < 2 ** 31:
        raise ValueError(f"hash_insert: rounds {rounds} out of range")
    if len(key_ops) > HASH_MAX_OPERANDS:
        raise ValueError(f"hash_insert: {len(key_ops)} key operands, the "
                         f"kernel takes at most {HASH_MAX_OPERANDS}")


def hash_insert(key_ops: Sequence[torch.Tensor], valid: torch.Tensor,
                rounds: int):
    """The linear-probe rounds of one vectorized insert-or-lookup of
    every valid row's key (the integer or bool operand columns
    ``key_ops``) into an open-addressing table of ``table_size(cap)``
    slots, at most ``rounds`` rounds.

    Returns (rep, resolved, taken): ``rep`` int32 (cap,) is the
    representative (owning) row of each valid row's group — ``cap`` for a
    row that exhausted its probe budget, the row itself for an invalid
    lane; ``resolved`` marks the rows whose group is known (invalid lanes
    count as resolved); ``taken`` is a 0-d int32 tensor, the rounds run.

    CPU tensors take the plain version. CUDA tensors launch the Hopper
    kernel once under ``hash_plan``'s plan (one call of the library,
    counted in ``hash_insert.launches``), which reads nothing on the
    host."""
    key_ops = list(key_ops)
    if not (valid.is_cuda or any(op.is_cuda for op in key_ops)):
        return hash_insert_reference(key_ops, valid, rounds)
    n = valid.shape[0]
    out, resolved, _ = _hash_call(key_ops, valid, rounds)
    return out[:n], resolved, out[n]


class HashRun(NamedTuple):
    """``hash_insert_run``'s result: ``hash_insert``'s three outputs, the
    grid barriers the call ran (a 0-d int32 tensor) and its plan; on the
    CPU (the plain version) both None."""
    rep: torch.Tensor
    resolved: torch.Tensor
    taken: torch.Tensor
    barriers: Optional[torch.Tensor]
    plan: Optional[HashPlan]


def hash_insert_run(key_ops: Sequence[torch.Tensor], valid: torch.Tensor,
                    rounds: int) -> HashRun:
    """``hash_insert``, with the barriers the call ran and its plan."""
    key_ops = list(key_ops)
    if not (valid.is_cuda or any(op.is_cuda for op in key_ops)):
        return HashRun(*hash_insert_reference(key_ops, valid, rounds),
                       None, None)
    n = valid.shape[0]
    out, resolved, plan = _hash_call(key_ops, valid, rounds)
    return HashRun(out[:n], resolved, out[n], out[n + 1], plan)


#: blocks of the kernel each card keeps resident, by (device, entry width)
_hash_resident: dict = {}


def hash_resident_grid(device: int, width: int) -> int:
    """Blocks of the kernel with ``width``-bit entries that card
    ``device`` keeps resident at once, asked of the library once per card
    and width (on the current device: the caller's)."""
    got = _hash_resident.get((device, width))
    if got is None:
        got = _hash_lib.hash_insert_resident_grid(width)  # qlint: ignore[cache-coherence] load-once handle (see hash_insert)
        if got <= 0:
            msg = _hash_lib.hash_insert_error_string(-got).decode(  # qlint: ignore[cache-coherence] load-once handle (see hash_insert)
                errors="replace")
            raise RuntimeError(f"hash_insert: no resident grid on device "
                               f"{device}: CUDA error {-got} ({msg})")
        _hash_resident[(device, width)] = got
    return got


@functools.lru_cache(maxsize=1024)
def _card_plan(n: int, rounds: int, device: int) -> HashPlan:
    """``hash_plan`` on card ``device``, made once per rows, budget and
    card."""
    return hash_plan(n, rounds, hash_resident_grid(
        device, hash_entry_width(n, rounds)))


def _hash_call(key_ops: list, valid: torch.Tensor, rounds: int):
    """The checks, the allocations and the library call of one CUDA call:
    returns the call's buffer (int32: rep, the rounds run, the barriers
    run, then the kernel's scratch), resolved and the plan."""
    _check_hash(key_ops, valid, rounds)
    if _recorded["hash_insert"] is not None:
        _record("hash_insert", ([op.clone() for op in key_ops],
                                valid.clone(), rounds))
    if _hash_lib is None:  # qlint: ignore[cache-coherence] load-once handle: set once, under the build lock, before the first launch; no cached value depends on it
        _hash_library()  # qlint: ignore[trace-purity] the kernel's load-once (see _launch)
    n = valid.shape[0]
    plan = _card_plan(n, rounds, valid.get_device())
    out = torch.empty(plan.nbytes // 4, dtype=torch.int32,
                      device=valid.device)
    resolved = torch.empty(n, dtype=torch.bool, device=valid.device)
    table = _operand_table(len(key_ops)).pack(*[v for op in key_ops for v in (
        op.data_ptr(), _OPERAND_CODE[op.dtype])])
    _run_hash(key_ops, valid, rounds, plan, out, resolved, table)
    return out, resolved, plan


@functools.lru_cache(maxsize=128)
def _operand_table(k: int) -> struct.Struct:
    return struct.Struct(f"<{2 * k}q")


def _run_hash_signature(key_ops, valid, rounds, *_):
    """The library call's program signature: the rows, the operands'
    dtypes and the probe budget (the plan follows from them on a card)."""
    return valid.shape[0], tuple(op.dtype for op in key_ops), rounds


def _run_hash(key_ops, valid, rounds: int, plan: HashPlan, out, resolved,
              table: bytes) -> None:
    """The library call: every probe round of one page into ``out`` (rep,
    the rounds and barriers run; then the kernel's scratch) and
    ``resolved``, on the current stream."""
    n = valid.shape[0]
    rc = _hash_lib.hash_insert(  # qlint: ignore[cache-coherence] load-once handle (see hash_insert)
        table, len(key_ops), valid.data_ptr(), n, rounds, plan.width,
        plan.blocks, out.data_ptr(), resolved.data_ptr(), plan.nbytes,
        table_size(n), _current_stream(valid.get_device()))
    if rc != 0:
        msg = _hash_lib.hash_insert_error_string(rc).decode(errors="replace")  # qlint: ignore[cache-coherence] load-once handle (see hash_insert)
        raise RuntimeError(f"hash_insert launch failed: CUDA error {rc} "
                           f"({msg})")
    with _count_lock:  # qlint: ignore[trace-purity] the launch counter a run reads to show its path went through the kernel: one update per launch, by design
        hash_insert.launches += 1


# the library call, profiled as the kernel's launch entry under a name of
# its own (the JAX engine runs the probe loop inside its
# ``hash_group_ids`` program, which the port's ``hash_group_ids`` entry
# stands for, so the program's calls and the kernel's launches count
# apart). Recorded on every launch, even inside that entry; its bytes are
# the inputs and the outputs (rep's buffer with the table and the spilled
# worklists; resolved).
_run_hash = instrument("hash_insert", _run_hash, kernel=True,
                       compile_ms=_charge_hash_load_ms,
                       signature=_run_hash_signature)

#: calls of the hash kernel's library since the last reset, one per
#: ``hash_insert`` call on the card (the CPU path never counts)
hash_insert.launches = 0


def _record(kernel: str, entry: tuple) -> None:
    """Keep one launch's inputs while ``record_calls`` is on for
    ``kernel``."""
    with _count_lock:  # qlint: ignore[trace-purity] the recording's one append under the counters' lock, only while record_calls is on
        kept = _recorded[kernel]
        if kept is not None:
            kept.append(entry)


def record_calls(on: bool, kernel: str = "segment_reduce") -> list:
    """Start (``on``) or stop keeping a copy of the inputs of every call
    that launches ``kernel``: ``(cols, gid, num_segments, kinds, order)``
    of a ``segment_reduce_columns`` call, ``(key_ops, valid, rounds)`` of
    a ``hash_insert`` call. Returns the calls kept since the start (empty
    when starting). How a run's launches in a worker process are held
    against the plain version after the run."""
    with _count_lock:
        kept = _recorded[kernel] or []
        _recorded[kernel] = [] if on else None
    return kept


def launch_counts(reset: bool = False) -> dict:
    """This process's launch counter of every kernel, read (and with
    ``reset`` set back to 0) under the counters' lock: a worker process
    of the multi-process runtime reports its own launches through this."""
    with _count_lock:
        out = {"segment_reduce": segment_reduce.launches,
               "hash_insert": hash_insert.launches}
        if reset:
            segment_reduce.launches = 0
            hash_insert.launches = 0
    return out
