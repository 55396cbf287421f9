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
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Sequence

import torch

from ..telemetry.profiler import instrument

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = "segment_reduce.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
#: rows per tile of the kernel, read from the library once it is loaded
_tile_rows = 0
#: wall ms of the library's build (when this process built it) and load;
#: charged once per process to the kernel's first profiler entry
_load_ms = 0.0
_load_ms_charged = False
_build_lock = threading.Lock()
#: guards the launch counters: a server runs statements on several
#: threads, and ``launches += 1`` is not atomic under threads
_count_lock = threading.Lock()
#: while a list: a copy of the inputs of every call that launches the
#: kernel, in launch order (``record_calls``)
_recorded: Optional[list] = None


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


def build() -> str:
    """Compile ``csrc/segment_reduce.cu`` unless its library exists;
    returns the library's path. Raises with the compiler's output if the
    build fails."""
    path = _library_path(SOURCE)
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    done = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if done.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exited "
                           f"{done.returncode}\n"
                           f"{done.stdout.decode(errors='replace')}")
    os.replace(tmp, path)  # atomic: readers never see half a file
    return path


def _library() -> ctypes.CDLL:
    global _lib, _tile_rows, _load_ms
    with _build_lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            lib.segment_reduce_columns.argtypes = [
                ctypes.POINTER(vp), ctypes.POINTER(vp),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, vp, vp, ctypes.c_longlong, ctypes.c_longlong,
                vp, vp, vp]
            lib.segment_reduce_columns.restype = ctypes.c_int
            lib.segment_reduce_tile_rows.argtypes = []
            lib.segment_reduce_tile_rows.restype = ctypes.c_int
            lib.segment_reduce_error_string.argtypes = [ctypes.c_int]
            lib.segment_reduce_error_string.restype = ctypes.c_char_p
            _tile_rows = lib.segment_reduce_tile_rows()
            _load_ms = (time.perf_counter() - t0) * 1e3
            _lib = lib
        return _lib


def _charge_load_ms() -> float:
    """The library's build + load wall, the first time it is asked for
    after the library loaded (once per process), else 0."""
    global _load_ms_charged
    with _build_lock:
        if _load_ms_charged or _lib is None:
            return 0.0
        _load_ms_charged = True
        return _load_ms


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
# that is 66.06 MB, 0.0197 ms at 3.35 TB/s. The design (fill, one block
# per 2,048-row tile and column with a block-wide segmented scan, one
# block per column over the tile-edge carries; no atomics; three launches
# per (dtype, kind) among the columns) is described in
# csrc/segment_reduce.cu.

SEGMENT_KINDS = ("sum", "min", "max")
_KIND_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}


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


def _dtype_codes(cols, gid, order, num_segments) -> List[int]:
    """The columns' dtype codes; raises on what the kernel does not take.
    Cheap tensor attributes only: this runs on every call."""
    d = gid.get_device()
    if not gid.is_cuda or any(c.get_device() != d for c in cols) or \
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
    codes = []
    for col in cols:
        code = _DTYPE_CODE.get(col.dtype)
        if code is None:
            raise TypeError(f"segment_reduce: unsupported dtype {col.dtype}")
        if col.shape != shape:
            raise ValueError(
                f"segment_reduce: col {tuple(col.shape)} and gid "
                f"{tuple(shape)} must be 1-D and of one length")
        if not col.is_contiguous():
            raise ValueError("segment_reduce: col must be contiguous")
        codes.append(code)
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
    return codes


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
    dtype_codes = _dtype_codes(cols, gid, order, num_segments)
    if not cols:
        return []
    if _recorded is not None:
        entry = ([c.clone() for c in cols], gid.clone(), num_segments,
                 list(kinds), None if order is None else order.clone())
        with _count_lock:
            if _recorded is not None:
                _recorded.append(entry)
    return _launch(cols, gid, num_segments, tuple(kinds), order,
                   dtype_codes)


def _launch(cols, gid, num_segments: int, kinds: tuple, order,
            dtype_codes) -> List[torch.Tensor]:
    """One launch of the kernel's library over checked CUDA tensors: the
    outputs and the tile-edge carries are allocated here, then ``_run``
    makes the library call."""
    _library()
    dev = gid.device
    n = gid.shape[0]
    k = len(cols)
    # one output block per dtype, its columns as rows
    outs: List[Optional[torch.Tensor]] = [None] * k
    for dtype in {c.dtype for c in cols}:
        idx = [i for i, c in enumerate(cols) if c.dtype == dtype]
        block = torch.empty((len(idx), num_segments), dtype=dtype,
                            device=dev)
        for i, row in zip(idx, block.unbind(0)):
            outs[i] = row
    carries = 2 * -(-n // _tile_rows)
    carry_gid = torch.empty((carries,), dtype=torch.int32, device=dev)
    # 8 bytes per carry value, whatever the column's dtype
    carry_val = torch.empty((k * carries,), dtype=torch.int64, device=dev)
    _run(cols, gid, order, outs, carry_gid, carry_val, num_segments, kinds,
         tuple(dtype_codes))
    return outs


def _run_ops(cols, gid, *_):
    """One operation per state column per row: the count
    ``chip_smoke.py`` bounds the kernel with."""
    return len(cols) * gid.shape[0]


def _run(cols, gid, order, outs, carry_gid, carry_val, num_segments: int,
         kinds: tuple, dtype_codes: tuple) -> None:
    """The library call: fill, tiles and carries of every column into
    ``outs``, on the current stream."""
    lib = _library()
    n = gid.shape[0]
    k = len(cols)
    kind_codes = [_KIND_CODE[kind] for kind in kinds]
    rc = lib.segment_reduce_columns(
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * k)(*dtype_codes), (ctypes.c_int * k)(*kind_codes),
        k, gid.data_ptr(), None if order is None else order.data_ptr(), n,
        num_segments, carry_gid.data_ptr(), carry_val.data_ptr(),
        torch.cuda.current_stream(gid.device).cuda_stream)
    if rc != 0:
        msg = lib.segment_reduce_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"segment_reduce launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _count_lock:
        segment_reduce.launches += 1


# the library call, profiled as the JAX engine's Pallas program
# (trino_tpu/ops/pallas_kernels.py ``segment_reduce_pallas``): recorded on
# every launch, even inside another profiled program. The outputs are
# allocated before it, so its event span holds the launch alone: when
# the stream is idle as the call begins (as on q1's pages), a span
# around the allocation would time the host's allocation instead. Its
# bytes are the inputs, the outputs and the carries, each once.
_run = instrument("segment_reduce_pallas", _run,
                  static_argnames=("num_segments", "kinds"),
                  flops=_run_ops, kernel=True, compile_ms=_charge_load_ms)


def segment_tile_rows(device) -> int:
    """Rows per tile of the kernel on ``device`` (1 on the CPU, whose
    plain version has no tiles). A caller that lays several independent
    problems end to end in one call starts each at a multiple of this,
    so every problem sees the kernel's tile edges where it would see
    them alone, and a float sum associates in the same order."""
    if torch.device(device).type != "cuda":
        return 1
    _library()
    return _tile_rows


def segment_reduce(col: torch.Tensor, gid: torch.Tensor, num_segments: int,
                   kind: str) -> torch.Tensor:
    """``segment_reduce_columns`` of the one column ``col``."""
    return segment_reduce_columns([col], gid, num_segments, [kind])[0]


#: calls of the CUDA kernel's library since the last reset, one per
#: ``segment_reduce_columns`` call on the card (the CPU path never counts):
#: how a run shows that its main path went through the kernel
segment_reduce.launches = 0


def record_calls(on: bool) -> list:
    """Start (``on``) or stop keeping a copy of the inputs ``(cols, gid,
    num_segments, kinds, order)`` of every ``segment_reduce_columns`` call
    that launches the kernel; returns the calls kept since the start
    (empty when starting). How a run's launches in a worker process are
    held against the plain version after the run."""
    global _recorded
    with _count_lock:
        kept, _recorded = _recorded or [], ([] if on else None)
    return kept


def launch_counts(reset: bool = False) -> dict:
    """This process's launch counter of every kernel, read (and with
    ``reset`` set back to 0) under the counters' lock: a worker process
    of the multi-process runtime reports its own launches through this."""
    with _count_lock:
        out = {"segment_reduce": segment_reduce.launches}
        if reset:
            segment_reduce.launches = 0
    return out
