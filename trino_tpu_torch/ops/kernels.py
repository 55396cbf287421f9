"""Hand-written CUDA kernels of the torch engine, and their plain versions.

The counterpart of ``trino_tpu/ops/pallas_kernels.py``. Each kernel has:

- its CUDA source under ``trino_tpu_torch/csrc/``, compiled for Hopper
  (``sm_90a``) at first use into ``trino_tpu_torch/_build/`` as a shared
  library with a plain C interface, loaded with ``ctypes``;
- a plain PyTorch version of the same function (``*_reference``), which
  the wrapper runs for tensors on the CPU and nothing on the CUDA path
  calls;
- a wrapper that launches the kernel for CUDA tensors and counts its
  launches in a plain integer attribute (``segment_reduce.launches``).

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
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = "segment_reduce.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


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
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            lib.segment_reduce.argtypes = [
                vp, vp, ctypes.c_longlong, vp, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, vp, vp, vp]
            lib.segment_reduce.restype = ctypes.c_int
            lib.segment_reduce_tile_rows.argtypes = []
            lib.segment_reduce_tile_rows.restype = ctypes.c_int
            lib.segment_reduce_error_string.argtypes = [ctypes.c_int]
            lib.segment_reduce_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# segment reduce
#
# Replaces trino_tpu/ops/pallas_kernels.py `segment_reduce` (:226), which
# launches `_segment_reduce_pallas` (:172) / `_kernel` (:100). Bound on
# Hopper: memory — every row is read once (value + int32 gid) and every
# segment written once. At q1's aggregation page (262,144 int64 rows,
# 262,145 segments) that is ~3.1 MB read + ~2.1 MB written, ~1.6 us at
# 3.35 TB/s; launch cost dominates at that size. The design (fill, one
# block per 2,048-row tile with a block-wide segmented scan, one block over
# the tile-edge carries; no atomics) is described in
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


def segment_reduce(col: torch.Tensor, gid: torch.Tensor, num_segments: int,
                   kind: str) -> torch.Tensor:
    """SUM, MIN or MAX of ``col`` over segments of SORTED int32 group ids
    (non-decreasing; the engine's gids step by at most 1, then jump to
    the dump segment), identity in empty segments, int sums wrapping.

    CPU tensors take the plain version. CUDA tensors launch the Hopper
    kernel; unsorted gids on CUDA give undefined (but in-bounds) results."""
    if kind not in _KIND_CODE:
        raise ValueError(f"segment_reduce: unknown kind {kind!r}")
    if col.device.type == "cpu" and gid.device.type == "cpu":
        return segment_reduce_reference(col, gid, num_segments, kind)
    if col.device.type != "cuda" or gid.device != col.device:
        raise ValueError(
            f"segment_reduce: col on {col.device}, gid on {gid.device}; "
            "both must be on one CUDA device (or both on the CPU)")
    if col.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_reduce: unsupported dtype {col.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"segment_reduce: gid must be int32, not {gid.dtype}")
    if col.dim() != 1 or gid.shape != col.shape:
        raise ValueError(
            f"segment_reduce: col {tuple(col.shape)} and gid "
            f"{tuple(gid.shape)} must be 1-D and of one length")
    if not (col.is_contiguous() and gid.is_contiguous()):
        raise ValueError("segment_reduce: col and gid must be contiguous")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"segment_reduce: num_segments {num_segments} "
                         "out of range")
    lib = _library()
    n = col.shape[0]
    out = torch.empty((num_segments,), dtype=col.dtype, device=col.device)
    tiles = -(-n // lib.segment_reduce_tile_rows())
    carry_gid = torch.empty((2 * tiles,), dtype=torch.int32,
                            device=col.device)
    carry_val = torch.empty((2 * tiles,), dtype=col.dtype, device=col.device)
    stream = torch.cuda.current_stream(col.device).cuda_stream
    rc = lib.segment_reduce(col.data_ptr(), gid.data_ptr(), n,
                            out.data_ptr(), num_segments,
                            _DTYPE_CODE[col.dtype], _KIND_CODE[kind],
                            carry_gid.data_ptr(), carry_val.data_ptr(),
                            stream)
    if rc != 0:
        msg = lib.segment_reduce_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"segment_reduce launch failed: CUDA error "
                           f"{rc} ({msg})")
    segment_reduce.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (the CPU path never
#: counts): how a run shows that its main path went through the kernel
segment_reduce.launches = 0
