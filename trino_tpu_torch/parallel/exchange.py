"""Device exchange primitives: partition ids and the per-destination
send grid of a hash repartition, on torch.

Reference analog: the pull-based HTTP shuffle path —
``operator/output/PartitionedOutputOperator.java`` + ``PagePartitioner``
(producer side) and ``operator/ExchangeOperator.java`` +
``DirectExchangeClient`` (consumer side), SURVEY.md §2.8.

The JAX engine's ``trino_tpu/parallel/exchange.py``, with its hash
arithmetic kept bit for bit. When producer and consumer stages share
the device, a stage boundary needs no serialization, no HTTP and no
buffers: rows are bucket-sorted by destination on the device and laid
into a fixed-capacity send grid, one lane block per destination.

Capacity model: the grid holds a fixed ``per_dest`` lanes per
destination. Rows beyond capacity are counted in the returned
``overflow`` (the host checks it and can re-run with a larger
``per_dest``); with hash partitioning overflow implies heavy skew.

uint64 on int64 lanes: torch has no uint64 shift, remainder or
comparison. Keys are int64 tensors holding the JAX engine's uint64
bits; wrapping ``+`` and ``*`` give the same bits, a logical right
shift is an arithmetic shift plus a mask (``ops/kernels._shr``), and
the partition id is the UNSIGNED remainder (an int64 ``%`` of a value
with bit 63 set routes the row elsewhere, silently).

Several devices: the JAX engine's mesh is one process driving d
devices, and so is this one: d device slabs, each a tensor on its own
device (devices may repeat: ``["cpu"] * d`` in the tests, ``["cuda:0"]
* 4`` on one card). The ``all_to_all`` is receiver j taking row block j
of every sender's send grid, in sender order, onto ``devices[j]`` — a
no-op move where the devices repeat, a peer copy where they differ. One
sender on one device: its send grid IS the receiver's slab.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..expr.functions import _float_to_int64
from ..ops.hashtable import umod
from ..ops.kernels import _i64, _shr


def string_hash_lut(d) -> np.ndarray:
    """code -> stable value hash (crc32): equal strings route equally
    regardless of which dictionary pool coded them. THE one definition —
    host and device exchange paths must agree or mixed-path joins break."""
    if d is None or len(d) == 0:
        return np.zeros(1, dtype=np.uint64)
    return np.asarray([zlib.crc32(("" if v is None else v).encode())
                       for v in d.values], dtype=np.uint64)


def lut_tensor(lut: np.ndarray, device) -> torch.Tensor:
    """A crc LUT (uint64 values below 2**32) as an int64 tensor."""
    return torch.from_numpy(lut.astype(np.int64)).to(device)


def key_to_u64(raw, nulls, type_: T.Type,
               lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Value-stable uint64 normalization of one key column for partition
    hashing, as int64 lanes holding the uint64 bits. ``lut`` is the
    string channel's crc LUT (``lut_tensor``). THE one definition shared
    by the host path (ops/output.PartitionedOutputOperator) and the
    device exchange (parallel/device_exchange)."""
    if type_.is_string:
        # an out-of-range code gathers the last entry, as JAX clamps
        k = lut[torch.clamp(raw.to(torch.int64), 0, lut.shape[0] - 1)]
    elif type_ in (T.DOUBLE, T.REAL):
        # deterministic quantization (equal floats -> equal id); NaN
        # and out-of-range values convert as XLA converts them
        k = _float_to_int64(raw.to(torch.float64) * 65536.0)
    else:
        k = raw.to(torch.int64)
    return torch.where(nulls, torch.zeros_like(k), k)


_P1 = _i64(0x9E3779B97F4A7C15)
_P2 = _i64(0xBF58476D1CE4E5B9)
_S1 = _i64(0x94D049BB133111EB)
_S2 = _i64(0xFF51AFD7ED558CCD)


def hash_partition_ids(keys_u64: Sequence[torch.Tensor],
                       num_partitions: int) -> torch.Tensor:
    """Combine pre-normalized uint64 key columns into partition ids.

    Mirrors the reference's InterpretedHashGenerator (CRC-style combined
    row hash -> partition), using splitmix64 finalization per column.
    """
    acc = torch.zeros(keys_u64[0].shape, dtype=torch.int64,
                      device=keys_u64[0].device)
    for k in keys_u64:
        z = (k + _P1) * _P2
        z = z ^ _shr(z, 27)
        acc = acc * 31 + z
    acc = acc ^ _shr(acc, 33)
    return umod(acc, num_partitions).to(torch.int32)


def subbucket_ids(keys_u64: Sequence[torch.Tensor],
                  num_sub: int) -> torch.Tensor:
    """Second, INDEPENDENT hash of pre-normalized key columns into
    ``num_sub`` sub-buckets — the hot-partition SPLIT salt for
    aggregation/join inputs: equal keys land in equal sub-buckets (so a
    group's rows stay co-located on one receiver), while the distinct
    keys of a hot partition spread across receivers. Uses the murmur3
    finalizer with different constants than ``hash_partition_ids`` so
    the sub-bucket is uncorrelated with the partition id."""
    acc = torch.zeros(keys_u64[0].shape, dtype=torch.int64,
                      device=keys_u64[0].device)
    for k in keys_u64:
        z = (k ^ _S1) * _S2
        z = z ^ _shr(z, 29)
        acc = acc * 37 + z
    acc = acc ^ _shr(acc, 32)
    return umod(acc, num_sub).to(torch.int32)


def partition_histogram(part_ids, valid,
                        num_partitions: int) -> torch.Tensor:
    """Per-destination live-row counts of ONE sender: the count-first
    pass each sender runs before an exchange to size its lanes from
    data instead of a capacity guess. Dead rows drop into a discarded
    overflow slot."""
    idx = torch.where(valid, part_ids.to(torch.int64), num_partitions)
    hist = torch.bincount(idx, minlength=num_partitions + 1)
    return hist[:num_partitions].to(torch.int32)


def send_grid(cols: Tuple, nulls: Tuple, valid, part_ids,
              num_partitions: int, per_dest: int):
    """One sender's half of ``repartition_a2a``: bucket-sort its rows by
    destination and lay them into the (num_partitions, per_dest) send
    grid, flattened. Returns (cols, nulls, valid, overflow_count)."""
    device = valid.device
    cap = valid.shape[0]
    # sort rows by (invalid, destination): live rows grouped by dest
    dest = torch.where(valid, part_ids.to(torch.int64), num_partitions)
    order = torch.sort(dest, stable=True).indices
    s_dest = dest[order]
    s_valid = valid[order]

    # position of each row within its destination bucket
    start = torch.searchsorted(
        s_dest, torch.arange(num_partitions, dtype=torch.int64,
                             device=device))
    home = torch.clamp(s_dest, 0, num_partitions - 1)
    pos = torch.arange(cap, dtype=torch.int64, device=device) - start[home]
    in_grid = s_valid & (pos < per_dest)
    overflow = (s_valid & ~in_grid).sum()

    # scatter into the (num_partitions * per_dest) send grid; dropped
    # lanes land in the extra overflow slot, which is cut off
    size = num_partitions * per_dest
    slot = torch.where(in_grid, home * per_dest + pos, size)

    def to_grid(sorted_col):
        grid = torch.zeros((size + 1,), dtype=sorted_col.dtype,
                           device=device)
        grid[slot] = sorted_col
        return grid[:-1]

    return (tuple(to_grid(c[order]) for c in cols),
            tuple(to_grid(n[order]) for n in nulls),
            to_grid(in_grid), overflow)


def repartition_a2a(cols: Sequence[Tuple], nulls: Sequence[Tuple],
                    valid: Sequence, part_ids: Sequence,
                    num_partitions: int, per_dest: int,
                    devices: Optional[Sequence] = None):
    """Route each live row of d senders to the slab of the device owning
    its partition, with capacity ``num_partitions * per_dest`` per
    receiver.

    ``cols``/``nulls`` are lists of per-sender tuples, ``valid`` and
    ``part_ids`` lists of per-sender tensors, sender i on ``devices[i]``
    (one sender on one device is the d = 1 case). Every sender lays out
    its grid (``send_grid``); then the collective — the JAX
    ``lax.all_to_all(tiled=True)`` — gives receiver j row block j
    (``num_partitions // d`` rows of ``per_dest`` lanes) of every
    sender's grid, concatenated in sender order, on ``devices[j]``.
    Returns per-receiver lists (cols tuples, nulls tuples, valid) and the
    per-sender overflow counts."""
    d = len(valid)
    devices = list(devices) if devices is not None \
        else [v.device for v in valid]
    assert len(devices) == d and num_partitions % d == 0, \
        (len(devices), d, num_partitions)
    grids = [send_grid(c, x, v, p, num_partitions, per_dest)
             for c, x, v, p in zip(cols, nulls, valid, part_ids)]
    block = (num_partitions // d) * per_dest

    def receive(pick):
        # receiver j <- lane block j of every sender, in sender order
        # (one sender: its grid is the slab, no copy)
        blocks = [[pick(g)[j * block:(j + 1) * block].to(devices[j])
                   for g in grids] for j in range(d)]
        return [b[0] if d == 1 else torch.cat(b) for b in blocks]

    r_cols = [receive(lambda g, i=i: g[0][i]) for i in range(len(cols[0]))]
    r_nulls = [receive(lambda g, i=i: g[1][i])
               for i in range(len(nulls[0]))]
    r_valid = receive(lambda g: g[2])
    return ([tuple(c[j] for c in r_cols) for j in range(d)],
            [tuple(x[j] for x in r_nulls) for j in range(d)],
            r_valid, [g[3] for g in grids])
