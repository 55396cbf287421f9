"""Sortable-key normalization: any SQL value -> order-preserving operands.

Every key column becomes a pair of operands — (null-placement bit,
order-preserving key) — and multi-key ordering is a chain of stable
sorts over the operands (``lexsort_indices``). No sentinel tricks, so no
collisions at type extremes.

The JAX engine carries the key as uint64. torch's uint64 support has gaps
(no ``>>``, ``<``, ``searchsorted`` or ``scatter_reduce``), so the key
here is that uint64 with bit 63 flipped, held as int64: the flip maps
unsigned order onto signed order, and the bits of the int64 equal the
JAX key's bits XOR 2^63.

Value encodings (the uint64 before the flip):
- signed ints / dates / timestamps / decimals: x XOR sign-bit bias, so
  the int64 operand is x itself
- doubles: the float64's order as an int64, -0.0 equal to +0.0 (NaN
  sorts largest)
- booleans: 0/1
- strings: dictionary sort-rank (host LUT over the pool, device gather)
- DESC: bitwise complement of the value operand (null bit independent)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..block import Dictionary

_SIGN64 = -(1 << 63)   # int64 with only bit 63 set


@dataclass(frozen=True)
class SortKey:
    channel: int
    ascending: bool = True
    nulls_last: bool = True  # SQL default: NULLS LAST for ASC


def _rank_lut(d: Optional[Dictionary], device) -> torch.Tensor:
    if d is None or len(d) == 0:
        return torch.zeros(1, dtype=torch.int64, device=device)
    return torch.from_numpy(d.sort_rank().astype("int64")).to(device)


def value_key(raw, type_: T.Type, dictionary: Optional[Dictionary] = None):
    """Order-preserving int64 encoding of raw lanes (nulls not handled):
    the JAX engine's uint64 key with bit 63 flipped. Not for DOUBLE/REAL
    (see sort_operands)."""
    if type_.is_pooled:
        # strings AND pooled composites (array/map/row): codes are pool
        # insertion order, so sort on the pool's value rank instead
        return _rank_lut(dictionary, raw.device)[raw.to(torch.int64)] \
            ^ _SIGN64
    if type_ == T.BOOLEAN:
        return raw.to(torch.int64) ^ _SIGN64
    if type_ in (T.DOUBLE, T.REAL):
        raise AssertionError("float keys use native float operands")
    return raw.to(torch.int64)   # (x ^ 2^63) as u64, flipped back


def sort_operands(raw, nulls, type_: T.Type,
                  dictionary: Optional[Dictionary] = None,
                  ascending: bool = True, nulls_last: bool = True) -> List:
    """[placement_bit_u8, key_i64] — ascending lex order over the pair
    equals the requested SQL order. DOUBLE/REAL keys order as float64
    (desc = negate; NaN sorts as +inf, i.e. largest, matching the
    engine's NaN convention), encoded by ``float_total_order``."""
    is_float = type_ in (T.DOUBLE, T.REAL)
    if is_float:
        key = raw.to(torch.float64)
        key = torch.where(torch.isnan(key), float("inf"), key)
        if not ascending:
            key = -key
    else:
        key = value_key(raw, type_, dictionary)
        if not ascending:
            key = ~key
    if nulls is None:
        null_bit = torch.zeros(raw.shape, dtype=torch.uint8,
                               device=raw.device)
    else:
        bit = nulls if nulls_last else ~nulls
        null_bit = bit.to(torch.uint8)
        # a NULL lane's JAX key is 0: 0.0, or uint64 0 = int64 -2^63
        zero = 0.0 if is_float else _SIGN64
        key = torch.where(nulls, torch.tensor(zero, dtype=key.dtype,
                                              device=key.device), key)
    if is_float:
        key = float_total_order(key)
    return [null_bit, key]


def float_total_order(f: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the order of float64 ``f`` with -0.0
    equal to +0.0 (as ``lax.sort`` compares them, so a stable sort keeps
    their input order): -0.0 becomes +0.0, then negative floats get their
    magnitude bits flipped. Integer keys also keep a CUDA radix sort from
    ordering -0.0 before +0.0."""
    bits = torch.where(f == 0.0, 0.0, f).view(torch.int64)
    return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)


def group_operands(raw, nulls, type_: T.Type) -> List:
    """[tag_u8, key] for equality grouping: NULL is one distinct group;
    +0.0/-0.0 group together; NaNs group together (tag bit 2 marks NaN so
    float compares need no NaN-equality). Strings group by raw code —
    callers canonicalize cross-dictionary codes first. Integer keys are
    the raw value as int64: the same 64 bits the JAX engine hashes."""
    if type_ in (T.DOUBLE, T.REAL):
        f = raw.to(torch.float64)
        f = torch.where(f == 0.0, 0.0, f)
        nan = torch.isnan(f)
        key = torch.where(nan, 0.0, f)
        tag = nan.to(torch.uint8) * 2
        if nulls is not None:
            tag = torch.where(nulls, torch.ones_like(tag), tag)
            key = torch.where(nulls, 0.0, key)
        return [tag, key]
    key = raw.to(torch.int64)
    if nulls is None:
        null_bit = torch.zeros(raw.shape, dtype=torch.uint8,
                               device=raw.device)
    else:
        null_bit = nulls.to(torch.uint8)
        key = torch.where(nulls, torch.zeros_like(key), key)
    return [null_bit, key]


def lexsort_indices(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by ``operands`` (first
    operand primary), ties kept in row order: stable argsorts from the
    last operand to the first (torch has no multi-operand sort)."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(list(operands)):
        key = op[perm]
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        order = torch.sort(key, stable=True).indices
        perm = perm[order]
    return perm
