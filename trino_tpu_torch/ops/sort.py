"""ORDER BY operator on torch.

Reference analog: ``operator/OrderByOperator.java`` (PagesIndex +
compiled PagesIndexOrdering).

Ordering keys normalize to (null-bit, int64) operand pairs
(ops/sortkeys.py); the whole batch sorts by one permutation built from
stable argsorts, from the last key operand to the first, and every
payload column is gathered through it.

The JAX engine's bounded-memory host sort (taken when the whole-input
device sort does not fit the query's memory pool) and ``TopNOperator``
are not ported yet: here a sort that does not fit raises the pool's
MemoryExceededError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..block import DevicePage, padded_size, unify_dictionaries
from .operator import Operator
from .sortkeys import SortKey, lexsort_indices, sort_operands


def sorted_by(key_ops: Sequence[torch.Tensor], cols, nulls, valid):
    """Sort carrying all columns; invalid lanes last; ties keep their
    input order (the JAX engine's ``_sorted_by`` is a stable sort too)."""
    perm = lexsort_indices([(~valid).to(torch.uint8)] + list(key_ops))
    return ([c[perm] for c in cols], [n[perm] for n in nulls], valid[perm])


def _make_key_ops(page: DevicePage, keys: Sequence[SortKey]):
    ops = []
    for k in keys:
        ops.extend(sort_operands(
            page.cols[k.channel], page.nulls[k.channel],
            page.types[k.channel], page.dictionaries[k.channel],
            ascending=k.ascending,
            nulls_last=k.nulls_last if k.nulls_last is not None
            else k.ascending))
    return ops


def _concat_pages(pages: List[DevicePage], cap: int) -> DevicePage:
    types = pages[0].types
    dicts = unify_dictionaries(pages, len(types))
    cols, nulls = [], []
    for i in range(len(types)):
        cols.append(_pad(torch.cat([p.cols[i] for p in pages]), cap))
        nulls.append(_pad(torch.cat([p.nulls[i] for p in pages]), cap,
                          fill=True))
    valid = _pad(torch.cat([p.valid for p in pages]), cap)
    return DevicePage(types, cols, nulls, valid, dicts)


def _pad(arr, cap, fill=False):
    n = arr.shape[0]
    if n == cap:
        return arr
    if arr.dtype == torch.bool:
        pad = torch.full((cap - n,), fill, dtype=torch.bool,
                         device=arr.device)
    else:
        pad = torch.zeros((cap - n,), dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


class OrderByOperator(Operator):
    """Full sort at finish (reference: OrderByOperator.java)."""

    def __init__(self, input_types: Sequence[T.Type],
                 sort_keys: Sequence[SortKey], memory_context=None):
        self.input_types = list(input_types)
        self.sort_keys = list(sort_keys)
        self._pages: List[DevicePage] = []
        self._emitted = False
        self._done = False
        self._ctx = memory_context

    def add_input(self, page: DevicePage):
        if self._ctx is not None:
            from ..exec.memory import device_page_bytes

            self._ctx.reserve(device_page_bytes(page))
        self._pages.append(page)

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            if self._emitted:
                self._done = True
            return None
        self._emitted = True
        if not self._pages:
            self._done = True
            return None
        out = self._sort_all()
        self._pages = []
        if self._ctx is not None:
            self._ctx.close()
        return out

    def _sort_all(self) -> DevicePage:
        if self._ctx is not None:
            from ..exec.memory import device_page_bytes

            # transient: concat + sorted copy; released when the sorted
            # page flows downstream
            total = sum(device_page_bytes(p) for p in self._pages)
            self._ctx.reserve(2 * total)
        cap = padded_size(sum(p.capacity for p in self._pages))
        page = _concat_pages(self._pages, cap)
        key_ops = _make_key_ops(page, self.sort_keys)
        cols, nulls, valid = sorted_by(key_ops, page.cols, page.nulls,
                                       page.valid)
        return DevicePage(page.types, cols, nulls, valid, page.dictionaries)

    def is_finished(self) -> bool:
        return self._done
