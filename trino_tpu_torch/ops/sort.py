"""ORDER BY and TopN operators on torch.

Reference analog: ``operator/OrderByOperator.java`` (PagesIndex +
compiled PagesIndexOrdering) and ``operator/TopNOperator.java``.

Ordering keys normalize to (null-bit, int64) operand pairs
(ops/sortkeys.py); the whole batch sorts by one permutation built from
stable argsorts, from the last key operand to the first, and every
payload column is gathered through it.

Under a memory pool, ORDER BY's input is revocable (spilled to the host
and disk tiers under pressure). When the whole-input device sort does not
fit beside the pool's other reservations, the operator takes the JAX
engine's bounded host sort instead: key operands per page on the device,
live rows downloaded, one stable ``np.lexsort`` on the host, and the
ordered rows uploaded lazily, one budget-sized chunk per driver quantum.
That path needs no spill, so it also serves a capped query with
``spill_enabled`` off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, padded_size, unify_dictionaries
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import to_host
from .operator import Operator
from .sortkeys import SortKey, lexsort_indices, sort_operands


def sorted_by(key_ops: Sequence[torch.Tensor], cols, nulls, valid):
    """Sort carrying all columns; invalid lanes last; ties keep their
    input order (the JAX engine's ``_sorted_by`` is a stable sort too)."""
    perm = lexsort_indices([(~valid).to(torch.uint8)] + list(key_ops))
    return ([c[perm] for c in cols], [n[perm] for n in nulls], valid[perm])


# profiled program (telemetry.profiler): a plain call when profiling is off
sorted_by = instrument("sort_by", sorted_by)


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
        self._pages: List = []  # DevicePage | SpilledPage
        #: sorted output: DevicePages, or thunks that upload one
        #: host-sorted chunk each
        self._out: List = []
        self._device = None
        self._emitted = False
        self._done = False
        self._ctx = memory_context
        if self._ctx is not None:
            self._ctx.set_revoke_callback(self._revoke)

    def add_input(self, page: DevicePage):
        self._device = page.device
        if self._ctx is None:
            self._pages.append(page)
            return
        from ..exec.memory import reserve_and_append

        reserve_and_append(self._ctx, self._pages, page)

    def _revoke(self) -> int:
        from ..exec.memory import spill_pages

        return spill_pages(self._pages, self._ctx.pool, self._ctx.lock)

    def _pop_out(self) -> DevicePage:
        item = self._out.pop(0)
        # host-sorted chunks upload lazily, one per quantum, so the
        # full sorted relation is never device-resident at once
        return item() if callable(item) else item

    def get_output(self) -> Optional[DevicePage]:
        if self._out:
            return self._pop_out()
        if not self._finishing or self._emitted:
            if self._emitted:
                self._done = True
            return None
        self._emitted = True
        if not self._pages:
            self._done = True
            return None
        self._out = self._sort_all()
        self._pages = []
        if self._ctx is not None:
            self._ctx.close()
        if self._out:
            return self._pop_out()
        self._done = True
        return None

    def _sort_all(self) -> List:
        from ..exec.memory import SpilledPage

        if self._ctx is not None:
            from ..exec.memory import prepare_finish

            pool = self._ctx.pool
            total, uploads = prepare_finish(self._ctx, self._pages)
            if pool.reserved + uploads + 2 * total > pool.max_bytes:
                # the whole-input device sort cannot fit beside the
                # pool's other reservations: the bounded host sort
                return self._host_sort(pool.max_bytes // 4)
            # transient: uploads + concat + sorted copy; released when
            # the sorted page flows downstream
            self._ctx.reserve(uploads + 2 * total, revocable=False)
        pages = [p.to_device() if isinstance(p, SpilledPage) else p
                 for p in self._pages]
        cap = padded_size(sum(p.capacity for p in pages))
        page = _concat_pages(pages, cap)
        key_ops = _make_key_ops(page, self.sort_keys)
        cols, nulls, valid = sorted_by(key_ops, page.cols, page.nulls,
                                       page.valid)
        return [DevicePage(page.types, cols, nulls, valid,
                           page.dictionaries)]

    def _host_sort(self, chunk_budget: int) -> List:
        """Bounded device-memory sort: per page, compute the key operands
        on the device, download the live rows, then lexsort on the host
        and re-emit the ordered rows as budget-sized DevicePages. Device
        residency is one page (and its key operands) + one output chunk;
        the whole relation lives in host RAM (reference analog:
        OrderByOperator's spill-merge via FileSingleStreamSpiller, with
        host RAM standing in for disk). The key operands are the int64
        flipped keys of ``sortkeys.py``: their signed order is the JAX
        engine's unsigned one, and ``np.lexsort`` is stable, so ties keep
        their input order as the device sort does."""
        from ..exec.memory import SpilledPage, device_page_bytes, np_pad

        host_cols: List[List[np.ndarray]] = []
        host_nulls: List[List[np.ndarray]] = []
        host_ops: List[List[np.ndarray]] = []
        dicts = unify_dictionaries(self._pages, len(self.input_types))
        for p in self._pages:
            nb = device_page_bytes(p)
            if self._ctx is not None:
                # one page resident at a time (plus its key operands)
                self._ctx.reserve(2 * nb, revocable=False)
            dev = p.to_device() if isinstance(p, SpilledPage) else p
            ops = _make_key_ops(dev, self.sort_keys)
            keep = torch.nonzero(dev.valid).squeeze(1)
            host_cols.append([to_host(c[keep], "sort.spill")
                              for c in dev.cols])
            host_nulls.append([to_host(n[keep], "sort.spill")
                               for n in dev.nulls])
            host_ops.append([to_host(o[keep], "sort.spill") for o in ops])
            if self._ctx is not None:
                self._ctx.free(2 * nb)
        nch = len(self.input_types)
        cols = [np.concatenate([pc[i] for pc in host_cols])
                for i in range(nch)]
        nulls = [np.concatenate([pn[i] for pn in host_nulls])
                 for i in range(nch)]
        ops = [np.concatenate([po[j] for po in host_ops])
               for j in range(len(host_ops[0]))]
        # np.lexsort: the last key is primary -> reverse the operands
        order = np.lexsort(tuple(reversed(ops)))
        n = order.shape[0]
        # output chunk rows sized so a chunk stays within the budget
        row_bytes = max(1, sum(c.dtype.itemsize + 1 for c in cols) + 1)
        chunk_rows = max(1024, chunk_budget // (2 * row_bytes))
        types_ = list(self.input_types)
        device = self._device

        def make_chunk(idx):
            # deferred: uploads when the driver pulls this chunk, so one
            # chunk is device-resident at a time
            def thunk():
                cap = padded_size(idx.shape[0])

                def up(a):
                    return torch.from_numpy(np_pad(a, cap)).to(device)

                return DevicePage(types_, [up(c[idx]) for c in cols],
                                  [up(nl[idx]) for nl in nulls],
                                  up(np.ones(idx.shape[0], dtype=bool)),
                                  list(dicts))

            return thunk

        return [make_chunk(order[s:s + chunk_rows])
                for s in range(0, n, chunk_rows)]

    def is_finished(self) -> bool:
        return self._done


class TopNOperator(Operator):
    """ORDER BY ... LIMIT n with bounded memory (reference:
    TopNOperator.java / GroupedTopNBuilder): each page merges into the
    running top n, which keeps ``padded_size(n)`` lanes."""

    def __init__(self, input_types: Sequence[T.Type],
                 sort_keys: Sequence[SortKey], n: int):
        self.input_types = list(input_types)
        self.sort_keys = list(sort_keys)
        self.n = n
        self._top: Optional[DevicePage] = None
        self._emitted = False
        self._done = False

    def add_input(self, page: DevicePage):
        pages = [self._top, page] if self._top is not None else [page]
        cap = padded_size(sum(p.capacity for p in pages))
        merged = _concat_pages(pages, cap)
        key_ops = _make_key_ops(merged, self.sort_keys)
        cols, nulls, valid = sorted_by(key_ops, merged.cols, merged.nulls,
                                       merged.valid)
        keep = padded_size(max(self.n, 16))
        if keep < cap:
            cols = [c[:keep] for c in cols]
            nulls = [x[:keep] for x in nulls]
            valid = valid[:keep]
        valid = valid & (torch.arange(valid.shape[0],
                                      device=valid.device) < self.n)
        self._top = DevicePage(merged.types, cols, nulls, valid,
                               merged.dictionaries)

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        self._done = True
        return self._top

    def is_finished(self) -> bool:
        return self._done
