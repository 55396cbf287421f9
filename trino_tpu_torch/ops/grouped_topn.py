"""Grouped top-N on torch: per-group truncation under a ranking function.

Reference analog: ``operator/GroupedTopNBuilder.java`` /
``TopNRankingOperator.java`` — per-group heaps keeping the top
``max_rank`` rows while input streams through, so a ranking query never
materializes whole window partitions.

The JAX engine's design (``trino_tpu/ops/grouped_topn.py``), as plain
torch ops: buffered rows sort once by (partition operands, order
operands), group ranks fall out of run-boundary prefix ops (the window
kernel's trick), and a stable partition moves the survivors to the front
in sorted order. The operator flushes whenever the buffer crosses a
threshold, so resident rows stay O(groups * max_rank + flush window).

The JAX engine sorts with ``is_stable=False``; this sort is stable. Under
``row_number`` with ties in the ORDER BY, the rows that survive may
therefore differ between the engines (both are valid answers); ``rank``
keeps every tie and agrees.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..block import DevicePage, padded_size
from .operator import Operator
from .sort import _concat_pages
from .sortkeys import SortKey, lexsort_indices
from .window import _cummax, _new_run, order_operands, partition_operands


def _topn_kernel(part_ops, order_ops, cols, nulls, valid, ranking: str,
                 max_rank: int):
    """Rows sorted by (partition, order), survivors (rank <= max_rank)
    first; returns (cols, nulls, keep, rank, survivors)."""
    n = valid.shape[0]
    dev = valid.device
    perm = lexsort_indices([(~valid).to(torch.uint8)] + list(part_ops)
                           + list(order_ops))
    s_part = [o[perm] for o in part_ops]
    s_valid = valid[perm]
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    # validity participates: the valid->padding transition starts a
    # (dead) partition, so ranks never straddle padding lanes
    pstart = _new_run(s_part + [s_valid], n, dev)
    pstart_idx = _cummax(torch.where(pstart, idx, 0))
    if ranking == "rank" and order_ops:
        rstart = pstart | _new_run([o[perm] for o in order_ops], n, dev)
        rk = _cummax(torch.where(rstart, idx, 0)) - pstart_idx + 1
    else:
        rk = idx - pstart_idx + 1
    keep = s_valid & (rk <= max_rank)

    # compact survivors to the front, preserving the sorted order
    order2 = torch.sort((~keep).to(torch.uint8), stable=True).indices
    front = perm[order2]
    return ([c[front] for c in cols], [x[front] for x in nulls],
            keep[order2], rk[order2], int(keep.sum()))


class GroupedTopNOperator(Operator):
    """Keeps at most ``max_rank`` rows per partition-key group under
    the ordering; appends the rank column unless ``step='partial'``."""

    FLUSH_ROWS = 1 << 16

    def __init__(self, input_types: Sequence[T.Type],
                 partition_channels: Sequence[int],
                 sort_keys: Sequence[SortKey], ranking: str,
                 max_rank: int, step: str = "single"):
        assert ranking in ("row_number", "rank")
        assert step in ("single", "partial", "final")
        self.input_types = list(input_types)
        self.partition_channels = list(partition_channels)
        self.sort_keys = list(sort_keys)
        self.ranking = ranking
        self.max_rank = max_rank
        self.step = step
        self._pages: List[DevicePage] = []
        self._buffered_rows = 0
        self._rank_cache: dict = {}
        self._done = False

    @property
    def output_types(self) -> List[T.Type]:
        if self.step == "partial":
            return list(self.input_types)
        return self.input_types + [T.BIGINT]

    def add_input(self, page: DevicePage):
        self._pages.append(page)
        self._buffered_rows += page.capacity
        if self._buffered_rows >= self.FLUSH_ROWS:
            self._truncate_buffer()

    def _run_kernel(self, page: DevicePage):
        return _topn_kernel(
            partition_operands(page, self.partition_channels,
                               self._rank_cache),
            order_operands(page, self.sort_keys), page.cols, page.nulls,
            page.valid, self.ranking, self.max_rank)

    def _concat_buffer(self) -> DevicePage:
        pages, self._pages = self._pages, []
        return _concat_pages(pages, padded_size(sum(p.capacity
                                                    for p in pages)))

    def _truncate_buffer(self):
        """Mid-stream flush: replace the buffer with its per-group
        top-N (survivors compact into a right-sized page)."""
        page = self._concat_buffer()
        cols, nulls, valid, _rank, count = self._run_kernel(page)
        k = padded_size(max(count, 16))
        self._pages = [DevicePage(
            list(page.types), [c[:k] for c in cols],
            [x[:k] for x in nulls], valid[:k], list(page.dictionaries))]
        self._buffered_rows = k

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._done:
            return None
        self._done = True
        if not self._pages:
            return None
        page = self._concat_buffer()
        cols, nulls, valid, rank, count = self._run_kernel(page)
        k = padded_size(max(count, 16))
        out_cols = [c[:k] for c in cols]
        out_nulls = [x[:k] for x in nulls]
        out_dicts = list(page.dictionaries)
        types_ = list(page.types)
        if self.step != "partial":
            out_cols.append(rank[:k])
            out_nulls.append(torch.zeros(k, dtype=torch.bool,
                                         device=page.device))
            out_dicts.append(None)
            types_.append(T.BIGINT)
        return DevicePage(types_, out_cols, out_nulls, valid[:k], out_dicts)

    def is_finished(self) -> bool:
        return self._done
