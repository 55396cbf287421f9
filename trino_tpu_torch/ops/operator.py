"""Operator protocol + simple relational operators.

Reference analog: ``core/trino-main/.../operator/Operator.java:21-93``
(needsInput/addInput/getOutput/finish/isBlocked) and the simple operators
(ValuesOperator, TableScanOperator, ScanFilterAndProject).

Pages flowing between operators are ``DevicePage``s — padded torch
batches with validity masks on one device — so a pipeline's hot ops chain
on the device without host round-trips. Host boundaries are scans (numpy
-> device) and output (device -> numpy), and table writers, which bring
each page to the host for the connector's page sink.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..block import DevicePage, Page
from ..connectors.spi import ColumnHandle, Connector, ConnectorSplit
from ..expr.compiler import PageProcessor
from ..telemetry.device_reads import host_scalar


class Operator:
    """One stage of a pipeline (reference: operator/Operator.java)."""

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, page: DevicePage):
        raise NotImplementedError

    def get_output(self) -> Optional[DevicePage]:
        return None

    def finish(self):
        self._finishing = True

    def is_finished(self) -> bool:
        raise NotImplementedError

    def blocked_token(self):
        """Non-None when the operator cannot progress until an external
        event fires; the token's ``on_ready(cb)`` re-schedules the
        parked task (reference: Operator.java isBlocked returning a
        ListenableFuture)."""
        return None

    _finishing = False


class SourceOperator(Operator):
    """Pipeline head driven by splits (reference: SourceOperator.java)."""

    def add_split(self, split: ConnectorSplit):
        raise NotImplementedError

    def no_more_splits(self):
        pass

    def add_input(self, page):
        raise AssertionError("source operators take splits, not pages")

    def needs_input(self) -> bool:
        return False


class TableScanOperator(SourceOperator):
    """Pulls pages from connector page sources and uploads them to
    ``device`` (reference: operator/TableScanOperator.java).

    Small pages (split tails: a table cut into many splits yields pages
    far below the connector's page size) COALESCE on host up to
    ``coalesce_rows`` before the upload, so downstream kernels see one
    full device batch instead of one launch per fragment (reference:
    ``operator/MergePages.java`` — the min-page-size rewindow in front
    of expensive operators).

    ``dynamic_filters`` are join build-side key domains, [(channel,
    DynamicFilter)], applied to every uploaded page as a lane-mask update
    (reference analog: dynamic-filter TupleDomains pushed into
    ConnectorPageSource)."""

    def __init__(self, connector: Connector, columns: Sequence[ColumnHandle],
                 device, dynamic_filters: Sequence = (),
                 coalesce_rows: Optional[int] = None, progress=None):
        self.connector = connector
        self.columns = list(columns)
        self.device = device
        #: telemetry.progress.QueryProgress fed host-page row counts as
        #: splits are read — a plain int add, never a device sync
        self.progress = progress
        self.dynamic_filters = list(dynamic_filters)
        self.coalesce_rows = coalesce_rows
        self._buffer: List[Page] = []
        self._buffered_rows = 0
        self._splits: List[ConnectorSplit] = []
        self._source = None
        self._no_more_splits = False
        self._done = False

    def add_split(self, split: ConnectorSplit):
        self._splits.append(split)

    def no_more_splits(self):
        self._no_more_splits = True

    def _upload(self, page: Page) -> DevicePage:
        dp = DevicePage.from_page(page, device=self.device)
        for ch, df in self.dynamic_filters:
            dp = DevicePage(dp.types, dp.cols, dp.nulls,
                            df.apply(dp.cols[ch], dp.nulls[ch], dp.valid),
                            dp.dictionaries)
        return dp

    def _flush(self) -> DevicePage:
        pages, self._buffer = self._buffer, []
        self._buffered_rows = 0
        return self._upload(pages[0] if len(pages) == 1
                            else Page.concat(pages))

    def get_output(self) -> Optional[DevicePage]:
        while True:
            if self._source is None:
                if self._splits:
                    split = self._splits.pop(0)
                    self._source = self.connector.page_source(
                        split, self.columns)
                elif self._no_more_splits or self._finishing:
                    if self._buffer:
                        return self._flush()
                    self._done = True
                    return None
                else:
                    return self._flush() if self._buffer else None
            page = self._source.get_next_page()
            if page is None:
                if self._source.is_finished():
                    self._source.close()
                    self._source = None
                    continue
                # source stalled: don't sit on buffered rows
                return self._flush() if self._buffer else None
            if page.num_rows == 0:
                continue
            if self.progress is not None:
                self.progress.add_rows(page.num_rows)
            target = self.coalesce_rows
            if target and page.num_rows < target:
                self._buffer.append(page)
                self._buffered_rows += page.num_rows
                if self._buffered_rows >= target:
                    return self._flush()
                continue
            if self._buffer:
                self._buffer.append(page)
                self._buffered_rows += page.num_rows
                return self._flush()
            return self._upload(page)

    def is_finished(self) -> bool:
        return self._done


class FilterProjectOperator(Operator):
    """Fused filter+project via a PageProcessor (reference:
    ScanFilterAndProjectOperator / FilterAndProjectOperator +
    operator/project/PageProcessor.java)."""

    def __init__(self, processor: PageProcessor, params: tuple = ()):
        self.processor = processor
        #: template-parameter bindings: raw scalars for the processor's
        #: consumed slots — a template plan executed for one statement
        #: binds its literal vector here
        self.params = tuple(params)
        self._pending: Optional[DevicePage] = None
        self._done = False

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, page: DevicePage):
        assert self._pending is None
        self._pending = self.processor.process(page, self.params)

    def get_output(self) -> Optional[DevicePage]:
        out, self._pending = self._pending, None
        if out is None and self._finishing:
            self._done = True
        return out

    def is_finished(self) -> bool:
        return self._done


def _running_valid(valid, seen, lo: int, hi: int):
    """Keep live lanes whose running ordinal (``seen`` so far + position
    within this page) lands in (lo, hi]; returns the new mask and the
    updated device-resident total."""
    run = torch.cumsum(valid.to(torch.int64), 0) + seen
    return valid & (run > lo) & (run <= hi), run[-1]


class LimitOperator(Operator):
    """LIMIT n (reference: operator/LimitOperator.java).

    Device-resident: the running row count stays a device scalar and the
    mask trim is plain tensor ops — no per-page host pull of the valid
    mask. ``needs_input`` reads the count (one scalar sync per page, as
    the reference's), so the driver stops pulling input once the limit
    fills."""

    def __init__(self, limit: int):
        self.limit = limit
        self._seen = None          # device scalar: rows passed so far
        self._known_seen = 0       # its host view
        self._pending: Optional[DevicePage] = None
        self._done = False

    def needs_input(self) -> bool:
        if self._seen is not None:
            self._known_seen = int(host_scalar(self._seen, "limit.seen"))
        return (self._pending is None and self._known_seen < self.limit
                and not self._finishing)

    def add_input(self, page: DevicePage):
        if self._known_seen >= self.limit:
            return
        seen = 0 if self._seen is None else self._seen
        new_valid, self._seen = _running_valid(page.valid, seen, 0,
                                               self.limit)
        self._pending = DevicePage(page.types, page.cols, page.nulls,
                                   new_valid, page.dictionaries)

    def get_output(self) -> Optional[DevicePage]:
        out, self._pending = self._pending, None
        if out is None and (self._finishing
                            or self._known_seen >= self.limit):
            self._done = True
        return out

    def is_finished(self) -> bool:
        return self._done


class OffsetOperator(Operator):
    """OFFSET n: drops the first n live rows (reference:
    operator/OffsetOperator.java). Fully device-resident — no control
    flow depends on the running count, so it never syncs to host."""

    def __init__(self, offset: int):
        self.offset = offset
        self._seen = None
        self._pending: Optional[DevicePage] = None
        self._done = False

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, page: DevicePage):
        seen = 0 if self._seen is None else self._seen
        new_valid, self._seen = _running_valid(
            page.valid, seen, self.offset, torch.iinfo(torch.int64).max)
        self._pending = DevicePage(page.types, page.cols, page.nulls,
                                   new_valid, page.dictionaries)

    def get_output(self) -> Optional[DevicePage]:
        out, self._pending = self._pending, None
        if out is None and self._finishing:
            self._done = True
        return out

    def is_finished(self) -> bool:
        return self._done


class ValuesOperator(SourceOperator):
    """Inline literal rows (reference: operator/ValuesOperator.java),
    uploaded to ``device`` one page at a time. ``coalesce_rows`` applies
    the scan's small-page coalescing to pre-materialized host pages (the
    benchmark builders' values-fed pipelines)."""

    def __init__(self, pages: Sequence[Page], device,
                 coalesce_rows: Optional[int] = None):
        self._pages = list(pages)
        self.device = device
        self.coalesce_rows = coalesce_rows
        self._done = False

    def add_split(self, split):
        raise AssertionError("values has no splits")

    def get_output(self) -> Optional[DevicePage]:
        if not self._pages:
            self._done = True
            return None
        if not self.coalesce_rows:
            return DevicePage.from_page(self._pages.pop(0),
                                        device=self.device)
        batch, rows = [], 0
        while self._pages and rows < self.coalesce_rows:
            batch.append(self._pages.pop(0))
            rows += batch[-1].num_rows
        return DevicePage.from_page(batch[0] if len(batch) == 1
                                    else Page.concat(batch),
                                    device=self.device)

    def is_finished(self) -> bool:
        return self._done


class EnforceSingleRowOperator(Operator):
    """Scalar-subquery guard: exactly one output row — errors on more,
    emits an all-NULL row on zero (reference:
    operator/EnforceSingleRowOperator.java)."""

    def __init__(self, types, device):
        self.types = list(types)
        self.device = device
        self._rows = 0
        self._pages: List[DevicePage] = []
        self._emitted = False
        self._done = False

    def add_input(self, page: DevicePage):
        n = page.count()
        if not n:
            return
        self._rows += n
        if self._rows > 1:  # fail fast, don't buffer the stream
            from ..types import TrinoError

            raise TrinoError("Scalar sub-query has returned multiple rows",
                             "SUBQUERY_MULTIPLE_ROWS")
        self._pages.append(page)

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        self._done = True
        if self._rows == 1:
            return self._pages[0]
        if not self.types:
            return None
        # one all-NULL row
        row = Page.from_pylists(self.types, [[None]] * len(self.types))
        return DevicePage.from_page(row, device=self.device)

    def is_finished(self) -> bool:
        return self._done


class DeferredPagesSourceOperator(SourceOperator):
    """Source over host pages produced by earlier pipelines of the same
    plan (union inputs), uploaded to ``device``. The thunk is called at
    first poll — after the upstream pipelines completed."""

    def __init__(self, pages_thunk, device):
        self._thunk = pages_thunk
        self.device = device
        self._pages = None
        self._done = False

    def add_split(self, split):
        raise AssertionError("deferred source has no splits")

    def get_output(self) -> Optional[DevicePage]:
        if self._pages is None:
            self._pages = [p for p in self._thunk() if p.num_rows]
        if self._pages:
            return DevicePage.from_page(self._pages.pop(0),
                                        device=self.device)
        self._done = True
        return None

    def is_finished(self) -> bool:
        return self._done


class TableWriterOperator(Operator):
    """Feeds pages to a ConnectorPageSink; at finish emits one BIGINT row
    with the written count, on ``device`` (reference:
    operator/TableWriterOperator.java + TableFinishOperator.java — commit
    folded into sink.finish())."""

    def __init__(self, sink, device):
        self.sink = sink
        self.device = device
        self.rows = 0
        self._emitted = False
        self._done = False

    def add_input(self, page: DevicePage):
        host = page.to_page()
        if host.num_rows:
            self.rows += host.num_rows
            self.sink.append_page(host)

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        self._done = True
        self.sink.finish()
        from .. import types as T

        return DevicePage.from_page(
            Page.from_pylists([T.BIGINT], [[self.rows]]), self.device)

    def is_finished(self) -> bool:
        return self._done


class OutputCollectorOperator(Operator):
    """Pipeline sink: densifies device pages back to host Pages
    (reference analog: TaskOutputOperator feeding the OutputBuffer)."""

    def __init__(self):
        self.pages: List[Page] = []
        self._done = False

    def add_input(self, page: DevicePage):
        host = page.to_page()
        if host.num_rows:
            self.pages.append(host)

    def get_output(self):
        return None

    def finish(self):
        super().finish()
        self._done = True

    def is_finished(self) -> bool:
        return self._done
