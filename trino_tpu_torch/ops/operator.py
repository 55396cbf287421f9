"""Operator protocol + simple relational operators.

Reference analog: ``core/trino-main/.../operator/Operator.java:21-93``
(needsInput/addInput/getOutput/finish/isBlocked) and the simple operators
(ValuesOperator, TableScanOperator, ScanFilterAndProject).

Pages flowing between operators are ``DevicePage``s — padded torch
batches with validity masks on one device — so a pipeline's hot ops chain
on the device without host round-trips. Host boundaries are scans (numpy
-> device) and output (device -> numpy).

Limit, Offset, EnforceSingleRow, deferred sources and table writers are
not ported yet; the local planner rejects plans that need them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..block import DevicePage, Page
from ..connectors.spi import ColumnHandle, Connector, ConnectorSplit
from ..expr.compiler import PageProcessor


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
    of expensive operators)."""

    def __init__(self, connector: Connector, columns: Sequence[ColumnHandle],
                 device, coalesce_rows: Optional[int] = None):
        self.connector = connector
        self.columns = list(columns)
        self.device = device
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
        return DevicePage.from_page(page, device=self.device)

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

    def __init__(self, processor: PageProcessor):
        self.processor = processor
        self._pending: Optional[DevicePage] = None
        self._done = False

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, page: DevicePage):
        assert self._pending is None
        self._pending = self.processor.process(page)

    def get_output(self) -> Optional[DevicePage]:
        out, self._pending = self._pending, None
        if out is None and self._finishing:
            self._done = True
        return out

    def is_finished(self) -> bool:
        return self._done


class ValuesOperator(SourceOperator):
    """Inline literal rows (reference: operator/ValuesOperator.java),
    uploaded to ``device`` one page at a time."""

    def __init__(self, pages: Sequence[Page], device):
        self._pages = list(pages)
        self.device = device
        self._done = False

    def add_split(self, split):
        raise AssertionError("values has no splits")

    def get_output(self) -> Optional[DevicePage]:
        if not self._pages:
            self._done = True
            return None
        return DevicePage.from_page(self._pages.pop(0), device=self.device)

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
