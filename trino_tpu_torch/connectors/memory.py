"""In-memory table connector.

Reference analog: ``plugin/trino-memory`` (``MemoryConnector.java``,
``MemoryMetadata``, ``MemoryPagesStore``) — the engine's writable test
fixture and cache connector. Tables live as host Page lists per
(schema, table); writes append under a lock so scaled/parallel writers
can share one sink target.

The JAX engine's memory connector (``trino_tpu/connectors/memory.py``),
copied: the pages are host ``Page``s, which scans upload to the runner's
device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..block import Page
from ..types import TrinoError
from .spi import (ColumnHandle, Connector, ConnectorMetadata,
                  ConnectorPageSink, ConnectorPageSource,
                  ConnectorSplit, ConnectorSplitManager, FixedPageSource,
                  TableHandle, TableStatistics)


class _TableData:
    def __init__(self, columns: List[ColumnHandle]):
        from ..block import Dictionary

        self.columns = columns
        self.pages: List[Page] = []
        self.lock = threading.Lock()
        # canonical per-column pools: appended pages re-encode into these
        # so scans present stable code spaces (group-by/join correctness)
        self.dicts = [Dictionary() if c.type.is_string else None
                      for c in columns]

    @property
    def row_count(self) -> int:
        return sum(p.num_rows for p in self.pages)

    def canonicalize(self, page: Page) -> Page:
        import numpy as np

        from ..block import Block

        blocks = []
        for i, c in enumerate(self.columns):
            b = page.block(i).numpy()
            if c.type.is_string and b.dictionary is not self.dicts[i]:
                d = self.dicts[i]
                remap = d.encode(b.dictionary.values) \
                    if len(b.dictionary) else np.empty(0, np.int32)
                data = remap[b.data] if len(remap) else b.data
                blocks.append(Block(c.type, data, b.nulls, d))
            else:
                blocks.append(b)
        return Page(blocks, page.num_rows)


class MemoryMetadata(ConnectorMetadata):
    def __init__(self, conn: "MemoryConnector"):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return sorted(self.conn.schemas)

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for (s, t) in self.conn.tables if s == schema)

    def get_table_handle(self, schema, table) -> Optional[TableHandle]:
        if (schema, table) in self.conn.tables:
            return TableHandle(self.conn.catalog_name, schema, table)
        return None

    def apply_filter(self, table: TableHandle, constraint):
        """Row-level enforcement over the stored pages (reference:
        ConnectorMetadata.applyFilter)."""
        from .spi import negotiate_constraint

        data = self.conn.tables.get((table.schema, table.table))
        if data is None:
            return None
        return negotiate_constraint(table, constraint,
                                    (c.name for c in data.columns))

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        return self.conn.tables[(table.schema, table.table)].columns

    def get_statistics(self, table: TableHandle) -> TableStatistics:
        data = self.conn.tables[(table.schema, table.table)]
        return TableStatistics(row_count=float(data.row_count))

    def create_table(self, schema: str, table: str,
                     columns: List[ColumnHandle]) -> TableHandle:
        with self.conn.lock:
            if (schema, table) in self.conn.tables:
                raise TrinoError(f"Table '{schema}.{table}' already exists",
                                 "TABLE_ALREADY_EXISTS")
            self.conn.tables[(schema, table)] = _TableData(list(columns))
            self.conn.schemas.add(schema)
            self.conn._version += 1      # DDL invalidates cached plans
        return TableHandle(self.conn.catalog_name, schema, table)

    def drop_table(self, table: TableHandle):
        with self.conn.lock:
            self.conn.tables.pop((table.schema, table.table), None)
            self.conn._version += 1      # DDL invalidates cached plans


class MemorySplitManager(ConnectorSplitManager):
    def __init__(self, conn: "MemoryConnector"):
        self.conn = conn

    def get_splits(self, table: TableHandle,
                   desired_splits: int) -> List[ConnectorSplit]:
        data = self.conn.tables[(table.schema, table.table)]
        n = len(data.pages)
        k = max(1, min(desired_splits, n)) if n else 1
        return [ConnectorSplit(table, i, k, i, n, info={"stride": k})
                for i in range(k)]


class MemoryPageSink(ConnectorPageSink):
    def __init__(self, data: _TableData, conn: "MemoryConnector"):
        self.data = data
        self.rows = 0
        self.conn = conn

    def append_page(self, page: Page):
        page = self.data.canonicalize(page)
        with self.data.lock:
            self.data.pages.append(page)
            self.rows += page.num_rows
        # bump per page, not only at finish: a cached read overlapping a
        # half-complete write must already see a moved snapshot version
        self.conn.bump_version()

    def finish(self) -> dict:
        return {"rows": self.rows}


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self, catalog_name: str = "memory",
                 schemas: Sequence[str] = ("default",)):
        self.catalog_name = catalog_name
        self.schemas = set(schemas)
        self.tables: Dict[Tuple[str, str], _TableData] = {}
        self.lock = threading.Lock()
        self._version = 0

    def data_version(self) -> int:
        """Snapshot version for the plan/result caches: every DDL and
        every written page bumps it, so dependent cache entries miss."""
        return self._version

    def bump_version(self):
        with self.lock:
            self._version += 1

    def metadata(self) -> ConnectorMetadata:
        return MemoryMetadata(self)

    def split_manager(self) -> ConnectorSplitManager:
        return MemorySplitManager(self)

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]) -> ConnectorPageSource:
        data = self.tables[(split.table.schema, split.table.table)]
        stride = (split.info or {}).get("stride", 1)
        with data.lock:
            mine = data.pages[split.row_start::stride] if data.pages else []
        ordinals = [c.ordinal for c in columns]
        cons = split.table.constraint
        if cons is not None:
            from .spi import enforce_constraint_page

            names = [c.name for c in data.columns]
            return FixedPageSource([
                enforce_constraint_page(p, names, cons, ordinals)
                for p in mine])
        return FixedPageSource([p.select_channels(ordinals) for p in mine])

    def page_sink(self, table: TableHandle,
                  columns: Sequence[ColumnHandle]) -> ConnectorPageSink:
        return MemoryPageSink(self.tables[(table.schema, table.table)],
                              self)
