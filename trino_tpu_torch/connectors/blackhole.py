"""Blackhole connector: /dev/null tables with synthetic rows.

Reference analog: ``plugin/trino-blackhole`` (``BlackHoleConnector.java``)
— writes are discarded (counted), reads produce a configurable number of
synthetic rows; the perf/test fixture for write paths and scheduling.

The JAX engine's black-hole connector
(``trino_tpu/connectors/blackhole.py``), copied.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..block import Block, Dictionary, Page
from .spi import (ColumnHandle, Connector, ConnectorMetadata,
                  ConnectorPageSink, ConnectorPageSource, ConnectorSplit,
                  ConnectorSplitManager, TableHandle, TableStatistics)


class _BhTable:
    def __init__(self, columns: List[ColumnHandle], rows_per_page: int,
                 pages_per_split: int, splits: int):
        self.columns = columns
        self.rows_per_page = rows_per_page
        self.pages_per_split = pages_per_split
        self.splits = splits


class _BhPageSource(ConnectorPageSource):
    def __init__(self, table: _BhTable, columns: Sequence[ColumnHandle]):
        self.table = table
        self.columns = list(columns)
        self.remaining = table.pages_per_split
        self._dicts: Dict[str, Dictionary] = {}

    def get_next_page(self) -> Optional[Page]:
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        n = self.table.rows_per_page
        blocks = []
        for c in self.columns:
            if c.type.is_string:
                d = self._dicts.setdefault(c.name, Dictionary(["x"]))
                blocks.append(Block(c.type, np.zeros(n, np.int32), None, d))
            else:
                blocks.append(Block(
                    c.type, np.zeros(n, dtype=c.type.storage)))
        return Page(blocks, n)

    def is_finished(self) -> bool:
        return self.remaining <= 0


class _BhSink(ConnectorPageSink):
    def __init__(self):
        self.rows = 0

    def append_page(self, page: Page):
        self.rows += page.num_rows  # discarded

    def finish(self) -> dict:
        return {"rows": self.rows}


class BlackHoleMetadata(ConnectorMetadata):
    def __init__(self, conn: "BlackHoleConnector"):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return ["default"]

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for (s, t) in self.conn.tables if s == schema)

    def get_table_handle(self, schema, table) -> Optional[TableHandle]:
        if (schema, table) in self.conn.tables:
            return TableHandle(self.conn.catalog_name, schema, table)
        return None

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        return self.conn.tables[(table.schema, table.table)].columns

    def create_table(self, schema: str, table: str,
                     columns: List[ColumnHandle]) -> TableHandle:
        with self.conn.lock:
            self.conn.tables[(schema, table)] = _BhTable(
                list(columns), self.conn.rows_per_page,
                self.conn.pages_per_split, self.conn.split_count)
        return TableHandle(self.conn.catalog_name, schema, table)

    def drop_table(self, table: TableHandle):
        with self.conn.lock:
            self.conn.tables.pop((table.schema, table.table), None)


class BlackHoleConnector(Connector):
    name = "blackhole"

    def __init__(self, catalog_name: str = "blackhole",
                 rows_per_page: int = 0, pages_per_split: int = 1,
                 split_count: int = 1):
        self.catalog_name = catalog_name
        self.rows_per_page = rows_per_page
        self.pages_per_split = pages_per_split
        self.split_count = split_count
        self.tables: Dict[Tuple[str, str], _BhTable] = {}
        self.lock = threading.Lock()

    def metadata(self) -> ConnectorMetadata:
        return BlackHoleMetadata(self)

    def split_manager(self) -> ConnectorSplitManager:
        conn = self

        class _SM(ConnectorSplitManager):
            def get_splits(self, table, desired_splits):
                t = conn.tables[(table.schema, table.table)]
                return [ConnectorSplit(table, i, t.splits, 0, 0)
                        for i in range(t.splits)]

        return _SM()

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]) -> ConnectorPageSource:
        t = self.tables[(split.table.schema, split.table.table)]
        return _BhPageSource(t, columns)

    def page_sink(self, table: TableHandle,
                  columns: Sequence[ColumnHandle]) -> ConnectorPageSink:
        return _BhSink()
