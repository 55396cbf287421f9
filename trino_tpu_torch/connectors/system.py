"""System connector: the engine's live state as SQL tables.

Reference analog: ``core/trino-main/.../connector/system/`` —
``GlobalSystemConnector`` serving ``system.runtime.queries`` /
``system.runtime.tasks`` (QuerySystemTable, TaskSystemTable over the
coordinator's QueryManager) plus the jmx metrics tables.  Here one
connector instance is bound to its owning runner (the ``source``) and
materializes a snapshot page per scan:

- ``system.runtime.queries``: running queries (event-manager running
  set) + the completed-query ring buffer, with wall/rows/error;
- ``system.runtime.tasks``: tasks currently tracked by live workers
  (process runner) — empty for single-process runners;
- ``system.runtime.metrics``: the flattened metrics registry, one row
  per (name, labels) sample — the SQL view of ``GET /v1/metrics``;
- ``system.runtime.kernels``: the program profiler registry
  (telemetry.profiler) — one row per program and signature with calls,
  compile wall (the kernel library's build) and ``execute_ms``, the
  calls' CUDA-event spans (``telemetry/profiler.py``); empty until
  profiling runs (``query_profiling_enabled`` or EXPLAIN ANALYZE
  VERBOSE).
- ``system.runtime.plan_stats``: the history-based statistics store
  (telemetry.stats_store) — one row per (statement, plan node).

The JAX engine's ``trino_tpu/connectors/system.py``, copied.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from .. import types as T
from ..block import Page
from .spi import (ColumnHandle, Connector, ConnectorMetadata,
                  ConnectorPageSource, ConnectorSplit,
                  ConnectorSplitManager, FixedPageSource, TableHandle,
                  TableStatistics)

RUNTIME_SCHEMA = "runtime"

#: table -> ordered (column, type) schema
RUNTIME_TABLES = {
    "queries": (
        ("query_id", T.VARCHAR), ("state", T.VARCHAR),
        ("user", T.VARCHAR), ("query", T.VARCHAR),
        ("started", T.DOUBLE), ("wall_ms", T.DOUBLE),
        ("rows", T.BIGINT), ("error_code", T.VARCHAR),
        ("slow", T.VARCHAR)),
    "tasks": (
        ("task_id", T.VARCHAR), ("query_id", T.VARCHAR),
        ("worker", T.VARCHAR), ("state", T.VARCHAR),
        ("rows", T.BIGINT), ("error_type", T.VARCHAR)),
    "nodes": (
        ("node_id", T.VARCHAR), ("address", T.VARCHAR),
        ("state", T.VARCHAR), ("pid", T.BIGINT),
        ("generation", T.BIGINT), ("join_reason", T.VARCHAR),
        ("retire_reason", T.VARCHAR)),
    "metrics": (
        ("name", T.VARCHAR), ("labels", T.VARCHAR),
        ("kind", T.VARCHAR), ("value", T.DOUBLE)),
    "kernels": (
        ("name", T.VARCHAR), ("key", T.VARCHAR),
        ("compiles", T.BIGINT), ("calls", T.BIGINT),
        ("trace_ms", T.DOUBLE), ("compile_ms", T.DOUBLE),
        ("execute_ms", T.DOUBLE), ("flops", T.DOUBLE),
        ("bytes_accessed", T.DOUBLE), ("output_bytes", T.BIGINT),
        ("temp_bytes", T.BIGINT), ("code_bytes", T.BIGINT)),
    "plan_stats": (
        ("statement", T.VARCHAR), ("node", T.VARCHAR),
        ("name", T.VARCHAR), ("runs", T.BIGINT),
        ("rows", T.DOUBLE), ("bytes", T.DOUBLE),
        ("wall_ms", T.DOUBLE), ("flops", T.DOUBLE),
        ("peak_memory_bytes", T.DOUBLE)),
}


class _SystemMetadata(ConnectorMetadata):
    def __init__(self, conn: "SystemConnector"):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return [RUNTIME_SCHEMA]

    def list_tables(self, schema: str) -> List[str]:
        return sorted(RUNTIME_TABLES) if schema == RUNTIME_SCHEMA else []

    def get_table_handle(self, schema: str,
                         table: str) -> Optional[TableHandle]:
        if schema == RUNTIME_SCHEMA and table in RUNTIME_TABLES:
            return TableHandle(self.conn.catalog_name, schema, table)
        return None

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        return [ColumnHandle(name, type_, i) for i, (name, type_)
                in enumerate(RUNTIME_TABLES[table.table])]

    def get_statistics(self, table: TableHandle) -> TableStatistics:
        return TableStatistics(row_count=64.0)


class SystemConnector(Connector):
    """``source`` is the owning runner (duck-typed): ``event_manager``
    backs the queries table, ``runtime_tasks()`` the tasks table,
    ``runtime_nodes()`` the nodes table (elastic membership ledger),
    and ``metrics_families()`` the metrics table; each is optional so
    any runner can host the catalog."""

    name = "system"

    def data_version(self) -> None:
        """Live catalog — every read reflects CURRENT runner state, so
        statements touching it are uncacheable (inherits the base None;
        spelled out because the plan/result caches depend on it)."""
        return None

    def __init__(self, catalog_name: str = "system", source=None,
                 history_limit: int = 200):
        self.catalog_name = catalog_name
        self.source = source
        self.history_limit = history_limit

    def metadata(self) -> ConnectorMetadata:
        return _SystemMetadata(self)

    def split_manager(self) -> ConnectorSplitManager:
        class _SM(ConnectorSplitManager):
            def get_splits(self, table, desired_splits):
                # coordinator-local state: exactly one split
                return [ConnectorSplit(table, 0, 1, 0, 0)]

        return _SM()

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]
                    ) -> ConnectorPageSource:
        rows = self._rows(split.table.table)
        types_ = [c.type for c in columns]
        data = [[row[c.ordinal] for row in rows] for c in columns]
        if not rows:
            return FixedPageSource([])
        return FixedPageSource([Page.from_pylists(types_, data)])

    # -- row builders ------------------------------------------------------

    def _rows(self, table: str) -> List[tuple]:
        try:
            if table == "queries":
                return self._query_rows()
            if table == "tasks":
                return self._task_rows()
            if table == "nodes":
                return self._node_rows()
            if table == "kernels":
                return self._kernel_rows()
            if table == "plan_stats":
                return self._plan_stats_rows()
            return self._metric_rows()
        except Exception:
            # introspection must never fail a query over it; a torn
            # snapshot surfaces as missing rows, not an engine error
            return []

    def _query_rows(self) -> List[tuple]:
        mgr = getattr(self.source, "event_manager", None)
        if mgr is None:
            return []
        rows = []
        now = time.time()
        for e in mgr.running():
            rows.append((e.query_id, "RUNNING", e.user, e.sql,
                         e.create_time,
                         round((now - e.create_time) * 1e3, 2),
                         None, None, None))
        for e in mgr.history(self.history_limit):
            slow = (e.stats or {}).get("slow_query")
            rows.append((e.query_id, e.state, e.user, e.sql,
                         e.create_time, round(e.wall_ms, 2),
                         e.output_rows, e.error_code,
                         self._slow_text(slow)))
        return rows

    @staticmethod
    def _slow_text(slow) -> Optional[str]:
        """Compact rendering of a slow-query record: critical path +
        top cost operators + the worst-misestimated plan node, one
        cell (the full dict stays on the event)."""
        if not slow:
            return None
        parts = [f"wall={slow.get('wall_ms', 0)}ms"]
        cp = slow.get("critical_path")
        if cp:
            parts.append("path=" + " > ".join(
                f"{s['name']} {s['ms']}ms" for s in cp))
        top = slow.get("top_operators")
        if top:
            parts.append("top=" + ", ".join(
                f"{o['name']} {o['busy_ms']}ms" for o in top))
        worst = slow.get("worst_misestimate")
        if worst:
            parts.append(
                f"misest={worst['name']} est {worst['est_rows']} "
                f"actual {worst['actual_rows']} q={worst['qerror']}")
        return "; ".join(parts)

    @staticmethod
    def _plan_stats_rows() -> List[tuple]:
        from ..telemetry import stats_store

        rows = []
        for e in stats_store.store().snapshot():
            rows.append((e["statement"], e["fp"], e["name"],
                         e["runs"], round(e["rows"], 2),
                         round(e["bytes"], 2), round(e["wall_ms"], 3),
                         round(e["flops"], 2),
                         round(e["peak_bytes"], 2)))
        return rows

    def _kernel_rows(self) -> List[tuple]:
        from ..telemetry import profiler

        rows = []
        for e in profiler.snapshot():
            rows.append((e["name"], e["key"], e["compiles"], e["calls"],
                         e["trace_ms"], e["compile_ms"],
                         e["execute_ms"], e["flops"],
                         e["bytes_accessed"], e["output_bytes"],
                         e["temp_bytes"], e["code_bytes"]))
        return rows

    def _task_rows(self) -> List[tuple]:
        fn = getattr(self.source, "runtime_tasks", None)
        return [tuple(r) for r in fn()] if callable(fn) else []

    def _node_rows(self) -> List[tuple]:
        fn = getattr(self.source, "runtime_nodes", None)
        return [tuple(r) for r in fn()] if callable(fn) else []

    def _metric_rows(self) -> List[tuple]:
        fn = getattr(self.source, "metrics_families", None)
        if not callable(fn):
            return []
        from ..telemetry.metrics import _fmt_labels

        rows = []
        for fam in fn():
            for labels, value in fam["samples"]:
                label_str = _fmt_labels(labels)
                if fam["type"] == "histogram":
                    rows.append((fam["name"] + "_count", label_str,
                                 "histogram", float(value["count"])))
                    rows.append((fam["name"] + "_sum", label_str,
                                 "histogram", float(value["sum"])))
                else:
                    rows.append((fam["name"], label_str, fam["type"],
                                 float(value)))
        return rows
