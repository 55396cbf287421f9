"""LocalQueryRunner: the whole engine (parser -> planner -> operators) in
one process, on one torch device.

Reference analog: ``core/trino-main/.../testing/LocalQueryRunner.java:254``
— the single-node, no-HTTP engine. The path is the JAX engine's
(``trino_tpu/runner.py``: parse -> analyze -> plan -> optimize ->
LocalExecutionPlanner -> Driver) without its plan and result caches, plan
templates, batching and history-based statistics.

The device is explicit: ``device`` defaults to ``"cuda"``, and a runner
asked for CUDA on a machine without a GPU raises instead of running on
the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from . import types as T
from .connectors.spi import Connector
from .exec.local_planner import LocalExecutionPlanner
from .planner.logical_planner import LogicalPlanner, Metadata
from .planner.optimizer import optimize
from .planner.plan import OutputNode, plan_tree_str
from .sql import ast
from .sql.analyzer import Session
from .sql.parser import parse_statement


@dataclass
class QueryResult:
    column_names: List[str]
    types: List[T.Type]
    rows: List[tuple]
    stats: Optional[dict] = None


class LocalQueryRunner:
    def __init__(self, connectors: Dict[str, Connector],
                 session: Optional[Session] = None,
                 desired_splits: int = 4, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LocalQueryRunner: device 'cuda' requested but no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        self.metadata = Metadata(dict(connectors))
        self.session = session or Session(
            catalog=next(iter(connectors), None))
        self.desired_splits = desired_splits

    def plan_statement(self, stmt: ast.Statement) -> OutputNode:
        planner = LogicalPlanner(self.metadata, self.session)
        root = planner.plan(stmt)
        return optimize(root, self.metadata, planner.allocator,
                        self.session, hbo=None)

    def execute(self, sql: str) -> QueryResult:
        """Run one statement: a query, EXPLAIN (the optimized plan) or
        SET SESSION. Other statements raise NOT_SUPPORTED."""
        stmt = parse_statement(sql)
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                raise T.TrinoError("EXPLAIN ANALYZE is not ported to the "
                                   "torch engine yet", "NOT_SUPPORTED")
            lines = plan_tree_str(
                self.plan_statement(stmt.statement)).splitlines()
            return QueryResult(["Query Plan"], [T.VARCHAR],
                               [(line,) for line in lines])
        if isinstance(stmt, ast.SetSession):
            from . import session_properties as SP
            from .exec.local_planner import _eval_literal
            from .sql.analyzer import ExpressionAnalyzer, Scope

            an = ExpressionAnalyzer(Scope([], None), self.session)
            SP.set_property(self.session.properties, stmt.name,
                            _eval_literal(an.analyze(stmt.value)))
            return QueryResult(["result"], [T.BOOLEAN], [(True,)])
        if not isinstance(stmt, ast.QueryStatement):
            raise T.TrinoError(
                f"{type(stmt).__name__} is not ported to the torch engine "
                "yet", "NOT_SUPPORTED")
        return self._execute_query(stmt)

    def _execute_query(self, stmt: ast.Statement) -> QueryResult:
        root = self.plan_statement(stmt)
        local = self._make_local_planner()
        try:
            plan = local.plan(root)
            rows: List[tuple] = []
            for p in plan.execute():
                rows.extend(p.to_rows())
            stats = {"memory": local.memory_pool.stats(),
                     "operators": _operator_metrics(plan.drivers)}
        finally:
            local.memory_pool.close()
        return QueryResult(plan.column_names, plan.output_types, rows,
                           stats=stats)

    def _splits(self) -> int:
        from . import session_properties as SP

        if "desired_splits" in self.session.properties:
            return SP.value(self.session, "desired_splits")
        return self.desired_splits

    def _make_local_planner(self) -> LocalExecutionPlanner:
        """Session-configured planner on this runner's device."""
        from . import session_properties as SP
        from .exec.memory import pool_from_session

        return LocalExecutionPlanner(
            self.metadata, self.device, self._splits(),
            memory_pool=pool_from_session(self.session),
            hash_grouping=SP.value(self.session, "hash_grouping_enabled"),
            scan_coalesce=SP.value(self.session, "scan_coalesce_enabled"))


def _operator_metrics(drivers) -> List[dict]:
    """Each operator's name and reported metrics (the aggregation's pages
    per grouping path, ...), pipeline by pipeline."""
    out = []
    for d in drivers:
        d.collect_operator_metrics()
        out.extend(dict(st.metrics or {}, name=st.name) for st in d.stats)
    return out
