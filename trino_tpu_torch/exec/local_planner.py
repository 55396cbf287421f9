"""Local execution planner: PlanNode tree -> operator pipelines on torch.

Reference analog: ``sql/planner/LocalExecutionPlanner.java``: the visitor
that turns a plan fragment into DriverFactories, fixing the physical
channel layout of every pipeline and compiling expressions.

The torch engine plans TableScan, Values, Filter, Project, Aggregation,
Sort and Output. Every other node raises NOT_SUPPORTED: joins, set
operations, limits, TopN, windows, unnest, writers and remote sources
are not ported yet.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, List, Tuple

from .. import types as T
from ..block import Page
from ..expr.compiler import PageProcessor
from ..expr.ir import Call, InputRef, Literal, RowExpression
from ..ops.aggregation import AggCall, HashAggregationOperator
from ..ops.operator import (FilterProjectOperator, Operator,
                            OutputCollectorOperator, TableScanOperator,
                            ValuesOperator)
from ..ops.sort import OrderByOperator
from ..ops.sortkeys import SortKey
from ..planner.logical_planner import Metadata
from ..planner.plan import (AggregationNode, FilterNode, OutputNode,
                            PlanNode, ProjectNode, SortNode, TableScanNode,
                            ValuesNode)
from ..planner.symbols import to_input_refs
from ..types import TrinoError


class PhysicalPipeline:
    """One operator chain; drivers run pipelines in list order."""

    def __init__(self, operators: List[Operator]):
        self.operators = operators


class LocalExecutionPlan:
    def __init__(self, pipelines: List[PhysicalPipeline],
                 sink: OutputCollectorOperator,
                 column_names: List[str], output_types: List[T.Type]):
        self.pipelines = pipelines
        self.sink = sink
        self.column_names = column_names
        self.output_types = output_types

    def execute(self, collect_stats: bool = False) -> List[Page]:
        from .driver import Driver

        self.drivers = []
        for p in self.pipelines:
            d = Driver(p.operators, collect_stats=collect_stats)
            self.drivers.append(d)
            d.run_to_completion()
        return self.sink.pages


class LocalExecutionPlanner:
    """Builds the operators of one plan on ``device``."""

    def __init__(self, metadata: Metadata, device, desired_splits: int = 4,
                 memory_pool=None, hash_grouping: bool = True,
                 scan_coalesce: bool = True):
        self.metadata = metadata
        self.device = device
        self.desired_splits = desired_splits
        self.memory_pool = memory_pool
        #: GROUP BY path: vectorized open-addressing hash table (default)
        #: vs sort-based oracle (``hash_grouping_enabled`` session prop)
        self.hash_grouping = hash_grouping
        #: coalesce split-tail scan pages up to the connector page size
        #: before device upload (``scan_coalesce_enabled``)
        self.scan_coalesce = scan_coalesce
        self.pipelines: List[PhysicalPipeline] = []

    def _fp_operator(self, input_types, projections,
                     filter_expr=None) -> FilterProjectOperator:
        return FilterProjectOperator(PageProcessor(
            list(input_types), list(projections), filter_expr))

    def _mem_ctx(self, name: str):
        if self.memory_pool is None:
            return None
        return self.memory_pool.create_context(name)

    def plan(self, root: OutputNode) -> LocalExecutionPlan:
        ops, layout, types_ = self.visit(root.source)
        # final projection into output order
        projections = [InputRef(s.type, layout[s.name])
                       for s in root.outputs]
        if [p.channel for p in projections] != list(range(len(types_))) or \
                len(projections) != len(types_):
            ops.append(self._fp_operator(types_, projections))
        sink = OutputCollectorOperator()
        ops.append(sink)
        self.pipelines.append(PhysicalPipeline(ops))
        return LocalExecutionPlan(self.pipelines, sink, root.column_names,
                                  [s.type for s in root.outputs])

    # ------------------------------------------------------------------

    def visit(self, node: PlanNode
              ) -> Tuple[List[Operator], Dict[str, int], List[T.Type]]:
        m = getattr(self, "_v_" + type(node).__name__, None)
        if m is None:
            raise TrinoError(
                f"no local planning for {type(node).__name__} in the "
                "torch engine", "NOT_SUPPORTED")
        return m(node)

    def _v_TableScanNode(self, node: TableScanNode):
        conn = self.metadata.connectors[node.catalog]
        columns = [c for _, c in node.assignments]
        scan = TableScanOperator(conn, columns, self.device,
                                 coalesce_rows=getattr(
                                     conn, "page_rows", None)
                                 if self.scan_coalesce else None)
        for split in conn.split_manager().get_splits(node.table,
                                                     self.desired_splits):
            scan.add_split(split)
        scan.no_more_splits()
        layout = {s.name: i for i, (s, _) in enumerate(node.assignments)}
        types_ = [s.type for s, _ in node.assignments]
        return [scan], layout, types_

    def _v_ValuesNode(self, node: ValuesNode):
        types_ = [s.type for s in node.symbols]
        columns: List[List] = [[] for _ in node.symbols]
        for row in node.rows:
            for i, e in enumerate(row):
                columns[i].append(_eval_literal(e))
        if not node.symbols:
            # single empty row (SELECT without FROM)
            page = Page.from_pylists([], [])
            page.num_rows = max(1, len(node.rows))
            pages = [page]
        else:
            pages = [Page.from_pylists(types_, columns)]
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        return [ValuesOperator(pages, self.device)], layout, types_

    def _v_FilterNode(self, node: FilterNode):
        ops, layout, types_ = self.visit(node.source)
        pred = to_input_refs(node.predicate, layout)
        projections = [InputRef(t, i) for i, t in enumerate(types_)]
        ops.append(self._fp_operator(types_, projections, pred))
        return ops, layout, types_

    def _v_ProjectNode(self, node: ProjectNode):
        ops, layout, types_ = self.visit(node.source)
        projections = [to_input_refs(e, layout) for _, e in node.assignments]
        ops.append(self._fp_operator(types_, projections))
        new_layout = {s.name: i for i, (s, _) in enumerate(node.assignments)}
        return ops, new_layout, [s.type for s, _ in node.assignments]

    def _v_AggregationNode(self, node: AggregationNode):
        ops, layout, types_ = self.visit(node.source)
        group_channels = [layout[s.name] for s in node.group_keys]
        aggs = []
        for out_sym, a in node.aggregations:
            if a.distinct:
                raise TrinoError(
                    "DISTINCT aggregates execute via the planner rewrite; "
                    "this one was not rewritten", "NOT_SUPPORTED")
            if a.argument is None:
                aggs.append(AggCall("count_star", None, None, out_sym.type))
            elif node.step == "final":
                # input is the intermediate keys+states layout: states
                # are positional, arg channel is not read
                aggs.append(AggCall(a.function, None, a.argument.type,
                                    out_sym.type))
            else:
                ch = layout[a.argument.name]
                aggs.append(AggCall(a.function, ch, types_[ch],
                                    out_sym.type))
        if node.step == "final":
            # the operator's final path expects keys at channels [0..k)
            # then state columns — reorder if the source layout differs
            in_syms = list(node.group_keys) + list(node.state_symbols or [])
            want = [layout[s.name] for s in in_syms]
            if want != list(range(len(want))) or len(want) != len(types_):
                proj = [InputRef(types_[c], c) for c in want]
                ops.append(self._fp_operator(types_, proj))
                types_ = [types_[c] for c in want]
                group_channels = list(range(len(node.group_keys)))
        ops.append(HashAggregationOperator(
            types_, group_channels, aggs, self.device, step=node.step,
            memory_context=self._mem_ctx("agg"),
            hash_grouping=self.hash_grouping))
        new_layout = {}
        out_types = []
        for i, s in enumerate(node.group_keys):
            new_layout[s.name] = i
            out_types.append(types_[group_channels[i]])
        base = len(node.group_keys)
        if node.step == "partial":
            for j, s in enumerate(node.state_symbols or []):
                new_layout[s.name] = base + j
                out_types.append(s.type)
        else:
            for j, (out_sym, _a) in enumerate(node.aggregations):
                new_layout[out_sym.name] = base + j
                out_types.append(out_sym.type)
        return ops, new_layout, out_types

    def _v_SortNode(self, node: SortNode):
        ops, layout, types_ = self.visit(node.source)
        keys = _sort_keys(node.orderings, layout)
        ops.append(OrderByOperator(types_, keys,
                                   memory_context=self._mem_ctx("sort")))
        return ops, layout, types_


def _sort_keys(orderings, layout) -> List[SortKey]:
    keys = []
    for o in orderings:
        nulls_last = o.nulls_last if o.nulls_last is not None \
            else o.ascending
        keys.append(SortKey(layout[o.symbol.name], o.ascending, nulls_last))
    return keys


def _eval_literal(e: RowExpression):
    """Host evaluation of literal-only expression trees (VALUES rows)."""
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Call) and e.name == "$cast":
        v = _eval_literal(e.args[0])
        if v is None:
            return None
        t = e.type
        if t.is_decimal:
            return Decimal(str(v))
        if t in (T.DOUBLE, T.REAL):
            return float(v)
        if t in (T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT):
            return int(v)
        if t.is_string:
            return str(v)
        return v
    if isinstance(e, Call) and e.name == "negate":
        v = _eval_literal(e.args[0])
        return None if v is None else -v
    raise TrinoError(f"VALUES rows must be literals, got {e!r}",
                     "NOT_SUPPORTED")
