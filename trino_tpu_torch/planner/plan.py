"""Logical plan nodes.

Reference analog: ``sql/planner/plan/`` (60 node classes). The subset here
covers the engine's executable surface; every node lists its output
symbols, and expressions are RowExpressions over SymbolRefs
(``planner/symbols.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..connectors.spi import ColumnHandle, TableHandle
from ..expr.ir import RowExpression
from .symbols import Symbol


class PlanNode:
    @property
    def sources(self) -> List["PlanNode"]:
        return []

    @property
    def output_symbols(self) -> List[Symbol]:
        raise NotImplementedError


@dataclass
class TableScanNode(PlanNode):
    """Reference: sql/planner/plan/TableScanNode.java"""

    catalog: str
    table: TableHandle
    assignments: List[Tuple[Symbol, ColumnHandle]]

    @property
    def output_symbols(self):
        return [s for s, _ in self.assignments]


@dataclass
class ValuesNode(PlanNode):
    """Reference: sql/planner/plan/ValuesNode.java"""

    symbols: List[Symbol]
    rows: List[List[RowExpression]]  # literal rows

    @property
    def output_symbols(self):
        return list(self.symbols)


@dataclass
class FilterNode(PlanNode):
    """Reference: sql/planner/plan/FilterNode.java"""

    source: PlanNode
    predicate: RowExpression

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class ProjectNode(PlanNode):
    """Reference: sql/planner/plan/ProjectNode.java"""

    source: PlanNode
    assignments: List[Tuple[Symbol, RowExpression]]

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return [s for s, _ in self.assignments]

    def is_identity(self) -> bool:
        from .symbols import SymbolRef

        src = self.source.output_symbols
        if len(self.assignments) != len(src):
            return False
        return all(isinstance(e, SymbolRef) and e.name == out.name == s.name
                   for (out, e), s in zip(self.assignments, src))


@dataclass(frozen=True)
class Aggregation:
    """One aggregate call (reference: plan/AggregationNode.Aggregation)."""

    function: str                       # count|count_star|sum|avg|min|max|...
    argument: Optional[Symbol]          # pre-projected input symbol
    distinct: bool = False
    # filter/mask arrives later (FILTER clause)


@dataclass
class AggregationNode(PlanNode):
    """Reference: sql/planner/plan/AggregationNode.java. For
    ``step='partial'`` the outputs are keys + ``state_symbols`` (one per
    accumulator state column, set by the exchange planner)."""

    source: PlanNode
    group_keys: List[Symbol]
    aggregations: List[Tuple[Symbol, Aggregation]]
    step: str = "single"  # single | partial | final
    state_symbols: Optional[List[Symbol]] = None
    #: merge-shape strategy ('exchange' | 'global-hash') from the cost
    #: model — the device-mesh path consults the same rule at run time
    strategy: str = "exchange"
    strategy_detail: str = ""

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        if self.step == "partial":
            return list(self.group_keys) + list(self.state_symbols or [])
        return list(self.group_keys) + [s for s, _ in self.aggregations]


@dataclass
class JoinNode(PlanNode):
    """Reference: sql/planner/plan/JoinNode.java. ``join_type`` inner|left|
    semi|anti (right/full are normalized away by the planner; semi/anti
    carry probe=left output only). ``criteria`` is equi-key pairs
    (left_symbol, right_symbol); ``filter_expr`` is a residual applied to
    the joined row (over left+right symbols)."""

    join_type: str
    left: PlanNode
    right: PlanNode
    criteria: List[Tuple[Symbol, Symbol]]
    filter_expr: Optional[RowExpression] = None
    #: probe-kernel strategy ('sorted-index' | 'matmul'), set by the
    #: cost model (optimizer.annotate_kernel_strategies) and read by
    #: the local planner; ``strategy_detail`` is the estimate that
    #: picked it (EXPLAIN surface)
    strategy: str = "sorted-index"
    strategy_detail: str = ""

    @property
    def sources(self):
        return [self.left, self.right]

    @property
    def output_symbols(self):
        if self.join_type in ("semi", "anti"):
            return self.left.output_symbols
        return self.left.output_symbols + self.right.output_symbols


@dataclass
class CrossJoinNode(PlanNode):
    """Pre-optimization implicit join (FROM a, b). The optimizer converts
    these + WHERE equi-conjuncts into JoinNodes (reference analog: implicit
    joins arrive as CROSS JOIN + filter and are rewritten by
    PredicatePushDown + ReorderJoins)."""

    left: PlanNode
    right: PlanNode

    @property
    def sources(self):
        return [self.left, self.right]

    @property
    def output_symbols(self):
        return self.left.output_symbols + self.right.output_symbols


@dataclass(frozen=True)
class Ordering:
    symbol: Symbol
    ascending: bool = True
    nulls_last: Optional[bool] = None  # None = SQL default for direction


@dataclass
class SortNode(PlanNode):
    """Reference: sql/planner/plan/SortNode.java"""

    source: PlanNode
    orderings: List[Ordering]

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class TopNNode(PlanNode):
    """Reference: sql/planner/plan/TopNNode.java"""

    source: PlanNode
    orderings: List[Ordering]
    count: int

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class LimitNode(PlanNode):
    """Reference: sql/planner/plan/LimitNode.java (+OffsetNode)"""

    source: PlanNode
    count: Optional[int]
    offset: int = 0

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class DistinctNode(PlanNode):
    """SELECT DISTINCT — executes as grouping with no aggregates
    (reference: AggregationNode with empty aggregations)."""

    source: PlanNode

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class UnionNode(PlanNode):
    """Reference: sql/planner/plan/UnionNode.java. Each source's outputs
    positionally map to this node's symbols."""

    symbols: List[Symbol]
    inputs: List[PlanNode]

    @property
    def sources(self):
        return list(self.inputs)

    @property
    def output_symbols(self):
        return list(self.symbols)


@dataclass
class IntersectNode(PlanNode):
    """INTERSECT [DISTINCT] (reference: plan/IntersectNode.java)."""

    symbols: List[Symbol]
    inputs: List[PlanNode]

    @property
    def sources(self):
        return list(self.inputs)

    @property
    def output_symbols(self):
        return list(self.symbols)


@dataclass
class ExceptNode(PlanNode):
    """EXCEPT [DISTINCT] (reference: plan/ExceptNode.java)."""

    symbols: List[Symbol]
    inputs: List[PlanNode]

    @property
    def sources(self):
        return list(self.inputs)

    @property
    def output_symbols(self):
        return list(self.symbols)


@dataclass
class EnforceSingleRowNode(PlanNode):
    """Scalar subquery guard: errors on >1 row, emits a NULL row on 0
    (reference: plan/EnforceSingleRowNode.java)."""

    source: PlanNode

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass(frozen=True)
class WindowFunctionSpec:
    """One window call (reference: plan/WindowNode.Function)."""

    function: str
    argument: Optional[Symbol]
    frame_mode: str = "range"   # partition | range | rows
    offset: int = 1             # lag/lead distance, ntile buckets, nth n
    # ROWS frame bounds: row offsets vs current row (negative =
    # PRECEDING, 0 = CURRENT ROW, None = UNBOUNDED)
    frame_start: Optional[int] = None
    frame_end: Optional[int] = 0


@dataclass
class WindowNode(PlanNode):
    """Reference: sql/planner/plan/WindowNode.java — one node per
    distinct (partition, order, frame) specification."""

    source: PlanNode
    partition_by: List[Symbol]
    orderings: List[Ordering]
    functions: List[Tuple[Symbol, WindowFunctionSpec]]

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols + [s for s, _ in self.functions]


@dataclass
class UnnestNode(PlanNode):
    """Expand array columns to one row per element (reference:
    sql/planner/plan/UnnestNode.java). Source rows replicate; multiple
    arrays zip (shorter ones pad with NULL)."""

    source: PlanNode
    array_symbols: List[Symbol]      # input array columns
    element_symbols: List[Symbol]    # one output element column each
    ordinality_symbol: Optional[Symbol] = None

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        out = list(self.source.output_symbols) + list(self.element_symbols)
        if self.ordinality_symbol is not None:
            out.append(self.ordinality_symbol)
        return out


@dataclass
class TableWriterNode(PlanNode):
    """Write query output to a connector sink; emits one row with the
    written-row count (reference: plan/TableWriterNode.java +
    TableFinishNode.java combined — the commit step is the sink's
    finish()). With ``create=True`` the target table is created at
    EXECUTION time (CTAS) — planning/EXPLAIN must not mutate metadata."""

    source: PlanNode
    catalog: str
    schema: str
    table_name: str
    columns: list          # target ColumnHandles in write order
    rows_symbol: Symbol
    create: bool = False

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return [self.rows_symbol]


@dataclass
class ExchangeNode(PlanNode):
    """A stage boundary (reference: sql/planner/plan/ExchangeNode.java,
    scope=REMOTE). ``kind``: 'hash' (partition rows on ``keys``),
    'single' (gather to one task), 'broadcast' (replicate to every
    consumer task), 'merge' (gather preserving each producer task's
    sort order — the consumer k-way merges per ``orderings``)."""

    source: PlanNode
    kind: str
    keys: List[Symbol]
    orderings: Optional[List[Ordering]] = None  # kind == 'merge'
    #: scaled-writer boundary (kind == 'hash' feeding a TableWriter):
    #: the host exchanger may re-assign logical partitions to writer
    #: lanes by observed load (reference: the SCALED_WRITER_HASH_
    #: DISTRIBUTION PartitioningHandle flag on PartitioningScheme)
    scale_writers: bool = False

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols


@dataclass
class RemoteSourceNode(PlanNode):
    """Reads one fragment's exchange output inside a consumer fragment
    (reference: sql/planner/plan/RemoteSourceNode.java)."""

    fragment_id: int
    symbols: List[Symbol]
    kind: str  # of the originating exchange
    orderings: Optional[List[Ordering]] = None  # kind == 'merge'

    @property
    def output_symbols(self):
        return list(self.symbols)


@dataclass
class OutputNode(PlanNode):
    """Reference: sql/planner/plan/OutputNode.java"""

    source: PlanNode
    column_names: List[str]
    outputs: List[Symbol]

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return list(self.outputs)


@dataclass
class TopNRankingNode(PlanNode):
    """Per-group top-N under a ranking function (reference:
    sql/planner/plan/TopNRankingNode.java, lowered from a row_number/
    rank window + a bound on its output). ``step='partial'`` truncates
    each task's groups BEFORE the exchange (the scalability point: at
    most groups*max_rank rows cross the wire); the final step re-ranks
    and emits the rank symbol."""

    source: PlanNode
    partition_by: List[Symbol]
    orderings: List[Ordering]
    ranking: str                    # row_number | rank
    max_rank: int
    rank_symbol: Symbol
    step: str = "single"            # single | partial | final

    @property
    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        base = list(self.source.output_symbols)
        if self.step == "partial":
            return base
        return base + [self.rank_symbol]


# ---------------------------------------------------------------------------


def plan_tree_str(node: PlanNode, indent: int = 0) -> str:
    """EXPLAIN rendering (reference analog: planprinter/PlanPrinter.java)."""
    pad = "  " * indent
    name = type(node).__name__.replace("Node", "")
    detail = ""
    if isinstance(node, TableScanNode):
        detail = f" {node.table.qualified_name}" \
                 f" {[s.name for s, _ in node.assignments]}"
        cons = getattr(node.table, "constraint", None)
        if cons is not None and cons.columns:
            parts = []
            for cname, dom in cons.columns:
                rng = "∅" if dom.values.is_none else (
                    "*" if dom.values.is_all
                    else ",".join(
                        (f"{r.low!r}" if r.is_single else
                         f"{'[' if r.low_inclusive else '('}"
                         f"{r.low!r},{r.high!r}"
                         f"{']' if r.high_inclusive else ')'}")
                        for r in dom.values.ranges))
                parts.append(f"{cname}:{rng}"
                             + ("+null" if dom.null_allowed else ""))
            detail += " constraint{" + " ".join(parts) + "}"
    elif isinstance(node, FilterNode):
        detail = f" {node.predicate!r}"
    elif isinstance(node, ProjectNode):
        detail = " " + ", ".join(f"{s.name}:={e!r}"
                                 for s, e in node.assignments)
    elif isinstance(node, AggregationNode):
        detail = (f" keys={[s.name for s in node.group_keys]} " +
                  ", ".join(f"{s.name}:={a.function}"
                            f"({a.argument.name if a.argument else '*'})"
                            for s, a in node.aggregations))
        if node.strategy != "exchange":
            detail += f" strategy={node.strategy}"
            if node.strategy_detail:
                detail += f" [{node.strategy_detail}]"
    elif isinstance(node, JoinNode):
        detail = f" {node.join_type} on " + ", ".join(
            f"{l.name}={r.name}" for l, r in node.criteria)
        if node.filter_expr is not None:
            detail += f" filter {node.filter_expr!r}"
        if node.strategy != "sorted-index":
            detail += f" strategy={node.strategy}"
            if node.strategy_detail:
                detail += f" [{node.strategy_detail}]"
        # exchange planning's broadcast-vs-partitioned choice, with the
        # estimate source that decided it (hbo = observed build rows or
        # a spill-hinted build refusing broadcast)
        dist = getattr(node, "distribution", None)
        if dist is not None:
            detail += (f" distribution={dist} "
                       f"[source={node.distribution_source}]")
    elif isinstance(node, (SortNode, TopNNode)):
        detail = " " + ", ".join(
            f"{o.symbol.name} {'asc' if o.ascending else 'desc'}"
            for o in node.orderings)
        if isinstance(node, TopNNode):
            detail += f" limit {node.count}"
    elif isinstance(node, LimitNode):
        detail = f" {node.count} offset {node.offset}"
    elif isinstance(node, TopNRankingNode):
        detail = (f" [{node.step}] {node.ranking}<="
                  f"{node.max_rank} by={[s.name for s in node.partition_by]}"
                  " order " + ", ".join(
                      f"{o.symbol.name} {'asc' if o.ascending else 'desc'}"
                      for o in node.orderings))
    elif isinstance(node, OutputNode):
        detail = f" {node.column_names}"
    # estimate provenance (annotate_kernel_strategies stamps these when
    # history-based statistics are in play): only hbo-sourced estimates
    # render, so plans without history keep today's byte-exact text
    if getattr(node, "est_source", None) == "hbo":
        detail += f" est~{node.est_rows:.0f} rows [source=hbo]"
    out = f"{pad}- {name}{detail}\n"
    for s in node.sources:
        out += plan_tree_str(s, indent + 1)
    return out
