"""AddExchanges: insert stage boundaries into an optimized plan.

Reference analog: ``sql/planner/optimizations/AddExchanges.java`` (global
property matching: required vs delivered distribution) plus the
partial-aggregation split from ``PushPartialAggregationThroughExchange``.
Property model compressed to the cases the engine executes:

- 'source'   — partitioned arbitrarily by table splits
- ('hash', keys) — rows partitioned on the hash of ``keys``
- 'single'   — everything in one task
- 'any'      — single-row / values

Aggregations split into partial (runs in the producer distribution) →
hash/single exchange → final. Joins choose broadcast (small build) vs
partitioned (both sides exchanged on the join keys) by estimated size —
the reference's cost-based distribution choice with size-greedy
estimates. Sort/TopN/Limit gain partial→gather→final phases.

The JAX engine's ``trino_tpu/planner/exchanges.py``, copied.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .. import types as T
from ..ops.aggregation import intermediate_state_types
from .logical_planner import Metadata
from .plan import (AggregationNode, CrossJoinNode, DistinctNode,
                   EnforceSingleRowNode, ExceptNode, ExchangeNode,
                   FilterNode, IntersectNode, JoinNode, LimitNode,
                   OutputNode, PlanNode, ProjectNode, SortNode,
                   TableScanNode, TopNNode, UnionNode, ValuesNode)
from .symbols import Symbol, SymbolAllocator

BROADCAST_THRESHOLD = 50_000.0

SINGLE = ("single",)
SOURCE = ("source",)
ANY = ("any",)


def _hash(keys: List[Symbol]):
    return ("hash", tuple(s.name for s in keys))


def state_types_for(agg: "Aggregation") -> List[T.Type]:  # noqa: F821
    """Intermediate state column types of one plan-level aggregate."""
    arg_type = agg.argument.type if agg.argument is not None else None
    return intermediate_state_types(agg.function, arg_type)


class ExchangePlanner:
    def __init__(self, metadata: Metadata, allocator: SymbolAllocator,
                 broadcast_threshold: float = BROADCAST_THRESHOLD,
                 join_distribution: str = "AUTOMATIC",
                 scale_writers: bool = False, hbo=None):
        from .stats import StatsCalculator

        self.metadata = metadata
        self.allocator = allocator
        self.broadcast_threshold = broadcast_threshold
        self.join_distribution = join_distribution
        self.scale_writers = scale_writers
        #: history view (telemetry.stats_store.HboContext): observed
        #: build rows beat connector estimates in the broadcast-vs-
        #: partitioned comparison, and a build that SPILLED on a prior
        #: run refuses broadcast outright
        self.hbo = hbo
        self._stats = StatsCalculator(metadata, history=hbo)
        # connector-only shadow estimator: prices the same build from
        # estimates alone so a history-driven decision change is
        # counted (hbo_plan_flips{kind="distribution"})
        self._stats_conn = StatsCalculator(metadata) \
            if hbo is not None else None

    def run(self, root: OutputNode) -> OutputNode:
        node, dist = self.visit(root.source)
        node = self._to_single(node, dist)
        return OutputNode(node, root.column_names, root.outputs)

    # ------------------------------------------------------------------

    def _to_single(self, node: PlanNode, dist) -> PlanNode:
        if dist in (SINGLE, ANY):
            return node
        return ExchangeNode(node, "single", [])

    def visit(self, node: PlanNode) -> Tuple[PlanNode, tuple]:
        m = getattr(self, "_v_" + type(node).__name__, None)
        if m is not None:
            return m(node)
        # default: force children single, keep node single
        new_sources = [self._to_single(*self.visit(s))
                       for s in node.sources]
        from .optimizer import _replace_sources

        return _replace_sources(node, new_sources), SINGLE

    def _v_TableScanNode(self, node):
        return node, SOURCE

    def _v_ValuesNode(self, node):
        return node, ANY

    def _v_FilterNode(self, node):
        src, dist = self.visit(node.source)
        return FilterNode(src, node.predicate), dist

    def _v_ProjectNode(self, node):
        src, dist = self.visit(node.source)
        # a projection may drop the symbols the distribution names;
        # degrade to 'any-partitioned' (still parallel) in that case
        if dist[0] == "hash":
            out_names = {s.name for s, _ in node.assignments}
            if not set(dist[1]) <= out_names:
                dist = SOURCE
        return ProjectNode(src, node.assignments), dist

    def _v_EnforceSingleRowNode(self, node):
        src, dist = self.visit(node.source)
        return EnforceSingleRowNode(self._to_single(src, dist)), SINGLE

    def _v_AggregationNode(self, node: AggregationNode):
        src, dist = self.visit(node.source)
        keys = node.group_keys
        if dist in (SINGLE, ANY):
            return AggregationNode(src, keys, node.aggregations,
                                   node.step, None, node.strategy,
                                   node.strategy_detail), dist
        if keys and dist == _hash(keys):
            # already partitioned on the grouping keys: aggregate locally
            return AggregationNode(src, keys, node.aggregations,
                                   node.step, None, node.strategy,
                                   node.strategy_detail), dist
        # partial -> exchange -> final
        state_symbols: List[Symbol] = []
        for out_sym, agg in node.aggregations:
            for j, st in enumerate(state_types_for(agg)):
                state_symbols.append(self.allocator.new_symbol(
                    f"{out_sym.name}_st{j}", st))
        partial = AggregationNode(src, keys, node.aggregations, "partial",
                                  state_symbols)
        if keys:
            ex = ExchangeNode(partial, "hash", list(keys))
            final_dist = _hash(keys)
        else:
            ex = ExchangeNode(partial, "single", [])
            final_dist = SINGLE
        final = AggregationNode(ex, keys, node.aggregations, "final",
                                state_symbols, node.strategy,
                                node.strategy_detail)
        return final, final_dist

    def _v_DistinctNode(self, node: DistinctNode):
        src, dist = self.visit(node.source)
        if dist in (SINGLE, ANY):
            return DistinctNode(src), dist
        cols = src.output_symbols
        if dist == _hash(cols):
            return DistinctNode(src), dist
        # local distinct -> hash exchange on all columns -> final distinct
        local = DistinctNode(src)
        ex = ExchangeNode(local, "hash", list(cols))
        return DistinctNode(ex), _hash(cols)

    def _v_JoinNode(self, node: JoinNode):
        left, ldist = self.visit(node.left)
        right, rdist = self.visit(node.right)
        lkeys = [l for l, _ in node.criteria]
        rkeys = [r for _, r in node.criteria]

        # stats-based build-size estimate: predicate selectivity and
        # join/agg cardinality included, not just base table rows, and
        # HBO-observed rows beating both (reference: CostComparator
        # driving the distribution choice)
        bstats = self._stats.stats(node.right)
        right_rows = bstats.row_count
        spill = self.hbo.spill_hint(self.hbo.fp(node.right)) \
            if self.hbo is not None else None
        dist = dsource = None
        can_partition = bool(node.criteria) and ldist not in (SINGLE, ANY)
        if node.join_type == "full":
            # broadcast would emit each unmatched build row once PER
            # probe task; FULL must co-partition both sides on the join
            # keys (or collapse to a single task)
            if ldist in (SINGLE, ANY):
                right = self._to_single(right, rdist)
                return JoinNode(node.join_type, left, right, node.criteria,
                                node.filter_expr, node.strategy,
                                node.strategy_detail), SINGLE
            partitioned = True
        elif self.join_distribution == "BROADCAST":
            partitioned = False
            dist, dsource = "broadcast", "session"
        elif self.join_distribution == "PARTITIONED":
            partitioned = can_partition
            if partitioned:
                dist, dsource = "partitioned", "session"
        else:
            # a build history knows spilled must not be replicated: a
            # copy per probe task of something that already overflowed
            # one task's memory is strictly worse than partitioning it
            partitioned = can_partition and (
                right_rows > self.broadcast_threshold
                or spill is not None)
            if can_partition:
                dist = "partitioned" if partitioned else "broadcast"
                dsource = "hbo" if (bstats.source == "hbo"
                                    or (partitioned and spill is not None)
                                    ) else "connector"
                if self._stats_conn is not None:
                    conn_rows = self._stats_conn.stats(
                        node.right).row_count
                    if (conn_rows > self.broadcast_threshold) \
                            != partitioned \
                            and self.hbo.store is not None:
                        self.hbo.store.note_plan_flip("distribution")
        if partitioned:
            if ldist != _hash(lkeys):
                left = ExchangeNode(left, "hash", lkeys)
            if rdist != _hash(rkeys):
                right = ExchangeNode(right, "hash", rkeys)
            out_dist = _hash(lkeys)
        else:
            # broadcast (or probe is single anyway): build side
            # replicated to every probe task
            if ldist in (SINGLE, ANY):
                right = self._to_single(right, rdist)
                dist = dsource = None  # no distribution choice was made
            else:
                right = ExchangeNode(right, "broadcast", [])
        if not partitioned:
            out_dist = ldist
        out = JoinNode(node.join_type, left, right, node.criteria,
                       node.filter_expr, node.strategy,
                       node.strategy_detail)
        if dist is not None:
            # plain attrs (the est_rows pattern): ride to EXPLAIN and
            # the history decision-node walk without moving the node's
            # fingerprint
            out.distribution, out.distribution_source = dist, dsource
        return out, out_dist

    def _v_CrossJoinNode(self, node: CrossJoinNode):
        left, ldist = self.visit(node.left)
        right, rdist = self.visit(node.right)
        if ldist not in (SINGLE, ANY):
            right = ExchangeNode(right, "broadcast", [])
        else:
            right = self._to_single(right, rdist)
        return CrossJoinNode(left, right), ldist

    def _v_WindowNode(self, node):
        from .plan import WindowNode

        src, dist = self.visit(node.source)
        if not node.partition_by:
            src, dist = self._to_single(src, dist), SINGLE
        elif dist not in (SINGLE, ANY) and \
                dist != _hash(node.partition_by):
            src = ExchangeNode(src, "hash", list(node.partition_by))
            dist = _hash(node.partition_by)
        return WindowNode(src, node.partition_by, node.orderings,
                          node.functions), dist

    def _v_TopNRankingNode(self, node):
        """partial (truncate per task, bounding the exchange to
        groups*max_rank rows) -> hash exchange on the partition keys ->
        final re-rank (reference: the TopNRankingNode distribution in
        AddExchanges + PushPartialTopNRankingThroughExchange)."""
        from dataclasses import replace as _replace

        from .plan import TopNRankingNode

        src, dist = self.visit(node.source)
        if dist in (SINGLE, ANY) or (
                node.partition_by and dist == _hash(node.partition_by)):
            return _replace(node, source=src), dist
        partial = TopNRankingNode(src, node.partition_by,
                                  node.orderings, node.ranking,
                                  node.max_rank, node.rank_symbol,
                                  step="partial")
        if node.partition_by:
            ex = ExchangeNode(partial, "hash", list(node.partition_by))
            final_dist = _hash(node.partition_by)
        else:
            ex = ExchangeNode(partial, "single", [])
            final_dist = SINGLE
        final = TopNRankingNode(ex, node.partition_by, node.orderings,
                                node.ranking, node.max_rank,
                                node.rank_symbol, step="final")
        return final, final_dist

    def _v_TopNNode(self, node: TopNNode):
        src, dist = self.visit(node.source)
        if dist in (SINGLE, ANY):
            return TopNNode(src, node.orderings, node.count), dist
        partial = TopNNode(src, node.orderings, node.count)
        ex = ExchangeNode(partial, "single", [])
        return TopNNode(ex, node.orderings, node.count), SINGLE

    def _v_SortNode(self, node: SortNode):
        """Distributed ORDER BY: each task sorts its partition, the
        merge exchange gathers the sorted runs and the consumer k-way
        merges — no full gather-then-resort (reference:
        operator/MergeOperator.java + LocalMergeSourceOperator and the
        mergingExchange of AddExchanges)."""
        src, dist = self.visit(node.source)
        if dist in (SINGLE, ANY):
            return SortNode(src, node.orderings), SINGLE
        partial = SortNode(src, node.orderings)
        ex = ExchangeNode(partial, "merge", [],
                          orderings=list(node.orderings))
        return ex, SINGLE

    def _v_LimitNode(self, node: LimitNode):
        src, dist = self.visit(node.source)
        if dist in (SINGLE, ANY):
            return LimitNode(src, node.count, node.offset), dist
        if node.count is not None:
            # per-task pre-limit (count+offset rows suffice), then final
            src = LimitNode(src, node.count + node.offset, 0)
        ex = ExchangeNode(src, "single", [])
        return LimitNode(ex, node.count, node.offset), SINGLE

    def _v_TableWriterNode(self, node):
        """Scaled writers: the writer runs in the SOURCE's distribution
        (one sink per task), per-task rowcounts gather to a single stage
        that sums them into the statement's row count (reference:
        TableWriterNode staying in the source stage +
        TableFinishNode.java summing fragments)."""
        from .plan import TableWriterNode

        src, dist = self.visit(node.source)
        if self.scale_writers and dist not in (SINGLE, ANY) \
                and src.output_symbols:
            # scaled writers: repartition rows to the writer tasks
            # through a REBALANCING hash boundary — the leading output
            # column stands in for the connector's partition columns
            # (this engine's tables carry none), and the exchanger
            # re-assigns hot logical partitions across writer lanes by
            # observed load (reference: SCALED_WRITER_HASH_DISTRIBUTION
            # in AddExchanges + ScaleWriterPartitioningExchanger)
            keys = [src.output_symbols[0]]
            src = ExchangeNode(src, "hash", keys, scale_writers=True)
            dist = _hash(keys)
        writer = TableWriterNode(src, node.catalog, node.schema,
                                 node.table_name, node.columns,
                                 node.rows_symbol, node.create)
        if dist in (SINGLE, ANY):
            return writer, SINGLE
        ex = ExchangeNode(writer, "single", [])
        from .plan import Aggregation, AggregationNode

        total = AggregationNode(
            ex, [], [(node.rows_symbol,
                      Aggregation("sum", node.rows_symbol))], "single")
        return total, SINGLE

    def _v_UnionNode(self, node: UnionNode):
        inputs = [self._to_single(*self.visit(s)) for s in node.inputs]
        return UnionNode(node.symbols, inputs), SINGLE

    def _v_IntersectNode(self, node: IntersectNode):
        inputs = [self._to_single(*self.visit(s)) for s in node.inputs]
        return IntersectNode(node.symbols, inputs), SINGLE

    def _v_ExceptNode(self, node: ExceptNode):
        inputs = [self._to_single(*self.visit(s)) for s in node.inputs]
        return ExceptNode(node.symbols, inputs), SINGLE


def add_exchanges(root: OutputNode, metadata: Metadata,
                  allocator: SymbolAllocator,
                  broadcast_threshold: float = BROADCAST_THRESHOLD,
                  join_distribution: str = "AUTOMATIC",
                  scale_writers: bool = False,
                  hbo=None) -> OutputNode:
    return ExchangePlanner(metadata, allocator, broadcast_threshold,
                           join_distribution, scale_writers,
                           hbo=hbo).run(root)
