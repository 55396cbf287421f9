"""Plan optimizer: the load-bearing passes.

Reference analog: ``sql/planner/PlanOptimizers.java`` assembles ~90 passes
(221 iterative rules); the ones that move TPC-H/TPC-DS are realized here
directly as recursive rewrites:
- predicate pushdown (``optimizations/PredicatePushDown.java``)
- implicit-join elimination + greedy join ordering by connector stats
  (``iterative/rule/ReorderJoins.java`` — full cost-based DP there,
  size-greedy here; build side = smaller estimated input, matching the
  reference's broadcast/partitioned build-side choice)
- column pruning (``iterative/rule/PruneUnreferencedOutputs`` family)
- identity-projection removal (``RemoveRedundantIdentityProjections``)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import types as T
from ..expr.ir import Call, Literal, RowExpression
from .logical_planner import (Metadata, combine_conjuncts, conjuncts)
from .plan import (AggregationNode, CrossJoinNode, DistinctNode,
                   EnforceSingleRowNode, ExceptNode, FilterNode,
                   IntersectNode, JoinNode, LimitNode, OutputNode, PlanNode,
                   ProjectNode, SortNode, TableScanNode, TopNNode, UnionNode,
                   ValuesNode)
from .symbols import (Symbol, SymbolAllocator, SymbolRef, referenced_symbols,
                      rewrite_symbols)


DEFAULT_ROWS = 1_000_000.0
FILTER_SELECTIVITY = 0.33


def optimize(root: OutputNode, metadata: Metadata,
             allocator: SymbolAllocator, session=None,
             hbo=None) -> OutputNode:
    """The optimizer pipeline: the memo-based iterative rule engine
    (predicate/limit pushdown, scan negotiation, cost-based join
    reordering — planner/memo.py + planner/rules.py), then the ordered
    column-pruning/cleanup passes (the reference also runs
    PruneUnreferencedOutputs-style passes outside exploration).
    ``hbo`` (telemetry.stats_store.HboContext) feeds recorded runtime
    actuals into the cost-based rules — join-order exploration
    (``hbo_reorder_joins_enabled``) and the kernel-strategy rules all
    price through ONE shared node-memoized StatsCalculator per run;
    history beats connector estimates."""
    from .. import session_properties as SP
    from .memo import IterativeOptimizer
    from .rules import default_rules
    from .stats import StatsCalculator

    reorder_hbo = hbo
    if hbo is not None and session is not None and \
            not SP.value(session, "hbo_reorder_joins_enabled"):
        reorder_hbo = None
    calc = StatsCalculator(metadata, history=reorder_hbo)
    engine = IterativeOptimizer(default_rules(), metadata, allocator,
                                session, hbo=reorder_hbo, stats=calc)
    node = engine.optimize(root.source)
    opt = Optimizer(metadata, allocator, session)
    node = opt.prune(node, {s.name for s in root.outputs})
    node = opt.cleanup(node)
    out = OutputNode(node, root.column_names, root.outputs)
    #: rule provenance for EXPLAIN (reference: in the Java engine each
    #: PlanNode carries its source rule via PlanNodeIdAllocator tags)
    out.optimizer_trace = list(engine.trace)
    # kernel-strategy annotation runs LAST: the choices must land on
    # the final plan nodes the local planner and EXPLAIN read.  It
    # shares the run's calculator when the history views agree (they
    # only diverge when hbo_reorder_joins_enabled gated reordering off)
    out.optimizer_trace += annotate_kernel_strategies(
        node, metadata, session, hbo=hbo,
        calc=calc if reorder_hbo is hbo else None)
    slots = template_param_slots(out)
    if slots:
        out.optimizer_trace.append((
            "PlanTemplate",
            "%d opaque parameter slot%s; folding/pushdown value-blind"
            % (len(slots), "" if len(slots) == 1 else "s")))
    return out


def template_param_slots(root: PlanNode) -> Tuple[int, ...]:
    """The sorted ``ParamRef`` slot indices reachable from any
    expression of the plan (empty for non-template plans).  The
    optimizer itself never needs this — ParamRef is opaque to every
    value-reading pass BY CONSTRUCTION (it is not a Literal subclass,
    and folding/pushdown/domain translation are all
    ``isinstance(_, Literal)``-gated) — but the runner's batch
    assembler and EXPLAIN both want to know which slots survived into
    the optimized plan, and a slot that was optimized AWAY (pruned
    with its projection) is exactly the "params_unconsumed" batching
    fallback."""
    from ..expr.ir import param_indices

    slots: Set[int] = set()
    seen: Set[int] = set()
    plan_mod = PlanNode.__module__

    def walk_value(v):
        if isinstance(v, RowExpression):
            slots.update(param_indices(v))
        elif isinstance(v, dict):
            for x in v.values():
                walk_value(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk_value(x)
        elif isinstance(v, PlanNode):
            walk_node(v)
        elif type(v).__module__ == plan_mod and hasattr(v, "__dict__"):
            # expression-bearing leaf specs (Aggregation, Ordering,
            # WindowFunctionSpec, ...) — same module, not PlanNodes
            for x in vars(v).values():
                walk_value(x)

    def walk_node(node):
        if node is None or id(node) in seen:
            return
        seen.add(id(node))
        for v in vars(node).values():
            walk_value(v)

    walk_node(root)
    return tuple(sorted(slots))


def provenance_lines(root: OutputNode) -> List[str]:
    """Rule-application provenance for EXPLAIN output (dedup'd, with
    counts and the ReorderJoins order detail)."""
    trace = getattr(root, "optimizer_trace", None)
    if not trace:
        return []
    lines = ["Optimizer rules applied:"]
    seen: Dict[str, int] = {}
    details: Dict[str, str] = {}
    for name, detail in trace:
        seen[name] = seen.get(name, 0) + 1
        if detail:
            details[name] = detail
    for name, count in seen.items():
        suffix = f" x{count}" if count > 1 else ""
        d = f"  [{details[name]}]" if name in details else ""
        lines.append(f"  {name}{suffix}{d}")
    return lines


class Optimizer:
    def __init__(self, metadata: Metadata, allocator: SymbolAllocator,
                 session=None):
        self.metadata = metadata
        self.allocator = allocator
        if session is None:
            self.filter_pushdown = True
        else:
            from .. import session_properties as SP

            self.filter_pushdown = SP.value(session,
                                            "filter_pushdown_enabled")

    # ------------------------------------------------------------------
    # column pruning

    def prune(self, node: PlanNode, required: Set[str]) -> PlanNode:
        if isinstance(node, ProjectNode):
            kept = [(s, e) for s, e in node.assignments
                    if s.name in required]
            if not kept:
                kept = node.assignments[:1]
            need = set()
            for _, e in kept:
                need |= referenced_symbols(e)
            src = self.prune(node.source, need)
            return ProjectNode(src, kept)

        if isinstance(node, FilterNode):
            need = required | referenced_symbols(node.predicate)
            return FilterNode(self.prune(node.source, need), node.predicate)

        if isinstance(node, TableScanNode):
            kept = [(s, c) for s, c in node.assignments
                    if s.name in required]
            if not kept:
                kept = node.assignments[:1]
            return TableScanNode(node.catalog, node.table, kept)

        if isinstance(node, JoinNode):
            need = set(required)
            for l, r in node.criteria:
                need.add(l.name)
                need.add(r.name)
            if node.filter_expr is not None:
                need |= referenced_symbols(node.filter_expr)
            left_syms = {s.name for s in node.left.output_symbols}
            right_syms = {s.name for s in node.right.output_symbols}
            left = self.prune(node.left, need & left_syms)
            right = self.prune(node.right, need & right_syms)
            return JoinNode(node.join_type, left, right, node.criteria,
                            node.filter_expr)

        if isinstance(node, CrossJoinNode):
            left_syms = {s.name for s in node.left.output_symbols}
            right_syms = {s.name for s in node.right.output_symbols}
            return CrossJoinNode(self.prune(node.left, required & left_syms),
                                 self.prune(node.right,
                                            required & right_syms))

        if isinstance(node, AggregationNode):
            kept_aggs = [(s, a) for s, a in node.aggregations
                         if s.name in required]
            if not kept_aggs and not node.group_keys:
                kept_aggs = node.aggregations[:1]
            need = {s.name for s in node.group_keys}
            for _, a in kept_aggs:
                if a.argument is not None:
                    need.add(a.argument.name)
            src = self.prune(node.source, need)
            return AggregationNode(src, node.group_keys, kept_aggs,
                                   node.step)

        if isinstance(node, (SortNode, TopNNode)):
            need = required | {o.symbol.name for o in node.orderings}
            src = self.prune(node.sources[0], need)
            return _replace_source(node, src)

        from .plan import TopNRankingNode

        if isinstance(node, TopNRankingNode):
            need = (required - {node.rank_symbol.name}) \
                | {s.name for s in node.partition_by} \
                | {o.symbol.name for o in node.orderings}
            src_syms = {s.name for s in node.source.output_symbols}
            src = self.prune(node.source, need & src_syms)
            return TopNRankingNode(src, node.partition_by,
                                   node.orderings, node.ranking,
                                   node.max_rank, node.rank_symbol,
                                   node.step)

        from .plan import WindowNode

        if isinstance(node, WindowNode):
            kept = [(s, f) for s, f in node.functions
                    if s.name in required]
            src_syms = {s.name for s in node.source.output_symbols}
            need = (required & src_syms) \
                | {s.name for s in node.partition_by} \
                | {o.symbol.name for o in node.orderings} \
                | {f.argument.name for _, f in kept
                   if f.argument is not None}
            src = self.prune(node.source, need)
            if not kept:
                return src
            return WindowNode(src, node.partition_by, node.orderings,
                              kept)

        if isinstance(node, (DistinctNode, IntersectNode, ExceptNode,
                             UnionNode, ValuesNode, EnforceSingleRowNode)):
            # set-semantics nodes need all their columns
            new_sources = [self.prune(s, {x.name for x in s.output_symbols})
                           for s in node.sources]
            return _replace_sources(node, new_sources)

        if isinstance(node, LimitNode):
            return LimitNode(self.prune(node.source, required), node.count,
                             node.offset)

        new_sources = [self.prune(s, {x.name for x in s.output_symbols})
                       for s in node.sources]
        return _replace_sources(node, new_sources)

    # ------------------------------------------------------------------

    def cleanup(self, node: PlanNode) -> PlanNode:
        """Remove identity projections; merge Filter(Filter)."""
        new_sources = [self.cleanup(s) for s in node.sources]
        node = _replace_sources(node, new_sources)
        if isinstance(node, ProjectNode):
            src = node.source
            src_syms = [s.name for s in src.output_symbols]
            if [s.name for s, _ in node.assignments] == src_syms and all(
                    isinstance(e, SymbolRef) and e.name == s.name
                    for s, e in node.assignments):
                return src
            # merge Project(Project) by inlining
            if isinstance(src, ProjectNode):
                mapping = {s.name: e for s, e in src.assignments}
                merged = [(s, rewrite_symbols(e, mapping))
                          for s, e in node.assignments]
                return ProjectNode(src.source, merged)
        if isinstance(node, FilterNode) and isinstance(node.source,
                                                       FilterNode):
            inner = node.source
            pred = combine_conjuncts(conjuncts(node.predicate)
                                     + conjuncts(inner.predicate))
            return FilterNode(inner.source, pred)
        return node


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# kernel-strategy cost rules: MXU matmul join + global-hash aggregation
# ("Density-optimized ... Matrix Multiplication for Join-Project" and
# "Global Hash Tables Strike Back!", PAPERS.md).  ONE decision path for
# the planner annotation, the session-property overrides, and the
# device-mesh runtime (parallel/mesh_query consults choose_agg_strategy
# with its observed group count), so the estimate EXPLAIN shows is the
# estimate that executed.


#: the matmul join operator's f32-exactness bound on build rows (one-hot
#: f32 matmul counts stay exact below 2^24); the port has no matmul join
#: operator yet, so the cost model keeps its own copy of the constant
MAX_BUILD_ROWS = 1 << 24


def _matmul_max_build_rows() -> int:
    return MAX_BUILD_ROWS


def choose_join_strategy(node: "JoinNode", calc, override: str,
                         max_range: int,
                         will_spill: bool = False) -> Tuple[str, str]:
    """('sorted-index' | 'matmul', detail).  The matmul probe wins when
    the build key domain maps densely onto a small one-hot width: one
    integer-ish (or dictionary-coded) equi key whose estimated range —
    value span for integers, pool size ≈ NDV for strings — fits
    ``max_range``, over a confidently-small build.  Everything else
    keeps the sorted-index probe.  The operator re-checks the ACTUAL
    range at build time and falls back, so a forced 'MATMUL' override
    is safe on any join.

    ``will_spill`` is the HBO-fed memory-pressure input: this node's
    build spilled partitions on its last run, so a denser encoding
    that avoids materializing the sorted index is worth 4x the normal
    one-hot width (the matmul table is O(key range), not O(build
    rows) — it sidesteps the partition machinery entirely)."""
    if override == "SORTED_INDEX":
        return "sorted-index", "forced by join_strategy"
    if override == "MATMUL":
        return "matmul", "forced by join_strategy"
    if node.join_type not in ("inner", "semi", "anti") \
            or len(node.criteria) != 1:
        return "sorted-index", ""
    eff_range = max_range * (4 if will_spill else 1)
    spill_note = ", build will spill (hbo)" if will_spill else ""
    right = calc.stats(node.right)
    if not right.confident or right.row_count > _matmul_max_build_rows():
        return "sorted-index", ""
    _l, r = node.criteria[0]
    rs = right.symbol(r.name)
    t = r.type
    if getattr(t, "is_pooled", False):
        # dictionary codes ARE the dense domain; pool size ~ NDV
        if rs.distinct_count is None or rs.distinct_count > eff_range:
            return "sorted-index", ""
        detail = (f"build~{right.row_count:.0f} rows, pool~"
                  f"{rs.distinct_count:.0f} codes <= {eff_range}, "
                  f"source={right.source}{spill_note}")
        return "matmul", detail
    storage = getattr(t, "storage", None)
    import numpy as _np

    if storage is None or _np.dtype(storage).kind not in "iub":
        return "sorted-index", ""  # float/decimal-free zone: ints only
    if rs.low is None or rs.high is None or rs.low < 0:
        # the equality u64 encoding is range-contiguous only for
        # non-negative keys (no sign bias); stats-unknown ranges stay
        # on the sorted index
        return "sorted-index", ""
    key_range = rs.high - rs.low + 1
    if key_range > eff_range:
        return "sorted-index", ""
    detail = (f"build~{right.row_count:.0f} rows, key range "
              f"{key_range:.0f} <= {eff_range}, "
              f"source={right.source}{spill_note}")
    return "matmul", detail


def choose_agg_strategy(ndv_estimate: float, n_devices: int = 1,
                        override: str = "AUTOMATIC",
                        max_table: Optional[int] = None,
                        source: str = "observed") -> Tuple[str, str]:
    """('exchange' | 'global-hash', detail).  The global-hash table is
    replicated per device and merged by collective scatter-add, so it
    wins exactly when 2x the group-count bound (load factor <= 0.5)
    stays small — below ``global_hash_agg_max_table`` slots; past that
    the all_to_all of partial groups moves fewer bytes than the table
    all-reduce.  Shared verbatim by the planner annotation (which
    passes the estimate's ``source`` — connector stats vs recorded
    history) and the mesh runtime (which calls it with stage 1's
    OBSERVED group count, the default source label)."""
    if max_table is None:
        from .. import session_properties as SP

        max_table = SP.prop_value({}, "global_hash_agg_max_table")
    if override == "EXCHANGE":
        return "exchange", "forced by aggregation_strategy"
    if override == "GLOBAL_HASH":
        return "global-hash", "forced by aggregation_strategy"
    table = 2 * max(int(ndv_estimate), 1)
    if table <= max_table:
        return "global-hash", (f"~{ndv_estimate:.0f} groups -> table "
                               f"{table} <= {max_table} over "
                               f"{n_devices} device(s), "
                               f"source={source}")
    return "exchange", (f"~{ndv_estimate:.0f} groups -> table {table} "
                        f"> {max_table}, source={source}")


def annotate_kernel_strategies(node: PlanNode, metadata: Metadata,
                               session=None, hbo=None,
                               calc=None) -> List[tuple]:
    """Post-optimization pass: stamp every JoinNode with the probe
    strategy and every grouped AggregationNode with the merge shape the
    cost model picks, honoring the session overrides.  ``hbo`` feeds
    recorded per-node actuals into the StatsCalculator, so observed
    build-side cardinality and live group counts beat connector
    guesses; every node additionally carries ``est_rows``/``est_source``
    so EXPLAIN can annotate where each estimate came from.  Returns
    (rule, detail) trace entries for EXPLAIN's provenance block."""
    from .. import session_properties as SP
    from .stats import StatsCalculator

    if session is not None:
        join_override = SP.value(session, "join_strategy")
        agg_override = SP.value(session, "aggregation_strategy")
        max_range = SP.value(session, "matmul_join_max_key_range")
        max_table = SP.value(session, "global_hash_agg_max_table")
    else:
        join_override = agg_override = "AUTOMATIC"
        max_range = SP.prop_value({}, "matmul_join_max_key_range")
        max_table = SP.prop_value({}, "global_hash_agg_max_table")
    if calc is None:
        calc = StatsCalculator(metadata, history=hbo)
    trace: List[tuple] = []

    def walk(n: PlanNode):
        for s in n.sources:
            walk(s)
        if hbo is not None:
            st = calc.stats(n)
            n.est_rows, n.est_source = st.row_count, st.source
        if isinstance(n, JoinNode):
            spill_hint = hbo.spill_hint(hbo.fp(n)) \
                if hbo is not None else None
            strat, detail = choose_join_strategy(
                n, calc, join_override, max_range,
                will_spill=bool(spill_hint))
            n.strategy, n.strategy_detail = strat, detail
            if strat == "matmul":
                trace.append(("MatmulJoinStrategy", detail))
            if spill_hint is not None:
                # plain attribute (like est_rows): rides to the local
                # planner without touching the node's fingerprint, so
                # the second run sizes its partition fan-out from the
                # first run's observed spill
                n.hybrid_hint = dict(spill_hint)
                trace.append(("HybridJoinFanout",
                              f"fanout={spill_hint.get('fanout')} "
                              f"fraction={spill_hint.get('fraction')} "
                              f"source=hbo"))
        elif isinstance(n, AggregationNode) and n.group_keys:
            st = calc.stats(n)
            if not st.confident and agg_override == "AUTOMATIC":
                # no trustworthy group-count estimate: keep the
                # exchange shape rather than stamping a detail derived
                # from the DEFAULT_ROWS placeholder (the join rule
                # gates on confidence the same way)
                n.strategy, n.strategy_detail = "exchange", ""
                return
            strat, detail = choose_agg_strategy(st.row_count, 1,
                                                agg_override, max_table,
                                                source=st.source)
            n.strategy, n.strategy_detail = strat, detail
            if strat == "global-hash":
                trace.append(("GlobalHashAggStrategy", detail))

    walk(node)
    return trace


def _apply(node: PlanNode, preds: Sequence[RowExpression]) -> PlanNode:
    pred = combine_conjuncts(list(preds))
    if pred is None:
        return node
    return FilterNode(node, pred)


def _replace_source(node: PlanNode, src: PlanNode) -> PlanNode:
    return _replace_sources(node, [src])


#: fingerprint-neutral annotation attrs stamped onto final plan nodes
#: (annotate_kernel_strategies, ExchangePlanner's distribution choice);
#: a structural rebuild must carry them or the fragmenter would strip
#: EXPLAIN provenance from every node above an exchange cut
_ANNOTATION_ATTRS = ("est_rows", "est_source", "distribution",
                     "distribution_source")


def _replace_sources(node: PlanNode, sources: List[PlanNode]) -> PlanNode:
    out = _rebuild_with_sources(node, sources)
    if out is not node:
        for attr in _ANNOTATION_ATTRS:
            v = getattr(node, attr, None)
            if v is not None:
                setattr(out, attr, v)
    return out


def _rebuild_with_sources(node: PlanNode,
                          sources: List[PlanNode]) -> PlanNode:
    if isinstance(node, FilterNode):
        return FilterNode(sources[0], node.predicate)
    if isinstance(node, ProjectNode):
        return ProjectNode(sources[0], node.assignments)
    if isinstance(node, AggregationNode):
        return AggregationNode(sources[0], node.group_keys,
                               node.aggregations, node.step,
                               node.state_symbols, node.strategy,
                               node.strategy_detail)
    if isinstance(node, JoinNode):
        return JoinNode(node.join_type, sources[0], sources[1],
                        node.criteria, node.filter_expr, node.strategy,
                        node.strategy_detail)
    if isinstance(node, CrossJoinNode):
        return CrossJoinNode(sources[0], sources[1])
    if isinstance(node, SortNode):
        return SortNode(sources[0], node.orderings)
    if isinstance(node, TopNNode):
        return TopNNode(sources[0], node.orderings, node.count)
    if isinstance(node, LimitNode):
        return LimitNode(sources[0], node.count, node.offset)
    if isinstance(node, DistinctNode):
        return DistinctNode(sources[0])
    if isinstance(node, EnforceSingleRowNode):
        return EnforceSingleRowNode(sources[0])
    if isinstance(node, UnionNode):
        return UnionNode(node.symbols, sources)
    if isinstance(node, IntersectNode):
        return IntersectNode(node.symbols, sources)
    if isinstance(node, ExceptNode):
        return ExceptNode(node.symbols, sources)
    if isinstance(node, OutputNode):
        return OutputNode(sources[0], node.column_names, node.outputs)
    from .plan import (ExchangeNode, RemoteSourceNode, TableWriterNode,
                       TopNRankingNode, UnnestNode, WindowNode)

    if isinstance(node, WindowNode):
        return WindowNode(sources[0], node.partition_by, node.orderings,
                          node.functions)
    if isinstance(node, TopNRankingNode):
        return TopNRankingNode(sources[0], node.partition_by,
                               node.orderings, node.ranking,
                               node.max_rank, node.rank_symbol,
                               node.step)
    if isinstance(node, UnnestNode):
        return UnnestNode(sources[0], node.array_symbols,
                          node.element_symbols, node.ordinality_symbol)
    if isinstance(node, TableWriterNode):
        return TableWriterNode(sources[0], node.catalog, node.schema,
                               node.table_name, node.columns,
                               node.rows_symbol, node.create)
    if isinstance(node, ExchangeNode):
        return ExchangeNode(sources[0], node.kind, node.keys,
                            node.orderings)
    if isinstance(node, (TableScanNode, ValuesNode, RemoteSourceNode)):
        return node
    raise AssertionError(f"unknown node {type(node).__name__}")
