"""Local execution planner: PlanNode tree -> operator pipelines on torch.

Reference analog: ``sql/planner/LocalExecutionPlanner.java``: the visitor
that turns a plan fragment into DriverFactories, fixing the physical
channel layout of every pipeline and compiling expressions.

The torch engine plans every node of a one-device query: TableScan (with
dynamic filters), Values, Filter, Project, Unnest, Aggregation, Distinct,
Join (sorted-index and matmul strategies), cross join, the set operations
(UNION [ALL], INTERSECT, EXCEPT), EnforceSingleRow (scalar subqueries),
Sort, TopN, TopNRanking (grouped top-N), Window, Limit/Offset and Output.
Table writers and remote sources (distribution) raise NOT_SUPPORTED.
Union inputs and join build sides run as pipelines before their
consumers, in list order, as in the JAX engine.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..block import Page
from ..expr.compiler import PageProcessor
from ..expr.ir import Call, InputRef, Literal, RowExpression
from ..ops.aggregation import AggCall, HashAggregationOperator
from ..ops.join import HashBuilderOperator, JoinBridge, LookupJoinOperator
from ..ops.matmul_join import MatmulJoinOperator
from ..ops.operator import (DeferredPagesSourceOperator,
                            EnforceSingleRowOperator, FilterProjectOperator,
                            LimitOperator, OffsetOperator, Operator,
                            OutputCollectorOperator, TableScanOperator,
                            ValuesOperator)
from ..ops.sort import OrderByOperator, TopNOperator
from ..ops.sortkeys import SortKey
from ..planner.logical_planner import Metadata
from ..planner.plan import (AggregationNode, CrossJoinNode, DistinctNode,
                            EnforceSingleRowNode, ExceptNode, FilterNode,
                            IntersectNode, JoinNode, LimitNode, OutputNode,
                            PlanNode, ProjectNode, SortNode, TableScanNode,
                            TopNNode, UnionNode, ValuesNode)
from ..planner.symbols import Symbol, to_input_refs
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
                 memory_pool=None, join_max_lanes: Optional[int] = None,
                 dynamic_filtering: bool = True,
                 hash_grouping: bool = True,
                 scan_coalesce: bool = True,
                 matmul_max_key_range: int = 1024):
        self.metadata = metadata
        self.device = device
        self.desired_splits = desired_splits
        self.memory_pool = memory_pool
        self.join_max_lanes = join_max_lanes
        self.dynamic_filtering = dynamic_filtering
        #: GROUP BY path: vectorized open-addressing hash table (default)
        #: vs sort-based oracle (``hash_grouping_enabled`` session prop)
        self.hash_grouping = hash_grouping
        #: coalesce split-tail scan pages up to the connector page size
        #: before device upload (``scan_coalesce_enabled``)
        self.scan_coalesce = scan_coalesce
        #: densest key domain the matmul join strategy may one-hot
        #: encode (``matmul_join_max_key_range``) — the operator's
        #: runtime re-check of the cost model's range estimate
        self.matmul_max_key_range = matmul_max_key_range
        self.pipelines: List[PhysicalPipeline] = []
        # scan-node id -> [(channel, DynamicFilter)] attachments
        self._scan_dfs: Dict[int, List] = {}
        self.dynamic_filters: List = []  # all filters, for query stats

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
                                 dynamic_filters=self._scan_dfs.pop(
                                     id(node), []),
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

    def _v_UnnestNode(self, node):
        from ..ops.unnest import UnnestOperator

        ops, layout, types_ = self.visit(node.source)
        arr_chans = [layout[s.name] for s in node.array_symbols]
        el_types = [s.type for s in node.element_symbols]
        ops.append(UnnestOperator(types_, arr_chans, el_types,
                                  node.ordinality_symbol is not None))
        out_layout = dict(layout)
        out_types = list(types_)
        extra = list(node.element_symbols)
        if node.ordinality_symbol is not None:
            extra.append(node.ordinality_symbol)
        for s in extra:
            out_layout[s.name] = len(out_types)
            out_types.append(s.type)
        return ops, out_layout, out_types

    def _v_JoinNode(self, node: JoinNode):
        return self._plan_join(node.join_type, node.left, node.right,
                               node.criteria, node.filter_expr,
                               node.strategy, node.strategy_detail)

    def _v_CrossJoinNode(self, node: CrossJoinNode):
        # const-key equi join (build side replicated once)
        return self._plan_join("inner", node.left, node.right, [], None)

    def _plan_join(self, join_type: str, left: PlanNode, right: PlanNode,
                   criteria: List[Tuple[Symbol, Symbol]],
                   filter_expr: Optional[RowExpression],
                   strategy: str = "sorted-index",
                   strategy_detail: str = ""):
        build_dfs = []
        if self.dynamic_filtering:
            from .dynamic_filter import plan_dynamic_filters

            # register BEFORE visiting the probe side so its TableScan
            # picks the filters up; the build pipeline runs first, so
            # domains are complete before the first probe page scans
            build_dfs = plan_dynamic_filters(self, left, criteria,
                                             join_type)
        bops, blayout, btypes = self.visit(right)
        pops, playout, ptypes = self.visit(left)

        if not criteria:
            # const key: append a literal-0 key channel to both sides
            bops.append(self._fp_operator(
                btypes, [InputRef(t, i) for i, t in enumerate(btypes)]
                + [Literal(T.BIGINT, 0)]))
            btypes = btypes + [T.BIGINT]
            pops.append(self._fp_operator(
                ptypes, [InputRef(t, i) for i, t in enumerate(ptypes)]
                + [Literal(T.BIGINT, 0)]))
            ptypes = ptypes + [T.BIGINT]
            build_keys = [len(btypes) - 1]
            probe_keys = [len(ptypes) - 1]
        else:
            # string keys are fine: the probe remaps its dictionary codes
            # into the build's pool (LookupJoinOperator._remap)
            probe_keys = [playout[lsym.name] for lsym, _ in criteria]
            build_keys = [blayout[rsym.name] for _, rsym in criteria]

        bridge = JoinBridge()
        bops.append(HashBuilderOperator(
            btypes, build_keys, bridge, self.device,
            memory_context=self._mem_ctx("join-build"),
            dynamic_filters=[(blayout[rs.name], df)
                             for rs, df in build_dfs]))
        self.pipelines.append(PhysicalPipeline(bops))

        filter_fn = None
        if filter_expr is not None:
            combined_layout = dict(playout)
            for name, ch in blayout.items():
                combined_layout[name] = len(ptypes) + ch
            combined_types = ptypes + btypes
            proc = PageProcessor(
                combined_types,
                [InputRef(t, i) for i, t in enumerate(combined_types)],
                to_input_refs(filter_expr, combined_layout))
            filter_fn = proc.process

        if strategy == "matmul":
            # the cost model picked the blocked one-hot matmul probe;
            # the operator re-checks the actual key range per build and
            # takes the sorted index otherwise (reason in its metrics)
            pops.append(MatmulJoinOperator(
                ptypes, probe_keys, bridge, join_type, filter_fn,
                max_lanes=self.join_max_lanes,
                max_key_range=self.matmul_max_key_range,
                strategy_detail=strategy_detail))
        else:
            pops.append(LookupJoinOperator(
                ptypes, probe_keys, bridge, join_type, filter_fn,
                max_lanes=self.join_max_lanes))
        out_layout = dict(playout)
        out_types = ptypes
        if join_type not in ("semi", "anti"):
            for name, ch in blayout.items():
                out_layout[name] = len(ptypes) + ch
            out_types = ptypes + btypes
        return pops, out_layout, out_types

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

    def _v_DistinctNode(self, node: DistinctNode):
        ops, layout, types_ = self.visit(node.source)
        order = sorted(layout.items(), key=lambda kv: kv[1])
        ops.append(HashAggregationOperator(
            types_, [ch for _, ch in order], [], self.device,
            memory_context=self._mem_ctx("distinct"),
            hash_grouping=self.hash_grouping))
        new_layout = {name: i for i, (name, _) in enumerate(order)}
        return ops, new_layout, types_

    def _v_SortNode(self, node: SortNode):
        ops, layout, types_ = self.visit(node.source)
        keys = _sort_keys(node.orderings, layout)
        ops.append(OrderByOperator(types_, keys,
                                   memory_context=self._mem_ctx("sort")))
        return ops, layout, types_

    def _v_TopNNode(self, node: TopNNode):
        ops, layout, types_ = self.visit(node.source)
        keys = _sort_keys(node.orderings, layout)
        ops.append(TopNOperator(types_, keys, node.count))
        return ops, layout, types_

    def _v_LimitNode(self, node: LimitNode):
        ops, layout, types_ = self.visit(node.source)
        if node.offset:
            ops.append(OffsetOperator(node.offset))
        if node.count is not None:
            ops.append(LimitOperator(node.count))
        return ops, layout, types_

    def _v_EnforceSingleRowNode(self, node: EnforceSingleRowNode):
        ops, layout, types_ = self.visit(node.source)
        ops.append(EnforceSingleRowOperator(types_, self.device))
        return ops, layout, types_

    def _v_UnionNode(self, node: UnionNode):
        collectors = []
        for child in node.inputs:
            cops, clayout, ctypes = self.visit(child)
            # project to union symbol order
            projections = [InputRef(s.type, clayout[cs.name])
                           for s, cs in zip(node.symbols,
                                            child.output_symbols)]
            cops.append(self._fp_operator(ctypes, projections))
            sink = OutputCollectorOperator()
            cops.append(sink)
            self.pipelines.append(PhysicalPipeline(cops))
            collectors.append(sink)
        types_ = [s.type for s in node.symbols]

        def union_pages(cs=collectors, types_=types_):
            pages = [p for c in cs for p in c.pages]
            if not pages:
                return []
            if any(t.is_string for t in types_):
                # unify dictionary pools across children (Page.concat
                # re-encodes into the first pool)
                return [Page.concat(pages)]
            return pages

        source = DeferredPagesSourceOperator(union_pages, self.device)
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        return [source], layout, types_

    def _v_TopNRankingNode(self, node):
        from ..ops.grouped_topn import GroupedTopNOperator

        ops, layout, types_ = self.visit(node.source)
        pchans = [layout[s.name] for s in node.partition_by]
        keys = _sort_keys(node.orderings, layout)
        ops.append(GroupedTopNOperator(types_, pchans, keys,
                                       node.ranking, node.max_rank,
                                       step=node.step))
        if node.step == "partial":
            return ops, layout, list(types_)
        new_layout = dict(layout)
        new_layout[node.rank_symbol.name] = len(types_)
        return ops, new_layout, list(types_) + [T.BIGINT]

    def _v_WindowNode(self, node):
        from ..ops.window import WindowCall, WindowOperator

        ops, layout, types_ = self.visit(node.source)
        pchans = [layout[s.name] for s in node.partition_by]
        keys = _sort_keys(node.orderings, layout)
        calls = []
        for out_sym, f in node.functions:
            arg_ch = layout[f.argument.name] if f.argument is not None \
                else None
            calls.append(WindowCall(
                f.function, arg_ch,
                f.argument.type if f.argument is not None else None,
                out_sym.type, f.frame_mode, f.offset,
                f.frame_start, f.frame_end))
        ops.append(WindowOperator(types_, pchans, keys, calls))
        new_layout = dict(layout)
        out_types = list(types_)
        for j, (out_sym, _f) in enumerate(node.functions):
            new_layout[out_sym.name] = len(types_) + j
            out_types.append(out_sym.type)
        return ops, new_layout, out_types

    def _v_IntersectNode(self, node: IntersectNode):
        return self._set_semantics_join(node, "semi")

    def _v_ExceptNode(self, node: ExceptNode):
        return self._set_semantics_join(node, "anti")

    def _set_semantics_join(self, node, join_type: str):
        """INTERSECT/EXCEPT = Distinct(left) semi/anti-join right on all
        columns. As in the JAX engine, the join treats NULL keys as
        non-matching where SQL set operations treat NULLs as equal, so
        rows holding NULL differ from SQL there (in both engines)."""
        left, right = node.inputs
        bops, blayout, btypes = self.visit(right)
        pops, playout, ptypes = self.visit(left)
        # align probe/build channel order to symbol order
        bchans = [blayout[s.name] for s in right.output_symbols]
        bridge = JoinBridge()
        bops.append(HashBuilderOperator(
            btypes, bchans, bridge, self.device,
            memory_context=self._mem_ctx("setop-build")))
        self.pipelines.append(PhysicalPipeline(bops))
        pchans = [playout[s.name] for s in left.output_symbols]
        pops.append(LookupJoinOperator(
            ptypes, pchans, bridge, join_type,
            max_lanes=self.join_max_lanes))
        # distinct over the probe columns; output channels follow pchans
        # order, i.e. channel j <-> left.output_symbols[j] <-> symbols[j]
        pops.append(HashAggregationOperator(
            ptypes, pchans, [], self.device,
            memory_context=self._mem_ctx("setop-distinct"),
            hash_grouping=self.hash_grouping))
        layout = {s.name: j for j, s in enumerate(node.symbols)}
        return pops, layout, [ptypes[ch] for ch in pchans]


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
