"""The load-bearing optimizer rules for the iterative engine.

Reference analog: the subset of the ~221 classes under
``sql/planner/iterative/rule/`` that moves TPC-H/TPC-DS:
predicate pushdown (PushDownFilter* family + PredicatePushDown),
PushPredicateIntoTableScan, ReorderJoins (cost-based exploration),
MergeLimits / PushLimitThroughProject / the TopN rewrite,
RemoveRedundantIdentityProjections, InlineProjections, MergeFilters.

Every rule is local: it sees one group's node (children as group
references) and resolves children through the Lookup only when its
pattern needs them — the memo makes the rewrite O(1) in plan size.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .. import types as T
from ..expr.ir import Call, Literal, RowExpression
from .logical_planner import combine_conjuncts, conjuncts
from .memo import GroupReference, Pattern, Rule, RuleContext
from .plan import (AggregationNode, CrossJoinNode, DistinctNode,
                   FilterNode, JoinNode, LimitNode, PlanNode,
                   ProjectNode, SortNode, TableScanNode, TopNNode)
from .symbols import (Symbol, SymbolRef, referenced_symbols,
                      rewrite_symbols)


def _filter(node: PlanNode, preds: List[RowExpression]) -> PlanNode:
    if not preds:
        return node
    return FilterNode(node, combine_conjuncts(preds))


class MergeFilters(Rule):
    """Filter(Filter(x)) -> Filter(x) (reference: MergeFilters.java)."""

    name = "MergeFilters"
    pattern = Pattern(FilterNode).with_source(Pattern(FilterNode))

    def apply(self, node: FilterNode, ctx: RuleContext):
        child = ctx.lookup.resolve(node.source)
        return FilterNode(child.source, combine_conjuncts(
            conjuncts(node.predicate) + conjuncts(child.predicate)))


class PushFilterThroughProject(Rule):
    """Filter(Project) -> Project(Filter) with the assignments inlined
    into the predicate (reference: PushDownFilterThroughProject; safe
    because every scalar here is deterministic)."""

    name = "PushFilterThroughProject"
    pattern = Pattern(FilterNode).with_source(Pattern(ProjectNode))

    def apply(self, node: FilterNode, ctx: RuleContext):
        proj = ctx.lookup.resolve(node.source)
        mapping = {s.name: e for s, e in proj.assignments}
        rewritten = rewrite_symbols(node.predicate, mapping)
        return ProjectNode(FilterNode(proj.source, rewritten),
                           proj.assignments)


class PushFilterThroughAggregation(Rule):
    """Conjuncts over GROUP BY keys move below the aggregation
    (reference: PushPredicateThroughProjectIntoRowNumber's simpler
    cousin PushDownFilterThroughAggregation)."""

    name = "PushFilterThroughAggregation"
    pattern = Pattern(FilterNode).with_source(Pattern(AggregationNode))

    def apply(self, node: FilterNode, ctx: RuleContext):
        agg = ctx.lookup.resolve(node.source)
        keys = {s.name for s in agg.group_keys}
        push, stay = [], []
        for p in conjuncts(node.predicate):
            (push if referenced_symbols(p) <= keys else stay).append(p)
        if not push:
            return None
        new_agg = AggregationNode(_filter(agg.source, push),
                                  agg.group_keys, agg.aggregations,
                                  agg.step, agg.state_symbols)
        return _filter(new_agg, stay)


class PushFilterThroughExchangeLike(Rule):
    """Filter commutes with row-preserving unary nodes: Sort, Distinct
    (all columns are keys). NOT EnforceSingleRow — filtering first
    would turn its one row into zero and fabricate an all-NULL scalar
    (and mask the multiple-rows error). Reference:
    PushDownFilterThroughSort etc."""

    name = "PushFilterThroughSort"
    pattern = Pattern(FilterNode).with_source(
        Pattern((SortNode, DistinctNode)))

    def apply(self, node: FilterNode, ctx: RuleContext):
        child = ctx.lookup.resolve(node.source)
        from .optimizer import _replace_sources

        return _replace_sources(
            child, [FilterNode(child.sources[0], node.predicate)])


class PushFilterThroughOuterJoin(Rule):
    """Probe-side-only conjuncts of a left/semi/anti join move to the
    probe input; FULL joins null-extend both sides, so nothing crosses
    (reference: PredicatePushDown's outer-join handling)."""

    name = "PushFilterThroughOuterJoin"
    pattern = Pattern(FilterNode).with_source(Pattern(
        JoinNode, where=lambda j: j.join_type != "inner"))

    def apply(self, node: FilterNode, ctx: RuleContext):
        join = ctx.lookup.resolve(node.source)
        if join.join_type == "full":
            return None
        left_syms = {s.name for s in join.left.output_symbols}
        push, stay = [], []
        for p in conjuncts(node.predicate):
            (push if referenced_symbols(p) <= left_syms
             else stay).append(p)
        if not push:
            return None
        new_join = JoinNode(join.join_type, _filter(join.left, push),
                            join.right, join.criteria, join.filter_expr)
        return _filter(new_join, stay)


class PushFilterIntoTableScan(Rule):
    """The pushdown negotiation as a rule (reference:
    PushPredicateIntoTableScan.java + ConnectorMetadata.applyFilter):
    extractable conjunct domains are offered to the connector; enforced
    columns drop their conjuncts, the residual stays engine-side."""

    name = "PushFilterIntoTableScan"
    pattern = Pattern(FilterNode).with_source(Pattern(TableScanNode))

    def apply(self, node: FilterNode, ctx: RuleContext):
        scan = ctx.lookup.resolve(node.source)
        got = negotiate_scan_pushdown(ctx.metadata, ctx.session, scan,
                                      conjuncts(node.predicate))
        if got is None:
            return None
        new_scan, kept = got
        return _filter(new_scan, kept)


class MergeLimits(Rule):
    """Limit(Limit) -> one Limit (reference: MergeLimits.java);
    offsets compose by addition under the tighter count."""

    name = "MergeLimits"
    pattern = Pattern(LimitNode).with_source(Pattern(LimitNode))

    def apply(self, node: LimitNode, ctx: RuleContext):
        child = ctx.lookup.resolve(node.source)
        if node.offset or child.offset:
            return None  # offset composition is subtle; keep both
        if node.count is None:
            return LimitNode(child.source, child.count, 0)
        count = node.count if child.count is None \
            else min(node.count, child.count)
        return LimitNode(child.source, count, 0)


class PushLimitThroughProject(Rule):
    """Limit(Project) -> Project(Limit) (reference:
    PushLimitThroughProject.java)."""

    name = "PushLimitThroughProject"
    pattern = Pattern(LimitNode).with_source(Pattern(ProjectNode))

    def apply(self, node: LimitNode, ctx: RuleContext):
        proj = ctx.lookup.resolve(node.source)
        return ProjectNode(LimitNode(proj.source, node.count,
                                     node.offset),
                           proj.assignments)


class LimitOverSortToTopN(Rule):
    """Limit(Sort) -> TopN (reference: CreateTopN rule... the
    MergeLimitWithSort rule): avoids a full sort when only the head is
    needed."""

    name = "LimitOverSortToTopN"
    pattern = Pattern(
        LimitNode,
        where=lambda l: l.count is not None and not l.offset
    ).with_source(Pattern(SortNode))

    def apply(self, node: LimitNode, ctx: RuleContext):
        sort = ctx.lookup.resolve(node.source)
        return TopNNode(sort.source, sort.orderings, node.count)


class RemoveRedundantIdentityProjection(Rule):
    """Project(x) that renames nothing collapses to x (reference:
    RemoveRedundantIdentityProjections.java)."""

    name = "RemoveRedundantIdentityProjection"
    pattern = Pattern(ProjectNode,
                      where=lambda p: p.is_identity())

    def apply(self, node: ProjectNode, ctx: RuleContext):
        return node.source


class InlineProjections(Rule):
    """Project(Project(x)) -> Project(x) with inner assignments inlined
    (reference: InlineProjections.java; safe — scalars here are
    deterministic and inner symbols are not re-exported)."""

    name = "InlineProjections"
    pattern = Pattern(ProjectNode).with_source(Pattern(ProjectNode))

    def apply(self, node: ProjectNode, ctx: RuleContext):
        inner = ctx.lookup.resolve(node.source)
        mapping = {s.name: e for s, e in inner.assignments}
        merged = [(s, rewrite_symbols(e, mapping))
                  for s, e in node.assignments]
        return ProjectNode(inner.source, merged)


class FilterOverWindowToTopNRanking(Rule):
    """A bound on a row_number()/rank() window output lowers the window
    to per-group top-N (reference:
    iterative/rule/PushdownFilterIntoWindow.java producing
    TopNRankingNode): the engine then truncates groups BEFORE the
    exchange instead of materializing whole window partitions. The
    original filter stays above (re-filtering is a no-op) so residual
    conjuncts and exact bounds keep their semantics."""

    name = "FilterOverWindowToTopNRanking"
    pattern = Pattern(FilterNode)

    def apply(self, node: FilterNode, ctx: RuleContext):
        from .plan import TopNRankingNode, WindowNode

        win = ctx.lookup.resolve(node.source)
        if not isinstance(win, WindowNode) or len(win.functions) != 1:
            return None
        out_sym, spec = win.functions[0]
        if spec.function not in ("row_number", "rank") \
                or not win.orderings:
            return None
        bound = None
        for p in conjuncts(node.predicate):
            k = _rank_bound(p, out_sym.name)
            if k is not None:
                bound = k if bound is None else min(bound, k)
        if bound is None or bound < 1:
            return None
        topn = TopNRankingNode(win.source, list(win.partition_by),
                               list(win.orderings), spec.function,
                               bound, out_sym)
        return FilterNode(topn, node.predicate)


def _rank_bound(p, name: str):
    """k such that conjunct p implies rank <= k, else None."""
    from ..expr.ir import Literal as Lit

    if not isinstance(p, Call) or len(p.args) != 2:
        return None
    a, b = p.args
    if isinstance(a, SymbolRef) and a.name == name and isinstance(b, Lit) \
            and isinstance(b.value, int):
        return {"le": b.value, "lt": b.value - 1,
                "eq": b.value}.get(p.name)
    if isinstance(b, SymbolRef) and b.name == name and isinstance(a, Lit) \
            and isinstance(a.value, int):
        return {"ge": a.value, "gt": a.value - 1,
                "eq": a.value}.get(p.name)
    return None


def negotiate_scan_pushdown(metadata, session, scan: TableScanNode,
                            preds: List[RowExpression]
                            ) -> Optional[Tuple[TableScanNode,
                                                List[RowExpression]]]:
    """Offer extractable conjunct domains to the connector; returns
    (new scan, conjuncts to keep) or None when nothing was accepted.
    Shared by the rule and the legacy ordered pass (THE one
    implementation of the applyFilter contract, residual semantics
    included — see ConstraintApplicationResult.java)."""
    if session is not None:
        from .. import session_properties as SP

        if not SP.value(session, "filter_pushdown_enabled"):
            return None
    if not preds:
        return None
    conn = metadata.connectors.get(scan.catalog)
    if conn is None:
        return None
    from ..predicate import TupleDomain
    from .domain_translator import conjunct_domain

    sym_to_col = {s.name: c.name for s, c in scan.assignments}
    col_domains: Dict[str, object] = {}
    by_col: Dict[str, List[RowExpression]] = {}
    kept: List[RowExpression] = []
    for p in preds:
        got = conjunct_domain(p)
        cname = sym_to_col.get(got[0]) if got is not None else None
        if got is None or cname is None:
            kept.append(p)
            continue
        dom = got[1]
        col_domains[cname] = col_domains[cname].intersect(dom) \
            if cname in col_domains else dom
        by_col.setdefault(cname, []).append(p)
    if not col_domains:
        return None
    offer = TupleDomain.of(col_domains)
    if offer.is_none:
        return None  # contradiction: the plain filter yields zero rows
    applied = conn.metadata().apply_filter(scan.table, offer)
    if applied is None:
        return None
    new_handle, remaining = applied
    residual_cols = set() if remaining is None or remaining.is_all \
        else set(remaining.as_dict())
    for cname, conjs in by_col.items():
        if cname in residual_cols:
            kept.extend(conjs)
    return TableScanNode(scan.catalog, new_handle,
                         list(scan.assignments)), kept


class ReorderJoins(Rule):
    """Cost-based join-order exploration over a flattened inner-join
    region (reference: iterative/rule/ReorderJoins.java — bushy
    partition enumeration priced by the stats calculator; this
    implementation runs exact dynamic programming over subsets up to
    MAX_DP relations and falls back to the greedy connected-ordering
    above that). Single-relation conjuncts sink into their relations;
    equi conjuncts become join criteria at the highest node where both
    sides are available; the rest stay as residual filters.

    Termination without an 'explored' flag: the DP has optimal
    substructure and a deterministic tie-break, so re-application to an
    already-ordered region reproduces the identical tree and the engine
    sees no change."""

    name = "ReorderJoins"
    MAX_DP = 9
    pattern = Pattern((FilterNode, JoinNode, CrossJoinNode),
                      where=lambda n: not isinstance(n, JoinNode)
                      or n.join_type == "inner")
    last_detail = ""

    def __init__(self):
        #: regions already ordered this run, keyed by (relation group
        #: id+version, conjuncts): the DP is deterministic, so re-running
        #: it on an unchanged region is pure waste — and the DP prices
        #: O(3^n) candidate trees through the stats calculator
        self._settled = set()

    def apply(self, node: PlanNode, ctx: RuleContext):
        lookup = ctx.lookup
        if isinstance(node, FilterNode):
            below = lookup.resolve(node.source)
            if not (isinstance(below, CrossJoinNode) or
                    (isinstance(below, JoinNode)
                     and below.join_type == "inner")):
                return None
        relations: List[PlanNode] = []   # GroupReferences / leaf nodes
        pool: List[RowExpression] = []

        def flatten(n: PlanNode):
            r = lookup.resolve(n)
            if isinstance(r, CrossJoinNode):
                flatten(r.left)
                flatten(r.right)
            elif isinstance(r, JoinNode) and r.join_type == "inner":
                flatten(r.left)
                flatten(r.right)
                for l, rr in r.criteria:
                    pool.append(Call(T.BOOLEAN, "eq",
                                     (l.ref(), rr.ref())))
                if r.filter_expr is not None:
                    pool.extend(conjuncts(r.filter_expr))
            elif isinstance(r, FilterNode):
                pool.extend(conjuncts(r.predicate))
                flatten(r.source)
            else:
                # keep the group boundary: the region tree references
                # the child group, whose own exploration continues
                relations.append(n if isinstance(n, GroupReference)
                                 else r)

        flatten(node)
        if len(relations) < 2:
            return None

        memo = ctx.lookup.memo
        fingerprint = (
            tuple((r.group_id, memo.versions[r.group_id])
                  if isinstance(r, GroupReference) else repr(r)
                  for r in relations),
            tuple(sorted(repr(p) for p in pool)))
        if fingerprint in self._settled:
            return None
        self._settled.add(fingerprint)

        rel_syms = [{s.name for s in r.output_symbols}
                    for r in relations]
        per_rel: List[List[RowExpression]] = [[] for _ in relations]
        residual: List[RowExpression] = []
        for p in pool:
            refs = referenced_symbols(p)
            for i, syms in enumerate(rel_syms):
                if refs <= syms:
                    per_rel[i].append(p)
                    break
            else:
                residual.append(p)
        leaves = [_filter(r, ps) for r, ps in zip(relations, per_rel)]

        # equi edges between relations (by index pair)
        sym_owner = {}
        for i, syms in enumerate(rel_syms):
            for s in syms:
                sym_owner[s] = i
        equi: List[Tuple[int, int, Symbol, Symbol, RowExpression]] = []
        other: List[RowExpression] = []
        for p in residual:
            ok = False
            if isinstance(p, Call) and p.name == "eq":
                a, b = p.args
                if isinstance(a, SymbolRef) and isinstance(b, SymbolRef) \
                        and a.name in sym_owner and b.name in sym_owner \
                        and sym_owner[a.name] != sym_owner[b.name]:
                    equi.append((sym_owner[a.name], sym_owner[b.name],
                                 Symbol(a.name, a.type),
                                 Symbol(b.name, b.type), p))
                    ok = True
            if not ok:
                other.append(p)

        ordered = self._order(ctx, leaves, rel_syms, equi)
        if ordered is None:
            return None
        plan, order_desc = ordered
        # instance, not class: rule sets are per-optimize() run, and
        # concurrent queries must not cross-contaminate provenance
        self.last_detail = order_desc
        # leftover non-equi multi-relation conjuncts filter at the top
        return _filter(plan, other)

    # -- ordering ------------------------------------------------------

    def _order(self, ctx: RuleContext, leaves: List[PlanNode],
               rel_syms: List[Set[str]], equi):
        """Order the region through the optimize() run's ONE shared,
        node-memoized ``StatsCalculator`` (history-fed when the query
        has an HboContext).  When recorded actuals priced any relation
        (``source=hbo``), a second pricing pass from connector
        estimates alone detects whether history CHANGED the chosen
        order — the ``hbo_plan_flips{kind="join_order"}`` witness.

        A region holding a ``ParamRef`` (a plan-template trial) prices
        from connector estimates alone: recorded actuals belong to ONE
        literal binding, and a literal-poisoned cardinality could flip
        the param-filtered side onto the build — breaking the
        one-build-serves-all-lanes batching invariant for every other
        binding the template must serve."""
        from .optimizer import template_param_slots

        if any(template_param_slots(ctx.extract(l)) for l in leaves):
            from .stats import StatsCalculator

            ordered = self._order_with(ctx, StatsCalculator(ctx.metadata),
                                       leaves, rel_syms, equi, memo=False)
            return None if ordered is None else ordered[:2]
        ordered = self._order_with(ctx, ctx.shared_stats(), leaves,
                                   rel_syms, equi, memo=True)
        if ordered is None:
            return None
        plan, desc, hbo_sourced = ordered
        if hbo_sourced and ctx.hbo is not None:
            from .stats import StatsCalculator

            base = self._order_with(ctx, StatsCalculator(ctx.metadata),
                                    leaves, rel_syms, equi, memo=False)
            if base is not None and \
                    base[1] != desc.replace("[hbo]", ""):
                if ctx.hbo.store is not None:
                    ctx.hbo.store.note_plan_flip("join_order")
                desc += " (hbo reordered)"
        return plan, desc

    def _order_with(self, ctx: RuleContext, calc, leaves: List[PlanNode],
                    rel_syms: List[Set[str]], equi, memo: bool):
        n = len(leaves)
        concrete = [ctx.extract(l) for l in leaves]
        #: relations whose cardinality came from recorded history —
        #: tagged ``r<i>[hbo]`` in the order provenance
        hbo_leaves: Set[int] = set()

        def criteria_between(left_set: int, right_set: int):
            crit = []
            for i, j, ls, rs, _p in equi:
                if (1 << i) & left_set and (1 << j) & right_set:
                    crit.append((ls, rs))
                elif (1 << j) & left_set and (1 << i) & right_set:
                    crit.append((rs, ls))
            return crit

        # exact DP over subsets: best[S] = (cumulative cost, rows,
        # concrete tree for costing, builder for the real tree)
        best: Dict[int, Tuple[float, float, PlanNode, object]] = {}
        for i in range(n):
            st = ctx.region_stats(leaves[i], concrete[i]) if memo \
                else calc.stats(concrete[i])
            if st.source == "hbo":
                hbo_leaves.add(i)
            best[1 << i] = (0.0, st.row_count, concrete[i], ("leaf", i))

        if n > self.MAX_DP:
            return self._order_greedy(ctx, calc, leaves, concrete,
                                      rel_syms, equi, best, hbo_leaves)
        full = (1 << n) - 1
        for size in range(2, n + 1):
            for s in _subsets_of_size(n, size):
                cand_best = None
                sub = (s - 1) & s
                lowbit = s & -s
                while sub:
                    rest = s ^ sub
                    if sub in best and rest in best and sub > rest:
                        # stable tie-break: try the orientation keeping
                        # the lowest-numbered relation on the LEFT
                        # first — cost ties then reproduce the current
                        # arrangement instead of flip-flopping build
                        # sides forever (self-join regions)
                        pairs = ((sub, rest), (rest, sub)) \
                            if sub & lowbit else ((rest, sub),
                                                  (sub, rest))
                        for left_set, right_set in pairs:
                            crit = criteria_between(left_set, right_set)
                            if not crit and size < n:
                                continue  # avoid cross joins mid-region
                            lcost, lrows, ltree, lb = best[left_set]
                            rcost, rrows, rtree, rb = best[right_set]
                            if crit:
                                cand_tree = JoinNode("inner", ltree,
                                                     rtree, crit)
                                rows = calc.stats(cand_tree).row_count
                            else:
                                cand_tree = None
                                rows = lrows * rrows
                            # cost = intermediate rows produced + build
                            # side materialization (the probe streams)
                            cost = lcost + rcost + rows + rrows
                            if cand_best is None or \
                                    (cost, rows) < cand_best[:2]:
                                cand_best = (cost, rows, cand_tree,
                                             ("join", left_set,
                                              right_set, crit))
                    sub = (sub - 1) & s
                if cand_best is not None:
                    cost, rows, tree, builder = cand_best
                    if tree is None:
                        tree = self._cross(ctx, best[builder[1]][2],
                                           best[builder[2]][2])
                    best[s] = (cost, rows, tree, builder)
        if full not in best:
            return None

        names: List[str] = []

        def leaf_name(i: int) -> str:
            return f"r{i}[hbo]" if i in hbo_leaves else f"r{i}"

        def build(s: int) -> PlanNode:
            _c, _r, _t, b = best[s]
            if b[0] == "leaf":
                i = b[1]
                names.append(leaf_name(i))
                return leaves[i]
            _tag, ls, rs, crit = b
            left = build(ls)
            names.append("⋈")
            right = build(rs)
            if crit:
                return JoinNode("inner", left, right, crit)
            return self._cross(ctx, left, right)

        plan = build(full)
        return plan, " ".join(names), bool(hbo_leaves)

    def _order_greedy(self, ctx, calc, leaves, concrete, rel_syms,
                      equi, best, hbo_leaves):
        """Connected greedy ordering for wide regions (mirrors the
        pre-memo pass: largest relation first as the streaming probe,
        then smallest estimated join output).  ``best`` holds the
        already-memoized per-leaf estimates."""
        n = len(leaves)
        sizes = [best[1 << i][1] for i in range(n)]

        def leaf_name(i: int) -> str:
            return f"r{i}[hbo]" if i in hbo_leaves else f"r{i}"

        order = sorted(range(n), key=lambda i: -sizes[i])
        joined = {order[0]}
        plan, ctree = leaves[order[0]], concrete[order[0]]
        names = [leaf_name(order[0])]
        unjoined = order[1:]
        while unjoined:
            cand = None
            for i in unjoined:
                crit = []
                for a, b, ls, rs, _p in equi:
                    if a in joined and b == i:
                        crit.append((ls, rs))
                    elif b in joined and a == i:
                        crit.append((rs, ls))
                if crit:
                    t = JoinNode("inner", ctree, concrete[i], crit)
                    key = (calc.stats(t).row_count, sizes[i])
                    if cand is None or key < cand[0]:
                        cand = (key, i, crit, t)
            if cand is None:
                i = min(unjoined, key=lambda j: sizes[j])
                plan = self._cross(ctx, plan, leaves[i])
                ctree = self._cross(ctx, ctree, concrete[i])
            else:
                _k, i, crit, t = cand
                plan = JoinNode("inner", plan, leaves[i], crit)
                ctree = t
            joined.add(i)
            names.append(f"⋈ {leaf_name(i)}")
            unjoined.remove(i)
        return plan, " ".join(names), bool(hbo_leaves)

    def _cross(self, ctx: RuleContext, left: PlanNode,
               right: PlanNode) -> PlanNode:
        lk = ctx.allocator.new_symbol("cj", T.BIGINT)
        rk = ctx.allocator.new_symbol("cj", T.BIGINT)
        lproj = ProjectNode(left, [(s, s.ref())
                                   for s in left.output_symbols]
                            + [(lk, Literal(T.BIGINT, 0))])
        rproj = ProjectNode(right, [(s, s.ref())
                                    for s in right.output_symbols]
                            + [(rk, Literal(T.BIGINT, 0))])
        return JoinNode("inner", lproj, rproj, [(lk, rk)])


def _subsets_of_size(n: int, size: int):
    import itertools

    for combo in itertools.combinations(range(n), size):
        s = 0
        for i in combo:
            s |= 1 << i
        yield s


def default_rules() -> List[Rule]:
    return [
        FilterOverWindowToTopNRanking(),
        MergeFilters(),
        PushFilterThroughProject(),
        PushFilterThroughAggregation(),
        PushFilterThroughExchangeLike(),
        PushFilterThroughOuterJoin(),
        ReorderJoins(),
        PushFilterIntoTableScan(),
        MergeLimits(),
        PushLimitThroughProject(),
        LimitOverSortToTopN(),
        RemoveRedundantIdentityProjection(),
        InlineProjections(),
    ]
