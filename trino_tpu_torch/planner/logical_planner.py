"""Logical planner: analyzed AST -> PlanNode tree.

Reference analog: ``sql/planner/LogicalPlanner.java`` + ``QueryPlanner.java``
+ ``RelationPlanner.java`` + ``SubqueryPlanner.java``. Subqueries are
decorrelated at plan time into semi/anti/left joins (the reference plans
ApplyNode/CorrelatedJoinNode and decorrelates via optimizer rules —
``iterative/rule/TransformCorrelated*``; doing it directly here covers the
same executable surface with far less machinery).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import types as T
from ..expr.ir import Call, Literal, RowExpression
from ..sql import ast
from ..sql.analyzer import (AGGREGATE_FUNCTIONS, AnalysisError,
                            ExpressionAnalyzer, FieldDef, Scope, Session,
                            coerce, common_type, expression_uses_scope,
                            find_aggregates, find_windows)
from .plan import (Aggregation, AggregationNode, CrossJoinNode, DistinctNode,
                   EnforceSingleRowNode, ExceptNode, FilterNode,
                   IntersectNode, JoinNode, LimitNode, Ordering, OutputNode,
                   PlanNode, ProjectNode, SortNode, TableScanNode, TopNNode,
                   UnionNode, ValuesNode)
from .symbols import (Symbol, SymbolAllocator, SymbolRef, referenced_symbols,
                      rewrite_symbols)


TRUE = Literal(T.BOOLEAN, True)


def conjuncts(e: Optional[RowExpression]) -> List[RowExpression]:
    if e is None:
        return []
    if isinstance(e, Call) and e.name == "$and":
        out: List[RowExpression] = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def combine_conjuncts(parts: Sequence[RowExpression]
                      ) -> Optional[RowExpression]:
    parts = [p for p in parts if not (isinstance(p, Literal)
                                      and p.value is True)]
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return Call(T.BOOLEAN, "$and", tuple(parts))


def ast_conjuncts(e: Optional[ast.Expression]) -> List[ast.Expression]:
    if e is None:
        return []
    if isinstance(e, ast.LogicalBinary) and e.op.lower() == "and":
        return ast_conjuncts(e.left) + ast_conjuncts(e.right)
    return [e]


class Metadata:
    """Catalog routing facade (reference: metadata/MetadataManager.java)."""

    def __init__(self, connectors: Dict[str, "Connector"]):  # noqa: F821
        self.connectors = dict(connectors)

    def resolve_table(self, name: Tuple[str, ...], session: Session):
        """name -> (catalog, connector, TableHandle, columns) or None."""
        parts = tuple(p.lower() for p in name)
        if len(parts) == 3:
            cands = [(parts[0], parts[1], parts[2])]
        elif len(parts) == 2:
            cands = [(c, parts[0], parts[1]) for c in self.connectors]
        else:
            cands = [(session.catalog or c, session.schema, parts[0])
                     for c in ([session.catalog] if session.catalog
                               else list(self.connectors))]
        for catalog, schema, table in cands:
            conn = self.connectors.get(catalog)
            if conn is None:
                continue
            handle = conn.metadata().get_table_handle(schema, table)
            if handle is not None:
                return catalog, conn, handle, conn.metadata().get_columns(
                    handle)
        return None

    def resolve_target(self, name: Tuple[str, ...], session: Session):
        """DDL/write target resolution (shared by planner and runner):
        (catalog, connector, schema, table)."""
        parts = tuple(p.lower() for p in name)
        if len(parts) == 3:
            catalog, schema, table = parts
        elif len(parts) == 2:
            catalog, (schema, table) = session.catalog, parts
        else:
            catalog, schema, table = (session.catalog, session.schema,
                                      parts[0])
        conn = self.connectors.get(catalog)
        if conn is None:
            from ..sql.analyzer import AnalysisError

            raise AnalysisError(f"catalog '{catalog}' does not exist")
        return catalog, conn, schema, table


class LogicalPlanner:
    """Reference: sql/planner/LogicalPlanner.java."""

    def __init__(self, metadata: Metadata, session: Session):
        self.metadata = metadata
        self.session = session
        self.allocator = SymbolAllocator()

    def plan(self, stmt: ast.Statement) -> OutputNode:
        if isinstance(stmt, ast.QueryStatement):
            planner = QueryPlanner(self, {})
            rp = planner.plan_query(stmt.query, outer_scope=None)
            names = [f.name or f"_col{i}"
                     for i, f in enumerate(rp.scope.visible_fields())]
            outputs = [f.symbol for f in rp.scope.visible_fields()]
            return OutputNode(rp.node, names, outputs)
        if isinstance(stmt, ast.CreateTableAsSelect):
            return self.plan_ctas(stmt)
        if isinstance(stmt, ast.Insert):
            return self.plan_insert(stmt)
        raise AnalysisError(
            f"unsupported statement: {type(stmt).__name__}")

    def _target(self, name):
        """(catalog, connector, schema, table) for a DDL/write target."""
        return self.metadata.resolve_target(name, self.session)

    def plan_ctas(self, stmt: ast.CreateTableAsSelect) -> OutputNode:
        from ..connectors.spi import ColumnHandle
        from .plan import TableWriterNode

        catalog, conn, schema, table = self._target(stmt.name)
        exists = conn.metadata().get_table_handle(schema, table) is not None
        if exists:
            if stmt.if_not_exists:
                zero = self.allocator.new_symbol("rows", T.BIGINT)
                return OutputNode(
                    ValuesNode([zero], [[Literal(T.BIGINT, 0)]]),
                    ["rows"], [zero])
            raise AnalysisError(
                f"Table '{schema}.{table}' already exists")
        planner = QueryPlanner(self, {})
        rp = planner.plan_query(stmt.query, outer_scope=None)
        vis = rp.scope.visible_fields()
        columns = [ColumnHandle(f.name or f"_col{i}", f.symbol.type, i)
                   for i, f in enumerate(vis)]
        proj = ProjectNode(rp.node, [(f.symbol, f.symbol.ref())
                                     for f in vis])
        rows = self.allocator.new_symbol("rows", T.BIGINT)
        writer = TableWriterNode(proj, catalog, schema, table, columns,
                                 rows, create=True)
        return OutputNode(writer, ["rows"], [rows])

    def plan_insert(self, stmt: ast.Insert) -> OutputNode:
        from .plan import TableWriterNode

        catalog, conn, schema, table = self._target(stmt.table)
        handle = conn.metadata().get_table_handle(schema, table)
        if handle is None:
            raise AnalysisError(
                f"table '{schema}.{table}' does not exist")
        target_cols = conn.metadata().get_columns(handle)
        planner = QueryPlanner(self, {})
        rp = planner.plan_query(stmt.query, outer_scope=None)
        vis = rp.scope.visible_fields()
        if stmt.columns:
            by_name = {c.name.lower(): c for c in target_cols}
            specified = []
            for cn in stmt.columns:
                c = by_name.get(cn.lower())
                if c is None:
                    raise AnalysisError(f"column '{cn}' does not exist")
                specified.append(c)
        else:
            specified = list(target_cols)
        if len(vis) != len(specified):
            raise AnalysisError(
                f"INSERT has {len(vis)} columns but table expects "
                f"{len(specified)}")
        # write in TABLE column order; unspecified columns get NULL
        value_of = {c.name: coerce(f.symbol.ref(), c.type)
                    for c, f in zip(specified, vis)}
        assignments = []
        for c in target_cols:
            expr = value_of.get(c.name, Literal(c.type, None))
            sym = self.allocator.new_symbol(c.name, c.type)
            assignments.append((sym, expr))
        proj = ProjectNode(rp.node, assignments)
        rows = self.allocator.new_symbol("rows", T.BIGINT)
        writer = TableWriterNode(proj, catalog, schema, table,
                                 target_cols, rows)
        return OutputNode(writer, ["rows"], [rows])


class RelationPlan:
    """A planned relation: node + the scope naming its outputs."""

    def __init__(self, node: PlanNode, scope: Scope):
        self.node = node
        self.scope = scope


class QueryPlanner:
    """Plans one query level (reference: sql/planner/QueryPlanner.java)."""

    def __init__(self, ctx: LogicalPlanner,
                 ctes: Dict[str, ast.WithQuery]):
        self.ctx = ctx
        self.ctes = dict(ctes)

    @property
    def allocator(self) -> SymbolAllocator:
        return self.ctx.allocator

    # ------------------------------------------------------------------

    def plan_query(self, q: ast.Query,
                   outer_scope: Optional[Scope]) -> RelationPlan:
        ctes = dict(self.ctes)
        for w in q.with_queries:
            ctes[w.name.lower()] = w
        sub = QueryPlanner(self.ctx, ctes)
        body = q.body
        if isinstance(body, ast.QuerySpecification):
            # merge query-level ORDER BY / LIMIT / OFFSET into the spec so
            # sort keys can resolve against the pre-projection scope
            if (q.order_by or q.limit is not None or q.offset) and \
                    not (body.order_by or body.limit is not None):
                import dataclasses

                body = dataclasses.replace(body, order_by=q.order_by,
                                           limit=q.limit, offset=q.offset)
            return sub.plan_query_spec(body, outer_scope)
        if isinstance(body, ast.SetOperation):
            rp = sub.plan_set_operation(body, outer_scope)
        elif isinstance(body, ast.Values):
            rp = sub.plan_values(body, outer_scope)
        else:
            raise AnalysisError(
                f"unsupported query body {type(body).__name__}")
        # query-level ORDER BY / LIMIT / OFFSET above a set operation
        if q.order_by:
            rp = sub.plan_order_limit(rp, q.order_by, q.limit, q.offset,
                                      replacements={})
        elif q.limit is not None or q.offset:
            rp = RelationPlan(LimitNode(rp.node, q.limit, q.offset), rp.scope)
        return rp

    # ------------------------------------------------------------------
    # relations (FROM clause)

    def plan_relation(self, rel: ast.Relation,
                      outer_scope: Optional[Scope]) -> RelationPlan:
        if isinstance(rel, ast.Table):
            return self.plan_table(rel, outer_scope)
        if isinstance(rel, ast.Unnest):
            return self.plan_unnest(rel, None, outer_scope)
        if isinstance(rel, ast.AliasedRelation):
            rp = self.plan_relation(rel.relation, outer_scope)
            fields = []
            vis = rp.scope.visible_fields()
            if rel.column_names:
                if len(rel.column_names) != len(vis):
                    raise AnalysisError(
                        f"alias {rel.alias} declares "
                        f"{len(rel.column_names)} columns, relation has "
                        f"{len(vis)}")
            for i, f in enumerate(vis):
                name = (rel.column_names[i].lower() if rel.column_names
                        else f.name)
                fields.append(FieldDef(name, f.symbol,
                                       relation_alias=rel.alias.lower()))
            return RelationPlan(rp.node, Scope(fields, outer_scope))
        if isinstance(rel, ast.SubqueryRelation):
            rp = self.plan_query(rel.query, outer_scope)
            # re-parent the scope fields without the subquery's internals
            fields = [FieldDef(f.name, f.symbol)
                      for f in rp.scope.visible_fields()]
            return RelationPlan(rp.node, Scope(fields, outer_scope))
        if isinstance(rel, ast.Join):
            return self.plan_join(rel, outer_scope)
        if isinstance(rel, ast.Values):
            return self.plan_values(rel, outer_scope)
        raise AnalysisError(f"unsupported relation {type(rel).__name__}")

    def plan_table(self, rel: ast.Table,
                   outer_scope: Optional[Scope]) -> RelationPlan:
        name = tuple(p.lower() for p in rel.name)
        if len(name) == 1 and name[0] in self.ctes:
            w = self.ctes[name[0]]
            # plan the CTE body fresh (inlining, like the reference's
            # default CTE handling)
            sub_ctes = dict(self.ctes)
            del sub_ctes[name[0]]   # no self-recursion
            sub = QueryPlanner(self.ctx, sub_ctes)
            rp = sub.plan_query(w.query, None)
            vis = rp.scope.visible_fields()
            fields = []
            for i, f in enumerate(vis):
                fname = (w.column_names[i].lower() if w.column_names
                         else f.name)
                fields.append(FieldDef(fname, f.symbol,
                                       relation_alias=name[0]))
            return RelationPlan(rp.node, Scope(fields, outer_scope))
        resolved = self.ctx.metadata.resolve_table(rel.name, self.ctx.session)
        if resolved is None:
            raise AnalysisError(
                "table '%s' does not exist" % ".".join(rel.name))
        catalog, conn, handle, columns = resolved
        assignments = []
        fields = []
        for col in columns:
            sym = self.allocator.new_symbol(col.name, col.type)
            assignments.append((sym, col))
            fields.append(FieldDef(col.name.lower(), sym,
                                   relation_alias=handle.table.lower()))
        node = TableScanNode(catalog, handle, assignments)
        return RelationPlan(node, Scope(fields, outer_scope))

    def plan_values(self, rel: ast.Values,
                    outer_scope: Optional[Scope]) -> RelationPlan:
        analyzer = ExpressionAnalyzer(Scope([], None), self.ctx.session)
        rows = [[analyzer.analyze(item) for item in row]
                for row in rel.rows]
        ncols = len(rows[0]) if rows else 0
        col_types: List[T.Type] = []
        for c in range(ncols):
            t = rows[0][c].type
            for r in rows[1:]:
                t = common_type(t, r[c].type, "VALUES")
            col_types.append(t)
        rows = [[coerce(r[c], col_types[c]) for c in range(ncols)]
                for r in rows]
        symbols = [self.allocator.new_symbol(f"col{i}", col_types[i])
                   for i in range(ncols)]
        fields = [FieldDef(None, s) for s in symbols]
        return RelationPlan(ValuesNode(symbols, rows),
                            Scope(fields, outer_scope))

    def plan_unnest(self, un: ast.Unnest,
                    base: Optional["RelationPlan"],
                    outer_scope: Optional[Scope],
                    alias: Optional[str] = None,
                    column_names=()) -> RelationPlan:
        """UNNEST as a relation: standalone (FROM unnest(...)) or
        correlated to the left side of a CROSS JOIN (reference:
        RelationPlanner.planCrossJoinUnnest)."""
        from .plan import UnnestNode

        if base is None:
            base = RelationPlan(ValuesNode([], [[]]),
                                Scope([], outer_scope))
        analyzer = ExpressionAnalyzer(base.scope, self.ctx.session)
        node = base.node
        arr_syms: List[Symbol] = []
        el_syms: List[Symbol] = []
        for expr in un.expressions:
            e = analyzer.analyze(expr)
            if not e.type.is_array:
                raise AnalysisError(
                    f"UNNEST argument must be an array, got {e.type}")
            node, s = _ensure_symbol(self, node, e, None)
            arr_syms.append(s)
            el_syms.append(self.allocator.new_symbol(
                "unnest", e.type.element))
        ord_sym = self.allocator.new_symbol("ordinality", T.BIGINT) \
            if un.with_ordinality else None
        out = UnnestNode(node, arr_syms, el_syms, ord_sym)
        new = el_syms + ([ord_sym] if ord_sym else [])
        names = [column_names[i].lower() if i < len(column_names)
                 else None for i in range(len(new))]
        fields = base.scope.fields + [
            FieldDef(names[i], s, relation_alias=(alias or "").lower()
                     or None)
            for i, s in enumerate(new)]
        return RelationPlan(out, Scope(fields, outer_scope))

    def plan_join(self, rel: ast.Join,
                  outer_scope: Optional[Scope]) -> RelationPlan:
        if rel.join_type.upper() in ("CROSS", "IMPLICIT"):
            r = rel.right
            alias, cols = None, ()
            if isinstance(r, ast.AliasedRelation) \
                    and isinstance(r.relation, ast.Unnest):
                alias, cols = r.alias, r.column_names
                r = r.relation
            if isinstance(r, ast.Unnest):
                left = self.plan_relation(rel.left, outer_scope)
                return self.plan_unnest(r, left, outer_scope, alias, cols)
        left = self.plan_relation(rel.left, outer_scope)
        right = self.plan_relation(rel.right, outer_scope)
        jt = rel.join_type.upper()
        merged_fields = left.scope.fields + right.scope.fields
        scope = Scope(merged_fields, outer_scope)

        if jt in ("CROSS", "IMPLICIT"):
            return RelationPlan(CrossJoinNode(left.node, right.node), scope)

        # ON / USING criteria
        criteria: List[Tuple[Symbol, Symbol]] = []
        residual: List[RowExpression] = []
        left_syms = {s.name for s in left.node.output_symbols}
        right_syms = {s.name for s in right.node.output_symbols}
        lnode, rnode = left.node, right.node

        cond_conjuncts: List[ast.Expression] = []
        if rel.using_columns:
            for c in rel.using_columns:
                cond_conjuncts.append(ast.ComparisonExpression(
                    "=", ast.Identifier(c), ast.Identifier(c)))
        elif rel.criteria is not None:
            cond_conjuncts = ast_conjuncts(rel.criteria)

        if rel.using_columns:
            # resolve each side separately for USING
            for c in rel.using_columns:
                lf, _ = left.scope.resolve(c)
                rf, _ = right.scope.resolve(c)
                criteria.append((lf.symbol, rf.symbol))
        else:
            analyzer = ExpressionAnalyzer(scope, self.ctx.session)
            for cj in cond_conjuncts:
                e = analyzer.analyze(cj)
                pair = _as_equi_pair(e, left_syms, right_syms)
                if pair is not None:
                    lsym, rsym, lexpr, rexpr = pair
                    lnode, lsym = _ensure_symbol(self, lnode, lexpr, lsym)
                    rnode, rsym = _ensure_symbol(self, rnode, rexpr, rsym)
                    criteria.append((lsym, rsym))
                else:
                    residual.append(e)

        if jt == "RIGHT":
            # normalize RIGHT to LEFT by swapping inputs; output symbol
            # order follows the scope, resolved by projection later
            lnode, rnode = rnode, lnode
            criteria = [(r, l) for l, r in criteria]
            jt = "LEFT"
        join_type = {"INNER": "inner", "LEFT": "left",
                     "FULL": "full"}.get(jt, "left")
        if jt == "FULL" and not criteria:
            # a FULL join whose ON clause has no equi-conjunct has no
            # partitionable key; the engine's sorted-index join needs one
            raise AnalysisError(
                "FULL OUTER JOIN requires at least one equality "
                "conjunct in ON")
        if not criteria and join_type == "inner":
            node: PlanNode = CrossJoinNode(lnode, rnode)
            if residual:
                node = FilterNode(node, combine_conjuncts(residual))
            return RelationPlan(node, scope)
        node = JoinNode(join_type, lnode, rnode, criteria,
                        combine_conjuncts(residual))
        return RelationPlan(node, scope)

    # ------------------------------------------------------------------
    # SELECT core

    def plan_query_spec(self, spec: ast.QuerySpecification,
                        outer_scope: Optional[Scope]) -> RelationPlan:
        # FROM
        if spec.from_ is not None:
            rp = self.plan_relation(spec.from_, outer_scope)
        else:
            node = ValuesNode([], [[]])
            rp = RelationPlan(node, Scope([], outer_scope))

        # WHERE (with subquery planning)
        if spec.where is not None:
            rp = self.plan_where(rp, spec.where)

        # aggregation analysis; select_exprs items: (ast_expr|None, alias,
        # field|None) — field set for *-expansion entries
        select_exprs: List[Tuple] = []
        for item in spec.select_items:
            if isinstance(item, ast.AllColumns):
                for f in rp.scope.visible_fields():
                    if item.prefix and \
                            f.relation_alias != item.prefix[-1].lower():
                        continue
                    select_exprs.append((None, f.name, f))
            else:
                select_exprs.append((item.expression, item.alias, None))

        agg_calls: List[ast.FunctionCall] = []
        for e, _, _f in select_exprs:
            if e is not None:
                agg_calls.extend(find_aggregates(e))
        if spec.having is not None:
            agg_calls.extend(find_aggregates(spec.having))
        for si in spec.order_by:
            agg_calls.extend(find_aggregates(si.key))

        group_exprs = self.resolve_group_by(spec, select_exprs)
        replacements: Dict[ast.Expression, Symbol] = {}

        if agg_calls or group_exprs is not None:
            rp, replacements = self.plan_aggregation(
                rp, group_exprs or [], agg_calls, select_exprs)

        # HAVING (subqueries allowed — q11's having > (select ...))
        if spec.having is not None:
            having_state = _HookState(rp)
            analyzer = ExpressionAnalyzer(
                rp.scope, self.ctx.session, replacements=replacements,
                subquery_hook=self._scalar_subquery_hook(having_state))
            pred = coerce(analyzer.analyze(spec.having), T.BOOLEAN)
            rp = RelationPlan(FilterNode(having_state.rp.node, pred),
                              having_state.rp.scope)

        # window functions (evaluate over post-aggregation rows)
        window_calls: List[ast.FunctionCall] = []
        for e, _, _f in select_exprs:
            if e is not None:
                window_calls.extend(find_windows(e))
        for si in spec.order_by:
            window_calls.extend(find_windows(si.key))
        if window_calls:
            rp, replacements = self.plan_windows(rp, window_calls,
                                                 replacements)

        # SELECT projections
        hook_state = _HookState(rp)
        analyzer = ExpressionAnalyzer(
            rp.scope, self.ctx.session, replacements=replacements,
            subquery_hook=self._scalar_subquery_hook(hook_state))
        out_fields: List[FieldDef] = []
        assignments: List[Tuple[Symbol, RowExpression]] = []
        for e, alias, fld in select_exprs:
            if e is None:   # expanded * column
                assignments.append((fld.symbol, fld.symbol.ref()))
                out_fields.append(FieldDef(fld.name, fld.symbol))
                continue
            expr = analyzer.analyze(e)
            name = alias.lower() if alias else _derive_name(e)
            sym = self.allocator.new_symbol(name or "expr", expr.type)
            assignments.append((sym, expr))
            out_fields.append(FieldDef(name, sym))
        rp = hook_state.rp  # subquery hooks may have joined new sources
        pre_projection_scope = rp.scope
        proj = ProjectNode(rp.node, assignments)
        rp = RelationPlan(proj, Scope(out_fields, outer_scope))

        # DISTINCT
        if spec.distinct:
            rp = RelationPlan(DistinctNode(rp.node), rp.scope)

        # ORDER BY / LIMIT / OFFSET
        if spec.order_by:
            rp = self.plan_order_limit(
                rp, spec.order_by, spec.limit, spec.offset, replacements,
                source_scope=pre_projection_scope,
                proj_node=proj if not spec.distinct else None)
        elif spec.limit is not None or spec.offset:
            rp = RelationPlan(LimitNode(rp.node, spec.limit, spec.offset),
                              rp.scope)
        return rp

    def resolve_group_by(self, spec: ast.QuerySpecification,
                         select_exprs) -> Optional[List[ast.Expression]]:
        if spec.group_by is None:
            return None
        if spec.group_by.kind != "simple":
            raise AnalysisError(
                "ROLLUP/CUBE/GROUPING SETS not supported yet")
        out = []
        for e in spec.group_by.expressions:
            if isinstance(e, ast.LongLiteral):   # GROUP BY ordinal
                idx = e.value - 1
                if not (0 <= idx < len(select_exprs)):
                    raise AnalysisError(
                        f"GROUP BY position {e.value} out of range")
                target = select_exprs[idx][0]
                if target is None:
                    raise AnalysisError("GROUP BY ordinal points at *")
                out.append(target)
            elif isinstance(e, ast.Identifier):
                # could be a select alias (SQL extension) — prefer source
                # column, fall back to alias target
                out.append(e)
            else:
                out.append(e)
        return out

    def plan_aggregation(self, rp: RelationPlan,
                         group_exprs: List[ast.Expression],
                         agg_calls: List[ast.FunctionCall],
                         select_exprs) -> Tuple[RelationPlan, Dict]:
        """Pre-project group keys + agg args, aggregate, build replacement
        map for post-agg expression lowering."""
        analyzer = ExpressionAnalyzer(rp.scope, self.ctx.session)
        pre_assignments: List[Tuple[Symbol, RowExpression]] = []
        pre_index: Dict[RowExpression, Symbol] = {}

        def channel_for(expr: RowExpression, hint: str) -> Symbol:
            if isinstance(expr, SymbolRef):
                sym = Symbol(expr.name, expr.type)
                if not any(s.name == sym.name for s, _ in pre_assignments):
                    pre_assignments.append((sym, expr))
                return sym
            found = pre_index.get(expr)
            if found is not None:
                return found
            sym = self.allocator.new_symbol(hint, expr.type)
            pre_assignments.append((sym, expr))
            pre_index[expr] = sym
            return sym

        # group keys
        group_keys: List[Symbol] = []
        replacements: Dict[ast.Expression, Symbol] = {}
        for ge in group_exprs:
            expr, alias_target = self._analyze_group_expr(
                ge, rp, select_exprs, analyzer)
            sym = channel_for(expr, _derive_name(ge) or "key")
            if sym not in group_keys:
                group_keys.append(sym)
            replacements[ge] = sym
            if alias_target is not None:
                # GROUP BY select-alias: the select-list expression itself
                # must also resolve to the key post-aggregation
                replacements[alias_target] = sym

        # aggregates: plan arguments, one aggregation output per distinct
        # (function, arg, distinct) triple
        aggregations: List[Tuple[Symbol, Aggregation]] = []
        agg_index: Dict[Tuple, Symbol] = {}
        sketch_params: Dict[str, float] = {}
        for call in agg_calls:
            name = call.name.lower()
            distinct = call.distinct
            if name == "approx_percentile":
                # two-argument form: the percentile must be a constant
                if len(call.args) != 2:
                    raise AnalysisError(
                        "approx_percentile expects (value, percentile)")
                from decimal import Decimal

                p_expr = analyzer.analyze(call.args[1])
                if not isinstance(p_expr, Literal) or \
                        not isinstance(p_expr.value,
                                       (int, float, Decimal)) or \
                        not (0 < float(p_expr.value) < 1):
                    raise AnalysisError(
                        "approx_percentile percentile must be a literal "
                        "in (0, 1)")
                arg_expr = analyzer.analyze(call.args[0])
                arg_sym = channel_for(arg_expr, "pct_arg")
                key = (name, arg_sym.name, float(p_expr.value))
                if key in agg_index:
                    replacements[call] = agg_index[key]
                    continue
                from ..ops.aggregation import resolve_agg_type

                out_t = resolve_agg_type(name, arg_sym.type)
                out_sym = self.allocator.new_symbol(name, out_t)
                sketch_params[out_sym.name] = float(p_expr.value)
                aggregations.append(
                    (out_sym, Aggregation(name, arg_sym, False)))
                agg_index[key] = out_sym
                replacements[call] = out_sym
                continue
            if name == "count" and not call.args:
                key = ("count_star", None, False)
                fn_name, arg_sym = "count_star", None
            else:
                if len(call.args) != 1:
                    raise AnalysisError(
                        f"aggregate {name} expects one argument")
                arg = call.args[0]
                if not expression_uses_scope(arg) and name == "count" \
                        and not distinct:
                    # count(1) == count(*); count(DISTINCT <const>) must
                    # NOT collapse (it counts one distinct value)
                    key = ("count_star", None, False)
                    fn_name, arg_sym = "count_star", None
                else:
                    arg_expr = analyzer.analyze(arg)
                    if name in ("count",) and arg_expr.type == T.UNKNOWN:
                        arg_expr = Literal(T.BIGINT, None)
                    arg_sym = channel_for(arg_expr, name + "_arg")
                    fn_name = name
                    key = (name, arg_sym.name, distinct)
            if key in agg_index:
                replacements[call] = agg_index[key]
                continue
            from ..ops.aggregation import resolve_agg_type

            out_t = resolve_agg_type(
                fn_name, arg_sym.type if arg_sym else None)
            out_sym = self.allocator.new_symbol(fn_name, out_t)
            aggregations.append(
                (out_sym, Aggregation(fn_name, arg_sym, distinct)))
            agg_index[key] = out_sym
            replacements[call] = out_sym

        pre = ProjectNode(rp.node, pre_assignments)
        sketchy = [a for _, a in aggregations
                   if a.function in ("approx_distinct",
                                     "approx_percentile")]
        if sketchy:
            if any(a.distinct for _, a in aggregations):
                raise AnalysisError(
                    "approximate aggregates cannot combine with "
                    "DISTINCT aggregates in one grouping yet")
            agg_node = self._plan_sketch_aggs(pre, group_keys,
                                              aggregations,
                                              sketch_params)
        elif any(a.distinct for _, a in aggregations):
            agg_node = self._plan_distinct_aggs(pre, group_keys,
                                                aggregations)
        else:
            agg_node = AggregationNode(pre, group_keys, aggregations)
        fields = [FieldDef(s.name, s) for s in agg_node.output_symbols]
        # keep original field names for group keys resolvable
        name_of = {}
        for f in rp.scope.fields:
            name_of.setdefault(f.symbol.name, (f.name, f.relation_alias))
        out_fields = []
        for s in agg_node.output_symbols:
            nm, al = name_of.get(s.name, (s.name, None))
            out_fields.append(FieldDef(nm, s, relation_alias=al))
        return (RelationPlan(agg_node, Scope(out_fields,
                                             rp.scope.parent)),
                replacements)

    def _analyze_group_expr(self, ge, rp, select_exprs, analyzer):
        """Returns (expr, alias_target_ast|None)."""
        try:
            return analyzer.analyze(ge), None
        except AnalysisError:
            # maybe a select alias
            if isinstance(ge, ast.Identifier):
                for e, alias, _f in select_exprs:
                    if alias and alias.lower() == ge.name.lower() \
                            and e is not None:
                        return analyzer.analyze(e), e
            raise

    # ------------------------------------------------------------------
    # window functions

    def plan_windows(self, rp: RelationPlan,
                     calls: List[ast.FunctionCall],
                     replacements: Dict) -> Tuple[RelationPlan, Dict]:
        """One WindowNode per distinct (partition, order, frame) spec
        (reference: QueryPlanner window planning +
        plan/WindowNode.java)."""
        raise T.TrinoError("window functions are not ported to the torch "
                           "engine yet", "NOT_SUPPORTED")

    def _plan_distinct_aggs(self, pre, group_keys, aggregations):
        """DISTINCT aggregates via group-by rewrite.

        All-distinct on one argument (reference:
        iterative/rule/SingleDistinctAggregationToGroupBy.java):
            agg(distinct x) GROUP BY k
            => inner GROUP BY (k, x), then agg(x) GROUP BY k.

        Mixed distinct/non-distinct (the reference plans MarkDistinct;
        here the same inner-group-by carries the non-distinct aggregates
        as decomposable partials re-aggregated outside):
            count(distinct x), sum(y) GROUP BY k
            => inner GROUP BY (k, x): sum(y) AS sy
               outer GROUP BY k:      count(x), sum(sy)
        Non-distinct aggregates must re-aggregate (sum/count/min/max);
        avg/stddev mixed with DISTINCT are rejected, as are multiple
        distinct arguments."""
        args = {a.argument for _, a in aggregations if a.distinct}
        if len(args) != 1 or None in args:
            raise AnalysisError(
                "multiple DISTINCT aggregate arguments not supported yet")
        arg = next(iter(args))
        non_distinct = [(s, a) for s, a in aggregations if not a.distinct]
        reagg = {"sum": "sum", "count": "sum", "count_star": "sum",
                 "min": "min", "max": "max", "count_if": "sum",
                 "bool_and": "bool_and", "bool_or": "bool_or",
                 "every": "every", "arbitrary": "arbitrary",
                 "any_value": "any_value"}
        inner_aggs: List[Tuple[Symbol, Aggregation]] = []
        outer_map: Dict[str, Tuple[str, Symbol]] = {}
        for s, a in non_distinct:
            outer_fn = reagg.get(a.function)
            if outer_fn is None:
                raise AnalysisError(
                    f"{a.function} cannot combine with DISTINCT "
                    "aggregates in one grouping yet")
            part = self.allocator.new_symbol(f"{s.name}_part", s.type)
            inner_aggs.append((part, Aggregation(a.function, a.argument,
                                                 False)))
            outer_map[s.name] = (outer_fn, part)
        inner = AggregationNode(pre, group_keys + [arg], inner_aggs)
        outer_aggs = []
        for s, a in aggregations:
            if a.distinct:
                outer_aggs.append((s, Aggregation(a.function, arg,
                                                  False)))
            else:
                fn, part = outer_map[s.name]
                outer_aggs.append((s, Aggregation(fn, part, False)))
        return AggregationNode(inner, group_keys, outer_aggs)

    # -- sketch aggregates (HLL / DDSketch as relational rewrites) ------

    def _plan_sketch_aggs(self, pre, group_keys, aggregations,
                          sketch_params):
        """approx_distinct / approx_percentile lowered onto the engine's
        ordinary distributed group-by/window kernels — the sketches ARE
        relational algebra, so partial/final merging and exchange
        transport come for free (reference: spi/type/setdigest HLL
        states + airlift digests; redesigned, see expr/functions.py
        sketch primitives)."""
        hlls = [(s, a) for s, a in aggregations
                if a.function == "approx_distinct"]
        pcts = [(s, a) for s, a in aggregations
                if a.function == "approx_percentile"]
        rest = [(s, a) for s, a in aggregations
                if a.function not in ("approx_distinct",
                                      "approx_percentile")]
        if pcts:
            if len(pcts) > 1 or hlls or rest:
                raise AnalysisError(
                    "approx_percentile cannot yet combine with other "
                    "aggregates in one grouping")
            s, a = pcts[0]
            return self._plan_dd_percentile(
                pre, group_keys, s, a.argument, sketch_params[s.name],
                aggregations)
        args = {a.argument for _, a in hlls}
        if len(args) != 1:
            raise AnalysisError(
                "multiple approx_distinct arguments not supported yet")
        return self._plan_hll(pre, group_keys, next(iter(args)),
                              hlls, rest, aggregations)

    def _plan_hll(self, pre, group_keys, arg, hlls, rest, aggregations):
        """HyperLogLog as two group-bys + a projection:

            inner GROUP BY (keys, j := bucket(h(x))): mx = max(rho(h(x)))
            outer GROUP BY keys: sinv = sum(0.5^mx), nz = count(mx)
            project: bias-corrected harmonic estimate

        Register merging IS the inner max aggregation, so the sketch
        merges through partial/final steps and across exchanges exactly
        like any other group-by. Non-sketch aggregates ride along as
        decomposable partials (same contract as _plan_distinct_aggs)."""
        from ..expr.functions import HLL_ALPHA, HLL_M

        B, D = T.BIGINT, T.DOUBLE
        j = self.allocator.new_symbol("hll_j", B)
        rho = self.allocator.new_symbol("hll_rho", B)
        pre2 = ProjectNode(pre, [(s, s.ref())
                                 for s in pre.output_symbols]
                           + [(j, Call(B, "$hll_bucket", (arg.ref(),))),
                              (rho, Call(B, "$hll_rho", (arg.ref(),)))])

        reagg = {"sum": "sum", "count": "sum", "count_star": "sum",
                 "min": "min", "max": "max", "count_if": "sum",
                 "bool_and": "bool_and", "bool_or": "bool_or",
                 "every": "every", "arbitrary": "arbitrary",
                 "any_value": "any_value"}
        inner_aggs = []
        mx = self.allocator.new_symbol("hll_mx", B)
        inner_aggs.append((mx, Aggregation("max", rho)))
        outer_map = {}
        for s, a in rest:
            outer_fn = reagg.get(a.function)
            if outer_fn is None:
                raise AnalysisError(
                    f"{a.function} cannot combine with approx_distinct "
                    "in one grouping yet")
            part = self.allocator.new_symbol(f"{s.name}_part", s.type)
            inner_aggs.append((part, Aggregation(a.function, a.argument,
                                                 False)))
            outer_map[s.name] = (outer_fn, part)
        inner = AggregationNode(pre2, group_keys + [j], inner_aggs)

        pw = self.allocator.new_symbol("hll_pw", D)
        mid = ProjectNode(inner, [(s, s.ref())
                                  for s in inner.output_symbols]
                          + [(pw, Call(D, "power",
                                       (Literal(D, 0.5), mx.ref())))])

        sinv = self.allocator.new_symbol("hll_sinv", D)
        nz = self.allocator.new_symbol("hll_nz", B)
        outer_aggs = [(sinv, Aggregation("sum", pw)),
                      (nz, Aggregation("count", pw))]
        for s, a in rest:
            fn, part = outer_map[s.name]
            outer_aggs.append((s, Aggregation(fn, part, False)))
        outer = AggregationNode(mid, group_keys, outer_aggs)

        # estimate: alpha*m^2 / (sinv + zeros), small-range corrected
        m_d = Literal(D, float(HLL_M))
        zeros = Call(D, "subtract",
                     (m_d, Call(D, "$cast", (nz.ref(),))))
        den = Call(D, "add", (Call(D, "$coalesce",
                                   (sinv.ref(), Literal(D, 0.0))),
                              zeros))
        raw = Call(D, "divide",
                   (Literal(D, HLL_ALPHA * HLL_M * HLL_M), den))
        small = Call(D, "multiply",
                     (m_d, Call(D, "ln", (Call(D, "divide",
                                               (m_d, zeros)),))))
        cond = Call(T.BOOLEAN, "$and", (
            Call(T.BOOLEAN, "le", (raw, Literal(D, 2.5 * HLL_M))),
            Call(T.BOOLEAN, "gt", (zeros, Literal(D, 0.0)))))
        est = Call(D, "$if", (cond, small, raw))
        out_expr = Call(B, "$cast", (Call(D, "round", (est,)),))

        assignments = [(k, k.ref()) for k in group_keys]
        for s, a in aggregations:
            if a.function == "approx_distinct":
                assignments.append((s, out_expr))
            else:
                assignments.append((s, s.ref()))
        return ProjectNode(outer, assignments)

    def _plan_dd_percentile(self, pre, group_keys, out_sym, arg, p,
                            aggregations):
        """approx_percentile as a DDSketch-style log-bucket histogram:

            inner GROUP BY (keys, b := dd_bucket(x)): c = count(x)
            window PARTITION keys ORDER b: running = sum(c) rows
                   unbounded preceding..current; total = sum(c)
            filter running >= p * total (first qualifying bucket wins)
            outer GROUP BY keys: b* = min(b);  project dd_value(b*)

        Bucket counts add across partials/exchanges (count is
        decomposable), giving a mergeable quantile sketch with ~1%
        relative error (reference analog: airlift TDigest-backed
        approx_percentile)."""
        from .plan import Ordering, WindowFunctionSpec, WindowNode

        B, D = T.BIGINT, T.DOUBLE
        b = self.allocator.new_symbol("dd_b", B)
        pre2 = ProjectNode(pre, [(s, s.ref())
                                 for s in pre.output_symbols]
                           + [(b, Call(B, "$dd_bucket", (arg.ref(),)))])
        c = self.allocator.new_symbol("dd_c", B)
        inner = AggregationNode(pre2, group_keys + [b],
                                [(c, Aggregation("count", arg))])

        running = self.allocator.new_symbol("dd_run", B)
        total = self.allocator.new_symbol("dd_tot", B)
        win = WindowNode(
            inner, list(group_keys), [Ordering(b, True)],
            [(running, WindowFunctionSpec("sum", c, frame_mode="rows",
                                          frame_start=None,
                                          frame_end=0)),
             (total, WindowFunctionSpec("sum", c,
                                        frame_mode="partition"))])

        rank = Call(D, "multiply", (Literal(D, float(p)),
                                    Call(D, "$cast", (total.ref(),))))
        qualifies = Call(T.BOOLEAN, "$and", (
            Call(T.BOOLEAN, "ge",
                 (Call(D, "$cast", (running.ref(),)), rank)),
            Call(T.BOOLEAN, "$not",
                 (Call(T.BOOLEAN, "$is_null", (b.ref(),)),))))
        empty_group = Call(T.BOOLEAN, "$and", (
            Call(T.BOOLEAN, "$is_null", (b.ref(),)),
            Call(T.BOOLEAN, "eq", (total.ref(), Literal(B, 0)))))
        filt = FilterNode(win, Call(T.BOOLEAN, "$or",
                                    (qualifies, empty_group)))

        bstar = self.allocator.new_symbol("dd_bstar", B)
        outer = AggregationNode(filt, list(group_keys),
                                [(bstar, Aggregation("min", b))])

        val = Call(D, "$dd_value", (bstar.ref(),))
        if out_sym.type in (T.TINYINT, T.SMALLINT, T.INTEGER,
                            T.BIGINT):
            out_expr = Call(out_sym.type, "$cast",
                            (Call(D, "round", (val,)),))
        elif out_sym.type.is_decimal:
            out_expr = Call(out_sym.type, "$cast", (val,))
        else:
            out_expr = val
        assignments = [(k, k.ref()) for k in group_keys]
        assignments.append((out_sym, out_expr))
        return ProjectNode(outer, assignments)

    def _frame_spec(self, window: ast.Window):
        """(mode, frame_start, frame_end): mode 'partition'/'range'/'rows'
        with ROWS bounds as row offsets (negative = PRECEDING, None =
        UNBOUNDED). RANGE supports only UNBOUNDED/CURRENT bounds (value
        offsets need per-partition searchsorted — not implemented)."""
        if window.frame is None:
            return ("range" if window.order_by else "partition",
                    None, 0)
        ftype, start, end = window.frame

        def bound(text: str):
            if text == "UNBOUNDED PRECEDING":
                return None, "start"
            if text == "UNBOUNDED FOLLOWING":
                return None, "end"
            if text == "CURRENT ROW":
                return 0, None
            n, d = text.rsplit(" ", 1)
            try:
                k = int(n)
            except ValueError:
                raise AnalysisError(
                    f"window frame offset must be an integer literal, "
                    f"got {n!r}")
            return (-k if d == "PRECEDING" else k), None

        s, s_side = bound(start)
        e, e_side = bound(end)
        if s_side == "end":
            raise AnalysisError("frame start cannot be UNBOUNDED FOLLOWING")
        if e_side == "start":
            raise AnalysisError("frame end cannot be UNBOUNDED PRECEDING")
        if s is not None and e is not None and s > e:
            # Trino: "frame starting from following row cannot end with
            # current row" etc. — a statically-empty frame is a typo
            raise AnalysisError(
                f"window frame start ({start}) cannot be after frame "
                f"end ({end})")
        if s is None and e is None:
            return "partition", None, None
        if ftype.lower() == "range":
            if not (s is None and e == 0):
                raise AnalysisError(
                    "RANGE frames support only UNBOUNDED PRECEDING AND "
                    "CURRENT ROW")
            return "range", None, 0
        return "rows", s, e

    # ------------------------------------------------------------------
    # WHERE + subqueries

    def plan_where(self, rp: RelationPlan,
                   where: ast.Expression) -> RelationPlan:
        state = _HookState(rp)
        residual: List[RowExpression] = []
        for cj in ast_conjuncts(where):
            planned = self.plan_filter_conjunct(state, cj)
            if planned is not None:
                residual.append(planned)
        rp = state.rp
        pred = combine_conjuncts(residual)
        node = rp.node
        if pred is not None:
            node = FilterNode(node, coerce(pred, T.BOOLEAN))
        return RelationPlan(node, rp.scope)

    def plan_filter_conjunct(self, state: "_HookState",
                             cj: ast.Expression) -> Optional[RowExpression]:
        """Returns a residual predicate, or None if the conjunct became a
        join. (Reference analog: SubqueryPlanner handling of IN/EXISTS.)"""
        if isinstance(cj, ast.InSubquery):
            self._plan_in_subquery(state, cj, negated=False)
            return None
        if isinstance(cj, ast.NotExpression) and \
                isinstance(cj.value, ast.InSubquery):
            self._plan_in_subquery(state, cj.value, negated=True)
            return None
        if isinstance(cj, ast.ExistsPredicate):
            self._plan_exists(state, cj.query, negated=False)
            return None
        if isinstance(cj, ast.NotExpression) and \
                isinstance(cj.value, ast.ExistsPredicate):
            self._plan_exists(state, cj.value.query, negated=True)
            return None
        analyzer = ExpressionAnalyzer(
            state.rp.scope, self.ctx.session,
            subquery_hook=self._scalar_subquery_hook(state))
        return coerce(analyzer.analyze(cj), T.BOOLEAN)

    # -- IN (subquery) → semi/anti join --------------------------------

    def _plan_in_subquery(self, state: "_HookState", e: ast.InSubquery,
                          negated: bool):
        analyzer = ExpressionAnalyzer(state.rp.scope, self.ctx.session)
        value = analyzer.analyze(e.value)
        sub = self.plan_correlated_query(e.query, state.rp.scope)
        vis = sub.plan.scope.visible_fields()
        if len(vis) != 1:
            raise AnalysisError("IN subquery must return one column")
        inner_sym = vis[0].symbol
        # coerce both sides to common type
        ct = common_type(value.type, inner_sym.type, "IN")
        sub_node = sub.plan.node
        if inner_sym.type != ct:
            cast_sym = self.allocator.new_symbol(inner_sym.name, ct)
            sub_node = ProjectNode(sub_node, [
                (cast_sym, coerce(inner_sym.ref(), ct))] + [
                (s, s.ref()) for s in sub_node.output_symbols
                if s != inner_sym])
            inner_sym = cast_sym
        probe_node = state.rp.node
        probe_node, value_sym = _ensure_symbol(
            self, probe_node, coerce(value, ct), None)
        criteria = [(value_sym, inner_sym)]
        for outer_sym, inner_s in sub.equi_pairs:
            criteria.append((outer_sym, inner_s))
        if sub.residual is not None:
            raise AnalysisError(
                "correlated IN with non-equi correlation not supported")
        node: PlanNode = JoinNode("anti" if negated else "semi", probe_node,
                                  sub_node, criteria)
        if negated and not sub.equi_pairs:
            # NULL-aware NOT IN (uncorrelated): x NOT IN S is TRUE only
            # when S is empty, or x is non-NULL and S has no NULLs.
            # Join a one-row (count(*), count(key)) aggregate of the
            # subquery and filter (reference: null-aware anti join via
            # TransformCorrelated... rules + semi-join rewrites).
            cnt_all = self.allocator.new_symbol("in_cnt", T.BIGINT)
            cnt_key = self.allocator.new_symbol("in_cnt_nonnull", T.BIGINT)
            agg = AggregationNode(sub_node, [], [
                (cnt_all, Aggregation("count_star", None)),
                (cnt_key, Aggregation("count", inner_sym))])
            node, pk = _ensure_symbol(self, node, Literal(T.BIGINT, 0), None)
            agg2, sk = _ensure_symbol(self, agg, Literal(T.BIGINT, 0), None)
            node = JoinNode("left", node, agg2, [(pk, sk)])
            empty = Call(T.BOOLEAN, "eq",
                         (cnt_all.ref(), Literal(T.BIGINT, 0)))
            value_ok = Call(T.BOOLEAN, "$not", (
                Call(T.BOOLEAN, "$is_null", (value_sym.ref(),)),))
            no_nulls = Call(T.BOOLEAN, "eq", (cnt_all.ref(), cnt_key.ref()))
            node = FilterNode(node, Call(T.BOOLEAN, "$or", (
                empty, Call(T.BOOLEAN, "$and", (value_ok, no_nulls)))))
        state.rp = RelationPlan(node, Scope(state.rp.scope.fields,
                                            state.rp.scope.parent))

    # -- EXISTS → semi/anti join ---------------------------------------

    def _plan_exists(self, state: "_HookState", q: ast.Query,
                     negated: bool):
        sub = self.plan_correlated_query(q, state.rp.scope)
        probe_node = state.rp.node
        criteria: List[Tuple[Symbol, Symbol]] = list(sub.equi_pairs)
        sub_node = sub.plan.node
        if not criteria:
            # uncorrelated EXISTS: semi join on a constant key
            probe_node, pk = _ensure_symbol(
                self, probe_node, Literal(T.BIGINT, 0), None)
            sub_node, sk = _ensure_symbol(
                self, sub_node, Literal(T.BIGINT, 0), None)
            criteria = [(pk, sk)]
        node = JoinNode("anti" if negated else "semi", probe_node, sub_node,
                        criteria, sub.residual)
        state.rp = RelationPlan(node, Scope(state.rp.scope.fields,
                                            state.rp.scope.parent))

    # -- scalar subqueries ---------------------------------------------

    def _scalar_subquery_hook(self, state: "_HookState"):
        def hook(analyzer: ExpressionAnalyzer, e):
            if isinstance(e, ast.ScalarSubquery):
                return self._plan_scalar_subquery(state, e.query)
            if isinstance(e, ast.QuantifiedComparison):
                return self._plan_quantified(state, e)
            raise AnalysisError(
                f"{type(e).__name__} only supported as a top-level WHERE "
                "conjunct")

        return hook

    def _plan_scalar_subquery(self, state: "_HookState",
                              q: ast.Query) -> RowExpression:
        sub = self.plan_correlated_query(q, state.rp.scope)
        vis = sub.plan.scope.visible_fields()
        if len(vis) != 1:
            raise AnalysisError("scalar subquery must return one column")
        result_sym = vis[0].symbol

        if not sub.equi_pairs and sub.residual is None:
            # uncorrelated: enforce single row, cross join (via const key)
            sub_node = EnforceSingleRowNode(sub.plan.node)
            probe_node, pk = _ensure_symbol(
                self, state.rp.node, Literal(T.BIGINT, 0), None)
            sub_node, sk = _ensure_symbol(
                self, sub_node, Literal(T.BIGINT, 0), None)
            join = JoinNode("left", probe_node, sub_node, [(pk, sk)])
        else:
            # correlated: the subquery must be a grouped-by-correlation
            # aggregate (decorrelation); group by the inner equi symbols
            if sub.agg_info is None:
                raise AnalysisError(
                    "correlated scalar subquery must be an aggregate")
            if sub.residual is not None:
                raise AnalysisError(
                    "correlated scalar subquery with non-equi correlation "
                    "not supported")
            join = JoinNode("left", state.rp.node, sub.plan.node,
                            list(sub.equi_pairs))
        new_fields = state.rp.scope.fields + [
            FieldDef(None, s, hidden=True)
            for s in (join.right.output_symbols)]
        state.rp = RelationPlan(join, Scope(new_fields,
                                            state.rp.scope.parent))
        if sub.count_output:
            # a correlated count over an empty group is 0, not the left
            # join's NULL (reference:
            # TransformCorrelatedScalarAggregationToJoin's coalesce)
            return Call(result_sym.type, "$coalesce",
                        (result_sym.ref(),
                         Literal(result_sym.type, 0)))
        return result_sym.ref()

    def _plan_quantified(self, state: "_HookState",
                         e: ast.QuantifiedComparison) -> RowExpression:
        """x <op> ALL/ANY (subquery) → compare against min/max of the
        subquery (valid for these comparison operators; NULL-element edge
        cases follow from NULL aggregate results. Reference:
        iterative/rule/TransformQuantifiedComparisonApplyToCorrelatedJoin)."""
        op = e.op
        quant = e.quantifier.upper()
        if quant in ("ANY", "SOME"):
            agg = {"<": "max", "<=": "max", ">": "min", ">=": "min"}.get(op)
        else:  # ALL
            agg = {"<": "min", "<=": "min", ">": "max", ">=": "max"}.get(op)
        if agg is None:
            raise AnalysisError(f"{op} {quant} (subquery) not supported")

        def subquery_with(call: ast.FunctionCall) -> ast.Query:
            return ast.Query(body=ast.QuerySpecification(
                select_items=(ast.SingleColumn(call),),
                from_=ast.AliasedRelation(ast.SubqueryRelation(e.query),
                                          "q_sub", ("q_col",))))

        val = self._plan_scalar_subquery(state, subquery_with(
            ast.FunctionCall(agg, (ast.Identifier("q_col"),))))
        analyzer = ExpressionAnalyzer(state.rp.scope, self.ctx.session)
        left = analyzer.analyze(e.value)
        from ..sql.analyzer import _COMPARISON_FN

        ct = common_type(left.type, val.type, op)
        cmp = Call(T.BOOLEAN, _COMPARISON_FN[op],
                   (coerce(left, ct), coerce(val, ct)))
        if quant == "ALL":
            # x op ALL (empty set) is TRUE; the NULL min/max would wrongly
            # filter the row, so guard with count(*) = 0
            cnt = self._plan_scalar_subquery(state, subquery_with(
                ast.FunctionCall("count", ())))
            empty = Call(T.BOOLEAN, "eq", (cnt, Literal(T.BIGINT, 0)))
            return Call(T.BOOLEAN, "$or", (empty, cmp))
        # ANY over an empty set is FALSE; the NULL aggregate makes cmp
        # NULL, which filters identically in predicate context
        return cmp

    # ------------------------------------------------------------------
    # correlated subquery planning + decorrelation

    def plan_correlated_query(self, q: ast.Query,
                              outer_scope: Scope) -> "CorrelatedSub":
        """Plan a (possibly correlated) subquery: correlated equality
        conjuncts in its WHERE become (outer_symbol, inner_symbol) join
        pairs; other correlated conjuncts become a residual expression
        over outer+inner symbols. Correlated aggregates are re-grouped by
        the correlation keys (classic decorrelation; reference:
        TransformCorrelatedScalarAggregationToJoin)."""
        body = q.body
        if not isinstance(body, ast.QuerySpecification) or q.with_queries:
            rp = self.plan_query(q, outer_scope)
            return CorrelatedSub(rp, [], None, None)

        spec = body
        # plan FROM with the outer scope as parent (enables correlation)
        if spec.from_ is None:
            rp = RelationPlan(ValuesNode([], [[]]), Scope([], outer_scope))
        else:
            rp = self.plan_relation(spec.from_, outer_scope)

        equi_pairs: List[Tuple[Symbol, Symbol]] = []
        residual_parts: List[RowExpression] = []

        state = _HookState(rp)
        for cj in ast_conjuncts(spec.where):
            analyzer = ExpressionAnalyzer(
                state.rp.scope, self.ctx.session,
                subquery_hook=self._scalar_subquery_hook(state))
            if isinstance(cj, (ast.InSubquery, ast.ExistsPredicate)) or (
                    isinstance(cj, ast.NotExpression) and isinstance(
                        cj.value, (ast.InSubquery, ast.ExistsPredicate))):
                # nested relational subquery inside a subquery
                planned = self.plan_filter_conjunct(state, cj)
                assert planned is None
                continue
            expr = analyzer.analyze(cj)
            if not analyzer.outer_references:
                # apply as local filter right away (keeps decorrelation
                # independent of later joins)
                state.rp = RelationPlan(
                    FilterNode(state.rp.node, coerce(expr, T.BOOLEAN)),
                    state.rp.scope)
                continue
            inner_syms = {s.name for s in state.rp.node.output_symbols}
            pair = _correlated_equi_pair(expr, inner_syms)
            if pair is not None:
                outer_sym, inner_sym = pair
                equi_pairs.append((outer_sym, inner_sym))
            else:
                residual_parts.append(expr)
        rp = state.rp

        agg_info = None
        agg_calls: List[ast.FunctionCall] = []
        select_exprs: List[Tuple] = []
        for item in spec.select_items:
            if isinstance(item, ast.AllColumns):
                for f in rp.scope.visible_fields():
                    select_exprs.append((None, f.name, f))
            else:
                select_exprs.append((item.expression, item.alias, None))
                agg_calls.extend(find_aggregates(item.expression))
        if spec.having is not None:
            agg_calls.extend(find_aggregates(spec.having))

        if agg_calls or spec.group_by is not None:
            # group by: declared keys + correlation keys
            group_exprs = self.resolve_group_by(spec, select_exprs) or []
            rp2, replacements = self.plan_aggregation(
                rp, group_exprs, agg_calls, select_exprs)
            # extend grouping with inner correlation symbols
            agg_node = rp2.node
            assert isinstance(agg_node, AggregationNode)
            pre = agg_node.source
            inner_agg = None
            if isinstance(pre, AggregationNode):
                # single-distinct rewrite inserted a grouping level
                inner_agg = pre
                pre = inner_agg.source
            assert isinstance(pre, ProjectNode)
            for outer_sym, inner_sym in equi_pairs:
                if not any(s.name == inner_sym.name
                           for s, _ in pre.assignments):
                    pre.assignments.append((inner_sym, inner_sym.ref()))
                if inner_agg is not None and \
                        inner_sym not in inner_agg.group_keys:
                    inner_agg.group_keys.append(inner_sym)
                if inner_sym not in agg_node.group_keys:
                    agg_node.group_keys.append(inner_sym)
            rp2 = RelationPlan(agg_node, Scope(
                rp2.scope.fields + [
                    FieldDef(None, s, hidden=True)
                    for s in agg_node.group_keys
                    if not any(f.symbol == s for f in rp2.scope.fields)],
                outer_scope))
            if spec.having is not None:
                an = ExpressionAnalyzer(rp2.scope, self.ctx.session,
                                        replacements=replacements)
                rp2 = RelationPlan(
                    FilterNode(rp2.node,
                               coerce(an.analyze(spec.having), T.BOOLEAN)),
                    rp2.scope)
            # project select list
            an = ExpressionAnalyzer(rp2.scope, self.ctx.session,
                                    replacements=replacements)
            assignments = []
            out_fields = []
            for e, alias, _f in select_exprs:
                expr = an.analyze(e) if e is not None else None
                if expr is None:
                    raise AnalysisError("* not allowed in aggregate "
                                        "subquery")
                name = alias.lower() if alias else _derive_name(e)
                sym = self.allocator.new_symbol(name or "expr", expr.type)
                assignments.append((sym, expr))
                out_fields.append(FieldDef(name, sym))
            # keep correlation keys in the projection (hidden)
            for _, inner_sym in equi_pairs:
                assignments.append((inner_sym, inner_sym.ref()))
                out_fields.append(FieldDef(None, inner_sym, hidden=True))
            proj = ProjectNode(rp2.node, assignments)
            plan = RelationPlan(proj, Scope(out_fields, outer_scope))
            agg_info = True
            if residual_parts:
                raise AnalysisError(
                    "correlated aggregate with non-equi correlation not "
                    "supported")
            count_syms = {s.name for s, a in agg_node.aggregations
                          if a.function in ("count", "count_star")}
            count_output = (
                len([f for f in out_fields if not f.hidden]) == 1
                and isinstance(assignments[0][1], SymbolRef)
                and assignments[0][1].name in count_syms)
            return CorrelatedSub(plan, equi_pairs, None, agg_info,
                                 count_output)

        # non-aggregate subquery (EXISTS / IN bodies)
        an = ExpressionAnalyzer(rp.scope, self.ctx.session)
        assignments = []
        out_fields = []
        for e, alias, fld in select_exprs:
            if e is None:
                assignments.append((fld.symbol, fld.symbol.ref()))
                out_fields.append(FieldDef(fld.name, fld.symbol))
                continue
            expr = an.analyze(e)
            name = alias.lower() if alias else _derive_name(e)
            sym = self.allocator.new_symbol(name or "expr", expr.type)
            assignments.append((sym, expr))
            out_fields.append(FieldDef(name, sym))
        # carry correlation keys + residual-referenced inner symbols
        needed: Set[str] = set()
        if residual_parts:
            for part in residual_parts:
                needed |= referenced_symbols(part)
        inner_syms_set = {s.name: s for s in rp.node.output_symbols}
        for _, inner_sym in equi_pairs:
            needed.add(inner_sym.name)
        for nm in sorted(needed):
            s = inner_syms_set.get(nm)
            if s is not None and not any(a[0].name == nm
                                         for a in assignments):
                assignments.append((s, s.ref()))
                out_fields.append(FieldDef(None, s, hidden=True))
        proj = ProjectNode(rp.node, assignments)
        plan = RelationPlan(proj, Scope(out_fields, outer_scope))
        residual = combine_conjuncts(residual_parts) if residual_parts \
            else None
        return CorrelatedSub(plan, equi_pairs, residual, None)

    # ------------------------------------------------------------------
    # ORDER BY / LIMIT

    def plan_order_limit(self, rp: RelationPlan,
                         order_by: Sequence[ast.SortItem],
                         limit: Optional[int], offset: int,
                         replacements: Dict,
                         source_scope: Optional[Scope] = None,
                         proj_node: Optional[ProjectNode] = None
                         ) -> RelationPlan:
        """Sort keys resolve against output aliases first, then (when a
        projection is available to extend) the pre-projection scope —
        hidden sort symbols ride through the projection (reference:
        QueryPlanner ORDER BY handling with hidden symbols)."""
        vis = rp.scope.visible_fields()
        orderings: List[Ordering] = []
        for si in order_by:
            sym = None
            if isinstance(si.key, ast.LongLiteral):
                idx = si.key.value - 1
                if not (0 <= idx < len(vis)):
                    raise AnalysisError(
                        f"ORDER BY position {si.key.value} out of range")
                sym = vis[idx].symbol
            elif isinstance(si.key, ast.Identifier):
                name = si.key.name.lower()
                for f in vis:
                    if f.name == name:
                        sym = f.symbol
                        break
            if sym is None:
                expr = None
                try:
                    analyzer = ExpressionAnalyzer(
                        rp.scope, self.ctx.session,
                        replacements=replacements)
                    expr = analyzer.analyze(si.key)
                except AnalysisError:
                    if source_scope is None:
                        raise
                if expr is None:
                    analyzer = ExpressionAnalyzer(
                        source_scope, self.ctx.session,
                        replacements=replacements)
                    expr = analyzer.analyze(si.key)
                if isinstance(expr, SymbolRef) and any(
                        f.symbol.name == expr.name for f in rp.scope.fields):
                    sym = Symbol(expr.name, expr.type)
                elif proj_node is not None:
                    # evaluate within the projection, keep hidden. The
                    # expression may reference projection OUTPUTS (select
                    # aliases) — inline those through the assignments so
                    # it only names the projection's source symbols
                    out_map = {s.name: e for s, e in proj_node.assignments}
                    expr = rewrite_symbols(expr, out_map)
                    if isinstance(expr, SymbolRef):
                        sym = Symbol(expr.name, expr.type)
                        if not any(s.name == sym.name
                                   for s, _ in proj_node.assignments):
                            proj_node.assignments.append((sym, expr))
                    else:
                        sym = self.allocator.new_symbol("orderkey",
                                                        expr.type)
                        proj_node.assignments.append((sym, expr))
                else:
                    raise AnalysisError(
                        f"ORDER BY key not in output: {si.key!r}")
            if not sym.type.orderable:
                raise AnalysisError(
                    f"type {sym.type} is not orderable")
            orderings.append(Ordering(sym, si.ascending, si.nulls_last))
        node = rp.node
        if limit is not None and offset == 0:
            node = TopNNode(node, orderings, limit)
        else:
            node = SortNode(node, orderings)
            if limit is not None or offset:
                node = LimitNode(node, limit, offset)
        return RelationPlan(node, rp.scope)

    # ------------------------------------------------------------------
    # set operations

    def plan_set_operation(self, op: ast.SetOperation,
                           outer_scope: Optional[Scope]) -> RelationPlan:
        left = self._plan_body(op.left, outer_scope)
        right = self._plan_body(op.right, outer_scope)
        lv = left.scope.visible_fields()
        rv = right.scope.visible_fields()
        if len(lv) != len(rv):
            raise AnalysisError(
                f"{op.op} inputs have different column counts")
        col_types = []
        for lf, rf in zip(lv, rv):
            col_types.append(common_type(lf.symbol.type, rf.symbol.type,
                                         op.op))
        lnode = _coerce_outputs(self, left, col_types)
        rnode = _coerce_outputs(self, right, col_types)
        symbols = [self.allocator.new_symbol(lv[i].name or f"col{i}",
                                             col_types[i])
                   for i in range(len(col_types))]
        kind = op.op.upper()
        if kind == "UNION":
            node: PlanNode = UnionNode(symbols, [lnode, rnode])
            if op.distinct:
                node = DistinctNode(node)
        elif kind == "INTERSECT":
            node = IntersectNode(symbols, [lnode, rnode])
        else:
            node = ExceptNode(symbols, [lnode, rnode])
        fields = [FieldDef(lv[i].name, symbols[i])
                  for i in range(len(symbols))]
        return RelationPlan(node, Scope(fields, outer_scope))

    def _plan_body(self, body, outer_scope) -> RelationPlan:
        if isinstance(body, ast.QuerySpecification):
            return self.plan_query_spec(body, outer_scope)
        if isinstance(body, ast.SetOperation):
            return self.plan_set_operation(body, outer_scope)
        if isinstance(body, ast.Values):
            return self.plan_values(body, outer_scope)
        if isinstance(body, ast.Query):
            return self.plan_query(body, outer_scope)
        raise AnalysisError(
            f"unsupported set-operation input {type(body).__name__}")


class CorrelatedSub:
    def __init__(self, plan: RelationPlan,
                 equi_pairs: List[Tuple[Symbol, Symbol]],
                 residual: Optional[RowExpression],
                 agg_info, count_output: bool = False):
        self.plan = plan
        self.equi_pairs = equi_pairs
        self.residual = residual
        self.agg_info = agg_info
        # single visible output is a bare count aggregate (needs
        # coalesce-to-0 under a decorrelating left join)
        self.count_output = count_output


class _HookState:
    """Mutable current-relation holder shared with subquery hooks."""

    def __init__(self, rp: RelationPlan):
        self.rp = rp


# ---------------------------------------------------------------------------
# helpers


def _derive_name(e: ast.Expression) -> Optional[str]:
    if isinstance(e, ast.Identifier):
        return e.name.lower()
    if isinstance(e, ast.DereferenceExpression):
        return e.field_name.lower()
    if isinstance(e, ast.FunctionCall):
        return e.name.lower()
    return None


def _as_equi_pair(e: RowExpression, left_syms: Set[str],
                  right_syms: Set[str]):
    """eq(x, y) with x from one side, y from the other →
    (left_sym, right_sym, left_expr, right_expr)."""
    if not (isinstance(e, Call) and e.name == "eq"):
        return None
    a, b = e.args
    ra, rb = referenced_symbols(a), referenced_symbols(b)
    if ra and ra <= left_syms and rb and rb <= right_syms:
        pass
    elif ra and ra <= right_syms and rb and rb <= left_syms:
        a, b = b, a
        ra, rb = rb, ra
    else:
        return None
    lsym = Symbol(a.name, a.type) if isinstance(a, SymbolRef) else None
    rsym = Symbol(b.name, b.type) if isinstance(b, SymbolRef) else None
    return lsym, rsym, a, b


def _correlated_equi_pair(e: RowExpression, inner_syms: Set[str]):
    """eq(outer_sym, inner_sym) → (outer, inner) or None."""
    if not (isinstance(e, Call) and e.name == "eq"):
        return None
    a, b = e.args
    if not (isinstance(a, SymbolRef) and isinstance(b, SymbolRef)):
        return None
    if a.name in inner_syms and b.name not in inner_syms:
        a, b = b, a
    if b.name in inner_syms and a.name not in inner_syms:
        return Symbol(a.name, a.type), Symbol(b.name, b.type)
    return None


def _ensure_symbol(planner: QueryPlanner, node: PlanNode,
                   expr: RowExpression, sym: Optional[Symbol]
                   ) -> Tuple[PlanNode, Symbol]:
    """Make sure ``expr`` is available as a symbol of ``node``, adding a
    projection if needed."""
    if isinstance(expr, SymbolRef) and any(
            s.name == expr.name for s in node.output_symbols):
        return node, Symbol(expr.name, expr.type)
    if sym is not None and any(s.name == sym.name
                               for s in node.output_symbols):
        return node, sym
    new_sym = planner.allocator.new_symbol("expr", expr.type)
    proj = ProjectNode(node, [(s, s.ref()) for s in node.output_symbols]
                       + [(new_sym, expr)])
    return proj, new_sym


def _coerce_outputs(planner: QueryPlanner, rp: RelationPlan,
                    types_: List[T.Type]) -> PlanNode:
    vis = rp.scope.visible_fields()
    if all(f.symbol.type == t for f, t in zip(vis, types_)):
        # still need visible-only projection if hidden fields exist
        if len(vis) == len(rp.node.output_symbols):
            return rp.node
    assignments = []
    for f, t in zip(vis, types_):
        if f.symbol.type == t:
            assignments.append((f.symbol, f.symbol.ref()))
        else:
            sym = planner.allocator.new_symbol(f.name or "col", t)
            assignments.append((sym, coerce(f.symbol.ref(), t)))
    return ProjectNode(rp.node, assignments)
