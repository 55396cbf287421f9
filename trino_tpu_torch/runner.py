"""LocalQueryRunner: the whole engine (parser -> planner -> operators) in
one process, on one torch device, with its serving layer.

Reference analog: ``core/trino-main/.../testing/LocalQueryRunner.java:254``
— the single-node engine. The path is the JAX engine's
(``trino_tpu/runner.py``): admission (resource groups), access control
and query events around each statement; the result cache, the plan
cache, plan templates (one optimized plan per statement shape, literals
bound as ``ParamRef`` parameters) and the shared processor cache on the
hot path; admission batching (``execute_batch``), whose same-shape
members run as one burst per pipeline stage (``exec/batched.py``); and
the ``system`` catalog over this runner's live state. It runs every
one-device statement of the JAX engine: queries (scans with dynamic
filters from join builds, filter/project, UNNEST, aggregation, DISTINCT,
hash joins with the sorted-index and matmul strategies and the hybrid
build under memory pressure, UNION/INTERSECT/EXCEPT, scalar subqueries,
window functions, grouped top-N, sort, TopN, limit/offset), CTAS and
INSERT, CREATE/DROP TABLE, DELETE (memory connector), SHOW SESSION/
CATALOGS/SCHEMAS/TABLES/COLUMNS, SET SESSION, EXPLAIN and EXPLAIN
ANALYZE (VERBOSE included).

Around execution, as in the JAX engine: history-based statistics
(``hbo_enabled``, on by default — a statement's recorded per-node
actuals steer its next planning, size its admission and its burst
depth, and a material misestimate drops its cached plans), the program
profiler (``query_profiling_enabled`` and EXPLAIN ANALYZE VERBOSE:
per-program calls and CUDA-event spans on the card, which hold the
device's idle time when the host is behind: ``telemetry/profiler.py``)
and the slow-query log (``slow_query_log_threshold``, into
``system.runtime.queries.slow``).

The device is explicit: ``device`` defaults to ``"cuda"``, and a runner
asked for CUDA on a machine without a GPU raises instead of running on
the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import types as T
from .connectors.spi import Connector
from .exec.local_planner import LocalExecutionPlanner, grouping_options
from .planner.logical_planner import LogicalPlanner, Metadata
from .planner.optimizer import optimize
from .planner.plan import OutputNode, plan_tree_str
from .sql import ast
from .sql.analyzer import AnalysisError, Session


@dataclass
class QueryResult:
    column_names: List[str]
    types: List[T.Type]
    rows: List[tuple]
    stats: Optional[dict] = None

    def only_value(self):
        assert len(self.rows) == 1 and len(self.rows[0]) == 1, self.rows
        return self.rows[0][0]


class LocalQueryRunner:
    def __init__(self, connectors: Dict[str, Connector],
                 session: Optional[Session] = None,
                 desired_splits: int = 4, device="cuda",
                 access_control=None,
                 event_listeners: Optional[Sequence] = None,
                 resource_groups=None,
                 result_cache_bytes: int = 64 << 20):
        from .cache import QueryCache
        from .events import EventListenerManager
        from .security import ALLOW_ALL

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise T.DeviceUnavailableError(
                "LocalQueryRunner: device 'cuda' requested but no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        connectors = dict(connectors)
        if "system" not in connectors:
            # the system catalog serves THIS runner's live state
            # (system.runtime.queries/tasks/metrics)
            from .connectors.system import SystemConnector

            connectors["system"] = SystemConnector(source=self)
        self.metadata = Metadata(connectors)
        self.session = session or Session(
            catalog=next(iter(connectors), None))
        self.desired_splits = desired_splits
        self.access_control = access_control or ALLOW_ALL
        self.event_manager = EventListenerManager(
            list(event_listeners or ()))
        self.resource_groups = resource_groups
        # plan + result + shared-processor caches (cache.py), gated per
        # query by plan_cache_enabled / result_cache_enabled
        self.query_cache = QueryCache(
            self.metadata, result_cache_bytes=result_cache_bytes)
        #: sidecar paths already loaded into the process-wide history
        #: store (telemetry.stats_store) — load once per path
        self._hbo_loaded: set = set()

    def _scan_refs(self, root: OutputNode) -> List[tuple]:
        """Every scanned ``(catalog, schema, table, columns)`` of a plan
        — the access-check unit, also stored beside cached results so a
        cache hit re-enforces SELECT for the requesting user."""
        from .planner.plan import TableScanNode

        out: List[tuple] = []

        def walk(node):
            if isinstance(node, TableScanNode):
                out.append((node.catalog, node.table.schema,
                            node.table.table,
                            [col.name for _, col in node.assignments]))
            for s in node.sources:
                walk(s)

        walk(root)
        return out

    def _check_table_access(self, stmt: ast.Statement, root: OutputNode,
                            user: Optional[str] = None):
        """Enforce SELECT on every scanned table with its column set
        (reference: AccessControlManager.checkCanSelectFromColumns at
        analysis time).  ``user`` is the effective tenant (protocol
        header), defaulting to the session user."""
        user = user or self.session.user
        for catalog, schema, table, cols in self._scan_refs(root):
            self.access_control.check_can_select(user, catalog, schema,
                                                 table, cols)

    # ------------------------------------------------------------------

    def create_plan(self, sql: str) -> OutputNode:
        from .sql.parser import parse_statement

        return self.plan_statement(parse_statement(sql))

    def plan_statement(self, stmt: ast.Statement,
                       hbo=None) -> OutputNode:
        planner = LogicalPlanner(self.metadata, self.session)
        root = planner.plan(stmt)
        return optimize(root, self.metadata, planner.allocator,
                        self.session, hbo=hbo)

    def _hbo_context(self, stmt: ast.Statement):
        """The history-based-statistics binding for one statement, or
        None (``hbo_enabled=false``, non-query statements, and
        statements over unversioned catalogs — the same exclusions the
        plan cache applies).  First use of a configured sidecar path
        loads it into the process-wide store."""
        from . import session_properties as SP

        if not SP.value(self.session, "hbo_enabled"):
            return None
        from .telemetry.stats_store import HboContext, store

        path = SP.value(self.session, "hbo_store_path")
        if path and path not in self._hbo_loaded:
            store().load(path)
            self._hbo_loaded.add(path)
        return HboContext.for_statement(
            stmt, self.session, self.metadata,
            alpha=SP.value(self.session, "hbo_ewma_alpha"))

    def _hbo_record(self, ctx, shape, root, drivers, memory_stats,
                    estimates=None) -> Optional[dict]:
        """Post-execution history recording (host-side, drivers done):
        fold fingerprint-tagged operator actuals into the store, drop
        cached plans of the shape when a decision node misestimated
        materially, and persist the sidecar when configured."""
        from . import session_properties as SP

        for d in drivers:
            d.collect_operator_metrics()
        op_stats = [st for d in drivers for st in d.stats]
        scan_rows = sum(st.output_rows for st in op_stats
                        if st.name == "TableScanOperator")
        summary = ctx.record(
            root, self.metadata, op_stats,
            peak_bytes=(memory_stats or {}).get("peak_bytes", 0),
            scan_rows=scan_rows, estimates=estimates)
        if summary and summary["material"] and shape is not None:
            self.query_cache.plans.invalidate_shape(shape)
        path = SP.value(self.session, "hbo_store_path")
        if path and summary:
            ctx.store.save(path)
        return summary

    def _record_batched_hbo(self, ctx, shape, root, result, depth: int):
        """History recording for a burst: the per-lane output row counts
        ARE the per-lane operator actuals, so every real lane records
        exactly what its serial execution would have — padding lanes
        never record, and a spilled lane records on its serial re-run
        instead (its batched counts are truncated)."""
        from . import session_properties as SP

        recorded = False
        material = False
        for lane in range(depth):
            if lane in result.spilled:
                continue
            actuals = [{"fp": sr["fp"], "name": sr["name"],
                        "rows": float(sr["rows"][lane])}
                       for sr in result.stage_rows if sr["fp"]]
            if not actuals:
                return
            try:
                summary = ctx.record_actuals(
                    root, self.metadata, actuals,
                    scan_rows=result.scan_rows)
            except Exception:
                return
            recorded = True
            material = material or bool(summary and summary["material"])
        if material and shape is not None:
            self.query_cache.plans.invalidate_shape(shape)
        path = SP.value(self.session, "hbo_store_path")
        if path and recorded:
            ctx.store.save(path)

    def explain(self, sql: str) -> str:
        """The EXPLAIN text of ``sql`` as this session would plan it now
        (history included), with the optimizer's provenance block."""
        from .planner.optimizer import provenance_lines
        from .sql.parser import parse_statement

        stmt = parse_statement(sql)
        if isinstance(stmt, ast.Explain):
            stmt = stmt.statement
        root = self.plan_statement(stmt, hbo=self._hbo_context(stmt))
        text = plan_tree_str(root)
        prov = provenance_lines(root)
        return text + ("\n" + "\n".join(prov) if prov else "")

    def execute(self, sql: str, user: Optional[str] = None,
                progress=None) -> QueryResult:
        """Admission (resource group) + access control + event firing
        around one statement (reference: DispatchManager.createQuery's
        admission path + QueryMonitor).  ``user`` overrides the session
        user for admission routing (multi-tenant protocol serving);
        ``progress`` is an optional telemetry.progress.QueryProgress
        the execution feeds live (protocol GET /v1/query/{id})."""
        user = user or self.session.user
        self.access_control.check_can_execute_query(user)
        if self.resource_groups is not None:
            from . import session_properties as SP

            group = self.resource_groups.select(user)
            # memory-aware admission: the query's budget is its charge
            # against the group's soft/hard memory limits — seeded DOWN
            # from the statement's observed peak when history knows it
            mem = SP.value(self.session, "query_max_memory_bytes")
            hinted = self._hbo_admission_bytes(sql)
            if hinted:
                mem = min(mem, hinted)
            with group.run(memory_bytes=mem):
                return self._monitored_execute(sql, user,
                                               progress=progress)
        return self._monitored_execute(sql, user, progress=progress)

    def _hbo_admission_bytes(self, sql: str) -> Optional[int]:
        """Observed-peak admission hint (2x headroom over the EWMA
        peak, floored): None when history has nothing for this
        statement under the current snapshot.  Advisory only — a parse
        error here surfaces identically on the monitored path."""
        try:
            pq = self.query_cache.parse(sql, self.session)
            if not pq.is_query:
                return None
            ctx = self._hbo_context(pq.stmt)
            if ctx is None:
                return None
            hint = ctx.statement_hint()
        except Exception:
            return None
        if not hint or not hint.get("peak_bytes"):
            return None
        return max(int(2 * hint["peak_bytes"]), 64 << 20)

    # -- plan templates ------------------------------------------------

    @staticmethod
    def _template_ineligible_reason(shape) -> Optional[str]:
        """Pre-walk guard for the SILENT value-dependence hazard: a
        GROUP BY 1 / ORDER BY 1 ordinal is a LongLiteral the shape
        turned into a Parameter, and the logical planner's
        ``isinstance(e, ast.LongLiteral)`` ordinal checks would quietly
        plan group-by-constant instead of group-by-column.  (Sites that
        REQUIRE a literal value — window offsets, VALUES rows, string
        IN lists — raise catchably during the template's trial plan
        instead, so only the silent sites need a walk.)"""
        from .cache import _walk_nodes

        for node in _walk_nodes(shape):
            if isinstance(node, ast.GroupBy):
                exprs = list(node.expressions) + \
                    [e for s in node.sets for e in s]
                if any(isinstance(e, ast.Parameter) for e in exprs):
                    return "ordinal_param"
            elif isinstance(node, ast.SortItem):
                if isinstance(node.key, ast.Parameter):
                    return "ordinal_param"
        return None

    def _plan_template(self, pq, user: str, hbo_ctx=None,
                       uses: int = 1):
        """The shape's ``cache.PlanTemplate`` — built, cached, or None
        (disabled / not yet earned / fallback).  A template plans the
        normalized shape directly: ``ast.Parameter`` markers lower to
        opaque ``ParamRef`` IR via the analyzer's template-parameter
        context, so optimizer constant folding and pushdown cannot
        specialize on a literal value.  A trial local plan runs at
        build time so every value dependence of the operators (string
        params, LIKE patterns, VALUES rows, window offsets) fails HERE
        — loudly, negative-cached by reason — never at member
        execution."""
        from . import session_properties as SP

        if not SP.value(self.session, "plan_template_enabled"):
            return None
        if not pq.is_query or not pq.literals:
            return None
        tkey = self.query_cache.template_key(pq, self.session, user=user)
        if tkey is None:
            return None
        tc = self.query_cache.templates
        total_uses = tc.note_uses(pq.shape, uses)
        seeds = None
        shape_fp = None
        if SP.value(self.session, "plan_template_seed_enabled"):
            from .cache import template_seeds
            from .telemetry.stats_store import statement_fingerprint

            # cluster-wide earn state: a process whose seed carries this
            # shape's use total rides the already-earned template on its
            # FIRST statement instead of re-earning min_shape_uses
            seeds = template_seeds()
            shape_fp = statement_fingerprint(pq.shape)
            total_uses = max(total_uses, seeds.uses(shape_fp))
            seeds.note(shape_fp, total_uses)
        hit = tc.lookup(tkey)
        if hit is not None:
            kind, val = hit
            return val if kind == "hit" else None
        hint = None
        if hbo_ctx is not None:
            try:
                hint = hbo_ctx.statement_hint()
            except Exception:
                hint = None
        if total_uses < SP.value(self.session,
                                 "batched_execution_min_shape_uses") \
                and not hint:
            return None  # not yet earned: the build trial must amortize
        max_entries = SP.value(self.session, "plan_cache_entries")
        if seeds is not None:
            seeded_reason = seeds.fallback_reason(shape_fp)
            if seeded_reason is not None:
                # another process already proved the shape
                # value-dependent: negative-cache locally without paying
                # a trial plan
                tc.store_fallback(tkey, seeded_reason, max_entries)
                return None
        reason = self._template_ineligible_reason(pq.shape)
        if reason is not None:
            tc.store_fallback(tkey, reason, max_entries)
            if seeds is not None:
                seeds.note_fallback_shape(shape_fp, reason)
            return None
        from .cache import PlanTemplate, analyze_literal_tokens
        from .expr.compiler import param_raw
        from .sql.analyzer import template_parameters

        try:
            lits = analyze_literal_tokens(pq.literals, self.session)
            ptypes = tuple(lit.type for lit in lits)
            if any(getattr(t, "is_pooled", False) for t in ptypes):
                tc.store_fallback(tkey, "string_param", max_entries)
                if seeds is not None:
                    seeds.note_fallback_shape(shape_fp, "string_param")
                return None
            with template_parameters(ptypes):
                root = self.plan_statement(pq.shape, hbo=hbo_ctx)
                # trial local plan (head literals bound): processor
                # construction is where remaining literal-value
                # dependence surfaces, catchably
                trial = self._make_local_planner(
                    processor_cache=self.query_cache.processors,
                    params={i: param_raw(t, lit.value)
                            for i, (t, lit)
                            in enumerate(zip(ptypes, lits))})
                try:
                    trial.plan(root)
                finally:
                    trial.memory_pool.close()
        except T.TrinoError:
            # AnalysisError / TypeError_ / NOT_SUPPORTED — planning or
            # compilation genuinely needs a literal value
            tc.store_fallback(tkey, "value_dependent", max_entries)
            if seeds is not None:
                seeds.note_fallback_shape(shape_fp, "value_dependent")
            return None
        template = PlanTemplate(root, ptypes,
                                scan_refs=self._scan_refs(root))
        tc.store(tkey, template, max_entries)
        return template

    def _template_binding(self, template, pq) -> Optional[Tuple]:
        """This member's literal values per ParamRef slot under
        ``template``, or None when its analyzed literal types drift
        from the template's (varchar lengths, decimal scales — a
        different-typed plan)."""
        from .cache import analyze_literal_tokens

        try:
            lits = analyze_literal_tokens(pq.literals, self.session)
        except T.TrinoError:
            return None
        if tuple(lit.type for lit in lits) != template.param_types:
            return None
        return tuple(lit.value for lit in lits)

    # -- admission batching --------------------------------------------

    def execute_batch(self, sqls: Sequence[str],
                      user: Optional[str] = None) -> List:
        """Admission batching: ONE resource-group slot covers a burst of
        (typically same-shape) statements — the dispatcher-side
        amortization for high-QPS tenants.  Same-shape deterministic
        members ride the plan template's batched path: their literal
        vectors stack on a (B,) axis and every pipeline stage runs once
        for the burst, demuxed positionally (result-cache hits
        short-circuit without occupying a lane; ACL is enforced per
        member).  Identical texts coalesce to a single execution whose
        result demuxes to every submitter; everything else executes
        serially inside the slot through the plan/processor caches.
        Returns one QueryResult OR Exception per statement,
        positionally — a failure fails only its own statement, not the
        batch."""
        user = user or self.session.user
        self.access_control.check_can_execute_query(user)
        if self.resource_groups is not None:
            from . import session_properties as SP

            group = self.resource_groups.select(user)
            with group.run(memory_bytes=SP.value(
                    self.session, "query_max_memory_bytes")):
                return self._run_batch(sqls, user)
        return self._run_batch(sqls, user)

    def _coalescable(self, sql: str) -> bool:
        # only deterministic plain queries may demux one execution to
        # several submitters: repeat INSERTs must run per statement,
        # and random()-class calls must diverge exactly as they would
        # serially
        try:
            pq = self.query_cache.parse(sql, self.session)
        except Exception:
            return False
        return pq.is_query and pq.deterministic

    def _run_batch(self, sqls: Sequence[str], user: str) -> List:
        from . import session_properties as SP

        out: List = [None] * len(sqls)
        done = [False] * len(sqls)
        coalesced = 0
        if SP.value(self.session, "batched_execution_enabled"):
            # group batchable members by shape (the protocol drains
            # same-shape bursts, but direct callers may mix)
            groups: Dict[object, List[int]] = {}
            for i, sql in enumerate(sqls):
                try:
                    pq = self.query_cache.parse(sql, self.session)
                except Exception:
                    continue  # fails identically on the serial path
                if pq.is_query and pq.deterministic and pq.literals:
                    groups.setdefault(pq.shape, []).append(i)
            for idxs in groups.values():
                if len(idxs) < 2:
                    continue  # nothing to amortize into one burst
                served = self._try_batched(
                    [(i, sqls[i]) for i in idxs], user)
                for i, res in served.items():
                    out[i] = res
                    done[i] = True
        memo: Dict[str, object] = {}
        for i, sql in enumerate(sqls):
            if done[i]:
                continue
            if sql in memo:
                coalesced += 1
                out[i] = memo[sql]
                continue
            try:
                res = self._monitored_execute(sql, user)
            except Exception as e:  # demuxed per statement
                out[i] = e
                if self._coalescable(sql):
                    memo[sql] = e
            else:
                out[i] = res
                if self._coalescable(sql):
                    memo[sql] = res
        self.query_cache.note_batch(len(out), coalesced)
        return out

    def _try_batched(self, members: List[tuple], user: str) -> Dict:
        """Attempt the one-burst path for one same-shape group.
        Returns {position: QueryResult|Exception} for every member this
        path fully handled (batched lanes, result-cache
        short-circuits, per-member ACL failures, coalesced duplicates);
        members NOT in the dict fall back to the serial loop — which
        still rides the shared template serially, so the fallback is
        slower, never different."""
        from . import session_properties as SP
        from .block import padded_size
        from .exec.batched import BatchIneligible, execute_batched

        served: Dict[int, object] = {}
        pqs = {i: self.query_cache.parse(sql, self.session)
               for i, sql in members}
        pq0 = pqs[members[0][0]]
        try:
            hbo_ctx = self._hbo_context(pq0.stmt)
        except Exception:
            hbo_ctx = None
        template = self._plan_template(pq0, user, hbo_ctx,
                                       uses=len(members))
        if template is None:
            return served
        tc = self.query_cache.templates
        result_caching = SP.value(self.session, "result_cache_enabled")
        # per-member admission: ACL, result-cache short-circuit,
        # identical-literal-vector coalescing into one lane
        lanes: List[tuple] = []       # (literals, [positions], key)
        lane_of: Dict[tuple, int] = {}
        for pos, sql in members:
            pq = pqs[pos]
            try:
                # per-tenant ACL per statement, exactly as serial
                self._check_table_access(pq.stmt, template.root, user)
            except Exception as e:
                served[pos] = e
                continue
            key = self.query_cache.cache_key(pq, self.session, user=user)
            if result_caching and key is not None:
                hit = self.query_cache.results.lookup(key)
                if hit is not None:
                    # full-key hit: serve WITHOUT occupying a lane
                    names, types_, rows, _nb, scans = hit
                    try:
                        for catalog, schema, table, cols in scans:
                            self.access_control.check_can_select(
                                user, catalog, schema, table, cols)
                    except Exception as e:
                        served[pos] = e
                        continue
                    served[pos] = QueryResult(
                        list(names), list(types_), list(rows),
                        stats={"result_cache": "hit"})
                    with self.query_cache._lock:
                        self.query_cache.result_shortcircuits += 1
                    continue
            if pq.literals in lane_of:
                lanes[lane_of[pq.literals]][1].append(pos)
            else:
                lane_of[pq.literals] = len(lanes)
                lanes.append((pq.literals, [pos], key))
        if not lanes:
            return served
        # bind each lane's literal vector; type drift falls back
        bound: List[tuple] = []       # (values, positions, key)
        for _lits, positions, key in lanes:
            values = self._template_binding(template, pqs[positions[0]])
            if values is None:
                tc.note_fallback("param_type_drift")
                continue
            bound.append((values, positions, key))
        if not bound:
            return served
        max_depth = SP.value(self.session, "batched_execution_max_depth")
        pad_limit = SP.value(self.session,
                             "batched_execution_pad_rows_limit")
        hint = None
        if hbo_ctx is not None:
            try:
                hint = hbo_ctx.statement_hint()
            except Exception:
                hint = None
        # a shape whose recorded scans are large pads no lane: a padding
        # lane would cost a whole member's work
        pad_exact = bool(hint and
                         hint.get("scan_rows", 0) >= pad_limit)
        from .expr.compiler import param_raw

        for start in range(0, len(bound), max_depth):
            chunk = bound[start:start + max_depth]
            B = len(chunk)
            depth = B if pad_exact else padded_size(B, minimum=1)
            padded = [values for values, _, _ in chunk] + \
                [chunk[-1][0]] * (depth - B)
            # operator construction binds the first lane's values (the
            # serial-fallback contract); execute_batched drives the
            # processors with the STACKED vectors instead.  hbo tags
            # the fresh operators with node fingerprints so the per-lane
            # row counts record actuals below.
            local = self._make_local_planner(
                processor_cache=self.query_cache.processors,
                hbo=hbo_ctx,
                params={i: param_raw(t, chunk[0][0][i])
                        for i, t in enumerate(template.param_types)})
            try:
                try:
                    plan = local.plan(template.root)
                    result = execute_batched(
                        plan, template.param_types, padded, B)
                except BatchIneligible as e:
                    tc.note_fallback(e.reason)
                    return served  # remaining members run serially
                except Exception as e:
                    # execution error: every lane would hit it serially
                    for _, positions, _ in chunk:
                        for pos in positions:
                            served[pos] = e
                            self._batch_member_event(
                                members, pos, user, error=e)
                    continue
            finally:
                local.memory_pool.close()
            for reason in result.dispositions:
                tc.note_disposition(reason)
            with self.query_cache._lock:
                self.query_cache.batched_launches += \
                    B - len(result.spilled)
                self.query_cache.batched_spills += len(result.spilled)
            if hbo_ctx is not None:
                self._record_batched_hbo(hbo_ctx, pq0.shape,
                                         template.root, result, B)
            for lane_i, (values, positions, key) in enumerate(chunk):
                if lane_i in result.spilled:
                    # this lane overflowed a unified per-lane capacity
                    # (join expansion or agg hash budget): it — and only
                    # it — falls back to the serial loop, which still
                    # rides the template serially
                    tc.note_fallback("lane_overflow")
                    continue
                rows: List[tuple] = []
                for p in result.pages[lane_i]:
                    rows.extend(p.to_rows())
                res = QueryResult(
                    plan.column_names, plan.output_types, rows,
                    stats={"plan_template": "hit",
                           "batched_depth": depth})
                if result_caching and key is not None and \
                        self.query_cache.cache_key(
                            pqs[positions[0]], self.session,
                            user=user) == key:
                    self.query_cache.results.store(
                        key, res.column_names, res.types, list(rows),
                        scans=template.scan_refs)
                for extra, pos in enumerate(positions):
                    served[pos] = res
                    self._batch_member_event(members, pos, user,
                                             rows=len(rows))
                    if extra:
                        # identical literal vector
                        with self.query_cache._lock:
                            self.query_cache.coalesced += 1
        return served

    def _batch_member_event(self, members, pos, user, rows=0,
                            error=None):
        """Query lifecycle events for a batched member — the serial
        path fires these through _monitored_execute, and
        system.runtime.queries must see batched statements too."""
        if not self.event_manager.listeners:
            return
        from .events import QueryMonitor

        sql = dict(members)[pos]
        monitor = QueryMonitor(self.event_manager, user, sql)
        monitor.created()
        if error is not None:
            monitor.failed(error)
        else:
            monitor.completed(rows)

    def _monitored_execute(self, sql: str, user: str,
                           progress=None) -> QueryResult:
        from .events import QueryMonitor

        monitor = QueryMonitor(self.event_manager, user, sql) \
            if self.event_manager.listeners else None
        t0 = time.perf_counter()
        if monitor:
            monitor.created()
        try:
            res = self._execute_sql(sql, user=user, progress=progress)
        except Exception as e:
            if monitor:
                monitor.failed(e)
            raise
        wall_s = time.perf_counter() - t0
        if monitor:
            # the QueryStatistics analog: peak memory + wall ride the
            # completed event into the history ring buffer that backs
            # system.runtime.queries
            stats = {
                "wall_ms": round(wall_s * 1e3, 2),
                "peak_memory_bytes": ((res.stats or {}).get("memory")
                                      or {}).get("peak_bytes", 0),
            }
            slow = self._slow_query_record(sql, wall_s, res)
            if slow is not None:
                stats["slow_query"] = slow
            monitor.completed(len(res.rows), stats=stats)
        return res

    def _slow_query_record(self, sql: str, wall_s: float,
                           res: QueryResult) -> Optional[dict]:
        """The slow-query log record when ``wall_s`` exceeds
        ``slow_query_log_threshold`` (0 = disabled): wall + threshold,
        the trace critical path when the run carried spans, the top-3
        cost-attributed operators, and the worst-Q-error plan node
        when history-based statistics recorded this run.  Rides the
        QueryCompletedEvent stats into system.runtime.queries."""
        from . import session_properties as SP

        threshold = SP.value(self.session, "slow_query_log_threshold")
        if not threshold or wall_s <= threshold:
            return None
        from .telemetry.tracing import slow_query_record

        hbo = (res.stats or {}).get("hbo") or {}
        return slow_query_record((res.stats or {}).get("trace"),
                                 wall_s * 1e3, threshold,
                                 worst_misestimate=hbo.get("worst"))

    def _execute_sql(self, sql: str, user: Optional[str] = None,
                     progress=None) -> QueryResult:
        """Run one statement (see the module docstring for the set);
        the parse is memoized, so repeat texts skip the parser."""
        user = user or self.session.user
        pq = self.query_cache.parse(sql, self.session)
        stmt = pq.stmt
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                return self._explain_analyze(stmt.statement,
                                             verbose=stmt.verbose)
            from .planner.optimizer import provenance_lines

            root = self.plan_statement(
                stmt.statement, hbo=self._hbo_context(stmt.statement))
            lines = plan_tree_str(root).splitlines()
            prov = provenance_lines(root)
            if prov:
                lines.extend([""] + prov)
            return QueryResult(["Query Plan"], [T.VARCHAR],
                               [(line,) for line in lines])
        if isinstance(stmt, ast.SetSession):
            from . import session_properties as SP
            from .exec.local_planner import _eval_literal
            from .sql.analyzer import ExpressionAnalyzer, Scope

            self.access_control.check_can_set_session_property(
                self.session.user, stmt.name)
            an = ExpressionAnalyzer(Scope([], None), self.session)
            SP.set_property(self.session.properties, stmt.name,
                            _eval_literal(an.analyze(stmt.value)))
            return QueryResult(["result"], [T.BOOLEAN], [(True,)])
        if isinstance(stmt, ast.ShowSession):
            from . import session_properties as SP

            return QueryResult(
                ["Name", "Value", "Default", "Type", "Description"],
                [T.VARCHAR] * 5, SP.listing(self.session))
        if isinstance(stmt, ast.ShowCatalogs):
            return QueryResult(["Catalog"], [T.VARCHAR],
                               [(c,) for c in
                                sorted(self.metadata.connectors)])
        if isinstance(stmt, ast.ShowSchemas):
            conn = self._connector(stmt.catalog or self.session.catalog)
            return QueryResult(["Schema"], [T.VARCHAR],
                               [(s,) for s in
                                sorted(conn.metadata().list_schemas())])
        if isinstance(stmt, ast.ShowTables):
            catalog = self.session.catalog
            schema = self.session.schema
            if stmt.schema:
                parts = stmt.schema
                schema = parts[-1]
                if len(parts) > 1:
                    catalog = parts[-2]
            conn = self._connector(catalog)
            return QueryResult(["Table"], [T.VARCHAR],
                               [(t,) for t in
                                sorted(conn.metadata().list_tables(schema))])
        if isinstance(stmt, ast.ShowColumns):
            resolved = self.metadata.resolve_table(stmt.table, self.session)
            if resolved is None:
                raise AnalysisError(
                    "table '%s' does not exist" % ".".join(stmt.table))
            _, _, _, columns = resolved
            return QueryResult(
                ["Column", "Type"], [T.VARCHAR, T.VARCHAR],
                [(c.name, str(c.type)) for c in columns])
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._drop_table(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if not isinstance(stmt, (ast.QueryStatement, ast.Insert,
                                 ast.CreateTableAsSelect)):
            raise T.TrinoError(
                f"{type(stmt).__name__} is not ported to the torch engine "
                "yet", "NOT_SUPPORTED")
        if isinstance(stmt, ast.Insert):
            catalog, _, schema, table = self.metadata.resolve_target(
                stmt.table, self.session)
            self.access_control.check_can_insert(
                user, catalog, schema, table)
        return self._execute_query(pq, stmt, user, progress=progress)

    def _execute_query(self, pq, stmt: ast.Statement, user: str,
                       progress=None) -> QueryResult:
        """The cached hot path.  Lookup order: result cache (rows, WITH
        literals) -> plan cache (optimized root, skips analyze/plan/
        optimize) -> plan template -> full planning.  Either cache key
        embeds the session fingerprint and the referenced connectors'
        snapshot versions, so SET SESSION and DDL/writes invalidate
        loudly (the key moves) instead of silently serving stale plans.
        Operator shells are re-instantiated per execution — splits,
        memory pools, and dynamic filters stay per-query — but the
        PageProcessors come from the shared cache."""
        from . import session_properties as SP

        plan_caching = SP.value(self.session, "plan_cache_enabled")
        # the effective user is part of the key: tenants must never
        # share entries (a per-user ACL would otherwise leak rows)
        key = self.query_cache.cache_key(pq, self.session, user=user) \
            if plan_caching else None
        result_caching = key is not None and pq.deterministic and \
            SP.value(self.session, "result_cache_enabled")
        if result_caching:
            hit = self.query_cache.results.lookup(key)
            if hit is not None:
                names, types_, rows, _nb, scans = hit
                # SELECT is re-enforced on EVERY hit (defense in depth
                # beside the user-scoped key): an ACL revocation must
                # take effect immediately, cached rows or not
                for catalog, schema, table, cols in scans:
                    self.access_control.check_can_select(
                        user, catalog, schema, table, cols)
                # fresh list per hit: a caller sorting rows in place
                # must not corrupt the cached copy
                if progress is not None:
                    progress.state = "FINISHED"
                return QueryResult(list(names), list(types_),
                                   list(rows),
                                   stats={"result_cache": "hit"})
        hbo_ctx = self._hbo_context(stmt)
        root = self.query_cache.plans.lookup(key) \
            if key is not None else None
        plan_hit = root is not None
        template_params: Optional[Dict] = None
        if root is None and key is not None:
            # a shape template serves EVERY literal vector of this
            # shape: one optimized root, literal values bound as
            # ParamRef inputs at execution (the same processors the
            # batched path runs).  Template roots are never stored in
            # the plan cache — plan-cache executions pass no params.
            template = self._plan_template(pq, user, hbo_ctx)
            if template is not None:
                values = self._template_binding(template, pq)
                if values is None:
                    self.query_cache.templates.note_fallback(
                        "param_type_drift")
                else:
                    from .expr.compiler import param_raw

                    template_params = {
                        i: param_raw(t, v) for i, (t, v) in
                        enumerate(zip(template.param_types, values))}
                    root = template.root
        if root is None:
            root = self.plan_statement(stmt, hbo=hbo_ctx)
            if key is not None:
                self.query_cache.plans.store(
                    key, root,
                    SP.value(self.session, "plan_cache_entries"))
        self._check_table_access(stmt, root, user)  # on EVERY run
        if progress is not None:
            # rows-based completion estimate from connector statistics
            progress.total_rows = self._scan_rows_estimate(root)
            progress.state = "RUNNING"
            if progress.total_rows == 0 and hbo_ctx is not None:
                # statistics-less connectors would report no fraction
                # forever: fall back to the rows this statement shape
                # actually scanned on previous runs
                hint = hbo_ctx.statement_hint()
                if hint and hint.get("scan_rows"):
                    progress.total_rows = int(hint["scan_rows"])
                    progress.estimate_source = "hbo"
        local = self._make_local_planner(
            processor_cache=self.query_cache.processors
            if plan_caching else None, progress=progress,
            hbo=hbo_ctx, params=template_params)
        from .telemetry.profiler import profiling

        with profiling(SP.value(self.session, "query_profiling_enabled")):
            try:
                plan = local.plan(root)
                # per-node actuals need per-operator row counts: the
                # stats-collecting driver path runs exactly when HBO
                # records
                pages = plan.execute(collect_stats=hbo_ctx is not None)
                rows: List[tuple] = []
                for p in pages:
                    rows.extend(p.to_rows())
                stats = {"memory": local.memory_pool.stats(),
                         "operators": _operator_metrics(plan.drivers)}
            finally:
                # reap spill files and free residue on success and
                # failure
                local.memory_pool.close()
        if progress is not None:
            progress.state = "FINISHED"
        if hbo_ctx is not None:
            summary = self._hbo_record(hbo_ctx, pq.shape, root,
                                       plan.drivers, stats.get("memory"))
            if summary:
                stats["hbo"] = summary
        if local.dynamic_filters:
            stats["dynamic_filters"] = [df.stats()
                                        for df in local.dynamic_filters]
        if plan_hit:
            stats["plan_cache"] = "hit"
        if template_params is not None:
            stats["plan_template"] = "hit"
        res = QueryResult(plan.column_names, plan.output_types, rows,
                          stats=stats)
        if result_caching:
            # re-derive the key AFTER execution: a write that landed
            # mid-query moved the snapshot version, and a torn read
            # must not freeze into the cache
            if self.query_cache.cache_key(pq, self.session,
                                          user=user) == key:
                self.query_cache.results.store(
                    key, res.column_names, res.types, list(rows),
                    scans=self._scan_refs(root))
        return res

    def _scan_rows_estimate(self, root: OutputNode) -> int:
        """Connector-statistics row estimate summed over the plan's
        scans — the denominator of the rows-based progress fraction
        (0 when no connector reports statistics)."""
        total = 0.0
        for catalog, schema, table, _cols in self._scan_refs(root):
            try:
                conn = self.metadata.connectors.get(catalog)
                handle = conn.metadata().get_table_handle(schema, table)
                stats = conn.metadata().get_statistics(handle)
                if stats.row_count:
                    total += stats.row_count
            except Exception:
                continue  # statistics are advisory, never fail a query
        return int(total)

    def _explain_analyze(self, stmt: ast.Statement,
                         verbose: bool = False) -> QueryResult:
        """Run the query collecting per-operator stats and render the plan,
        a ``Query:`` line, a ``Memory:`` line (peak, spills, disk files)
        and one line per operator per pipeline (reference:
        operator/ExplainAnalyzeOperator.java + PlanPrinter.java).
        VERBOSE turns the program profiler on for the run, so operator
        lines carry their programs' operations / bytes / compile ms /
        device ms and a ``Kernels:`` line says how many programs the run
        added to the registry.  With history-based statistics on, every
        fingerprinted operator line carries its estimate and Q-error, a
        worst-misestimate line renders, and the run's actuals fold into
        the history store."""
        from .telemetry import profiler

        hbo_ctx = self._hbo_context(stmt)
        root = self.plan_statement(stmt, hbo=hbo_ctx)
        self._check_table_access(stmt, root)  # ANALYZE executes the query
        local = self._make_local_planner(hbo=hbo_ctx)
        pool = local.memory_pool
        before = profiler.totals() if verbose else None
        with profiler.profiling(verbose):
            try:
                plan = local.plan(root)
                t0 = time.perf_counter()
                pages = plan.execute(collect_stats=True)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                wall = time.perf_counter() - t0
                m = pool.stats()
            finally:
                pool.close()
        out_rows = sum(p.num_rows for p in pages)
        est_map: Dict[str, float] = {}
        summary = None
        if hbo_ctx is not None:
            # estimates BEFORE recording: the Q-errors rendered below
            # must be the ones THIS run's planning actually used (the
            # same walk feeds record(), so it isn't paid twice)
            est = hbo_ctx.estimates(root, self.metadata)
            est_map = est[0]
            from .cache import normalize_statement

            shape = normalize_statement(stmt)[0] \
                if isinstance(stmt, ast.QueryStatement) else None
            summary = self._hbo_record(hbo_ctx, shape, root,
                                       plan.drivers, m, estimates=est)
        lines = plan_tree_str(root).splitlines()
        lines.append("")
        lines.append(f"Query: {wall * 1e3:.1f}ms, {out_rows} rows")
        lines.append(
            f"Memory: peak {m['peak_bytes']} bytes, "
            f"{m['spill_events']} spills ({m['spilled_bytes']} bytes)"
            + (f", disk {m['disk_spill_events']} files "
               f"({m['disk_spilled_bytes']} bytes)"
               if m.get("disk_spill_events") is not None else ""))
        for i, d in enumerate(plan.drivers):
            d.collect_operator_metrics()
            lines.append(f"Pipeline {i}:")
            for st in d.stats:
                line = "  " + st.line()
                est = est_map.get(st.node_fp) \
                    if st.node_fp is not None else None
                if est is not None:
                    from .telemetry.stats_store import q_error

                    line += (f" [est {est:.0f} rows, "
                             f"q={q_error(est, st.output_rows):.2f}]")
                lines.append(line)
        if summary and summary.get("worst"):
            w = summary["worst"]
            lines.append(
                f"Worst misestimate: {w['name']} est "
                f"{w['est_rows']:.0f} rows, actual {w['actual_rows']} "
                f"(q={w['qerror']:.2f})")
        if verbose:
            lines.append(_kernels_line(before, profiler.totals()))
        return QueryResult(["Query Plan"], [T.VARCHAR],
                           [(line,) for line in lines])

    def metrics_families(self) -> list:
        """This runner's metric families for GET /v1/metrics and
        system.runtime.metrics: process-level sources (program first
        calls, profiler totals, device memory, the history store) +
        query lifecycle counters + resource-group queue depths when
        admission control is configured + the cache, template and
        batching counters."""
        from .telemetry.metrics import MetricsRegistry, process_families

        reg = MetricsRegistry()
        states = {"FINISHED": 0, "FAILED": 0}
        for e in self.event_manager.history(10_000):
            states[e.state] = states.get(e.state, 0) + 1
        qc = reg.counter("trino_queries_total",
                         "Completed queries by terminal state")
        for state_name, n in sorted(states.items()):
            qc.inc(n, state=state_name)
        reg.gauge("trino_queries_running",
                  "Queries currently executing").set(
            len(self.event_manager.running()))
        if self.resource_groups is not None:
            g = reg.gauge("trino_resource_group_queries",
                          "Resource-group admission state "
                          "(kind=running|queued)")
            m = reg.gauge("trino_resource_group_memory_reserved_bytes",
                          "Memory budget admitted per resource group")
            for name, running, queued, mem in \
                    self.resource_groups.stats():
                g.set(running, group=name, kind="running")
                g.set(queued, group=name, kind="queued")
                m.set(mem, group=name)
            adm = reg.counter(
                "trino_resource_group_admissions_total",
                "Cumulative admission counters per resource group "
                "(kind=admitted|queued_waits); queue_peak gauges the "
                "deepest queue observed")
            pk = reg.gauge("trino_resource_group_queue_peak",
                           "Deepest admission queue observed per group")
            for name, admitted, waits, peak in \
                    self.resource_groups.counter_stats():
                adm.inc(admitted, group=name, kind="admitted")
                adm.inc(waits, group=name, kind="queued_waits")
                pk.set(peak, group=name)
        self.query_cache.add_families(reg)
        return process_families() + reg.collect()

    def _connector(self, catalog: Optional[str]) -> Connector:
        conn = self.metadata.connectors.get(catalog or "")
        if conn is None:
            raise AnalysisError(f"catalog '{catalog}' does not exist")
        return conn

    def _create_table(self, stmt: ast.CreateTable) -> QueryResult:
        from .connectors.spi import ColumnHandle

        catalog, conn, schema, table = self.metadata.resolve_target(
            stmt.name, self.session)
        self.access_control.check_can_create_table(
            self.session.user, catalog, schema, table)
        if stmt.if_not_exists and \
                conn.metadata().get_table_handle(schema, table) is not None:
            return QueryResult(["result"], [T.BOOLEAN], [(True,)])
        columns = [ColumnHandle(n.lower(), T.parse_type(t), i)
                   for i, (n, t) in enumerate(stmt.columns)]
        conn.metadata().create_table(schema, table, columns)
        return QueryResult(["result"], [T.BOOLEAN], [(True,)])

    def _drop_table(self, stmt: ast.DropTable) -> QueryResult:
        catalog, conn, schema, table = self.metadata.resolve_target(
            stmt.name, self.session)
        self.access_control.check_can_drop_table(
            self.session.user, catalog, schema, table)
        handle = conn.metadata().get_table_handle(schema, table)
        if handle is None:
            if stmt.if_exists:
                return QueryResult(["result"], [T.BOOLEAN], [(True,)])
            raise AnalysisError(
                f"table '{schema}.{table}' does not exist")
        conn.metadata().drop_table(handle)
        return QueryResult(["result"], [T.BOOLEAN], [(True,)])

    def _delete(self, stmt: ast.Delete) -> QueryResult:
        """DELETE as a real plan: the keep-query (NOT pred, null-safe) is
        built as AST — no SQL-text round trip, so identifier quoting and
        expression formatting cannot skew semantics. The kept pages go
        back through the table's canonical dictionaries and replace its
        storage, memory-connector style."""
        from .connectors.memory import MemoryConnector

        catalog, conn, schema, table = self.metadata.resolve_target(
            stmt.table, self.session)
        self.access_control.check_can_delete(
            self.session.user, catalog, schema, table)
        if not isinstance(conn, MemoryConnector):
            raise AnalysisError(
                "DELETE is only supported on the memory connector")
        if conn.metadata().get_table_handle(schema, table) is None:
            raise AnalysisError(
                f"table '{schema}.{table}' does not exist")
        data = conn.tables[(schema, table)]
        before = data.row_count
        if stmt.where is None:
            with data.lock:
                data.pages = []
            conn.bump_version()
            return QueryResult(["rows"], [T.BIGINT], [(before,)])
        keep = ast.NotExpression(ast.FunctionCall(
            "coalesce", (stmt.where, ast.BooleanLiteral(False))))
        query = ast.Query(body=ast.QuerySpecification(
            select_items=(ast.AllColumns(),),
            from_=ast.Table((catalog, schema, table)),
            where=keep))
        root = self.plan_statement(ast.QueryStatement(query))
        local = self._make_local_planner()
        try:
            res_pages = [data.canonicalize(p)
                         for p in local.plan(root).execute()]
        finally:
            local.memory_pool.close()
        with data.lock:
            data.pages = res_pages
        conn.bump_version()
        return QueryResult(["rows"], [T.BIGINT],
                           [(before - sum(p.num_rows
                                          for p in res_pages),)])

    def _splits(self) -> int:
        from . import session_properties as SP

        if "desired_splits" in self.session.properties:
            return SP.value(self.session, "desired_splits")
        return self.desired_splits

    def _make_local_planner(self, processor_cache=None, progress=None,
                            hbo=None, params=None) -> LocalExecutionPlanner:
        """Session-configured planner on this runner's device: ALL
        execution paths (execute, EXPLAIN ANALYZE, the DELETE rewrite)
        honor the same session knobs.  ``params`` binds a plan
        template's ParamRef slots (global literal index -> raw scalar)
        for one statement."""
        from . import session_properties as SP
        from .exec.memory import pool_from_session

        return LocalExecutionPlanner(
            self.metadata, self.device, self._splits(),
            memory_pool=pool_from_session(self.session),
            join_max_lanes=SP.value(self.session, "join_max_expand_lanes"),
            dynamic_filtering=SP.value(self.session,
                                       "enable_dynamic_filtering"),
            scan_coalesce=SP.value(self.session, "scan_coalesce_enabled"),
            processor_cache=processor_cache, progress=progress,
            hbo=hbo, params=params,
            **grouping_options(self.session.properties))


def _operator_metrics(drivers) -> List[dict]:
    """Each operator's name and reported metrics (the aggregation's pages
    per grouping path, ...), pipeline by pipeline."""
    out = []
    for d in drivers:
        d.collect_operator_metrics()
        out.extend(dict(st.metrics or {}, name=st.name) for st in d.stats)
    return out


def _kernels_line(before: dict, after: dict) -> str:
    """One EXPLAIN ANALYZE VERBOSE line: what this run added to the
    program registry vs reused (a repeat-shape run must show "0 new
    programs"), and the trace / compile wall it paid (torch programs
    trace and compile nothing; the kernel library's first build does)."""
    new_programs = after["programs"] - before["programs"]
    new_compiles = after["compiles"] - before["compiles"]
    compile_ms = after["compile_ms"] - before["compile_ms"]
    trace_ms = after["trace_ms"] - before["trace_ms"]
    return (f"Kernels: {after['programs']} programs in registry, "
            f"{new_programs} new, {new_compiles} compiles this run "
            f"(trace {trace_ms:.1f}ms, compile {compile_ms:.1f}ms)")
