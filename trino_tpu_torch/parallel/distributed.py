"""Distributed query execution: fragment DAG over N in-process workers
on a list of torch device slabs (one device by default).

Reference analog: ``testing/trino-testing/.../DistributedQueryRunner.java``
(N TestingTrinoServers in one JVM) driving the fragment execution of
``execution/scheduler/PipelinedQueryScheduler.java``. Here: every
fragment runs ``n_workers`` parallel tasks (generators on the shared
task executor's threads); stage boundaries are OutputBuffers fed by
PartitionedOutputOperators, or, for a hash boundary, the device exchange
(``parallel/device_exchange.py``): one program over every producer's
rows on the device, each consumer task reading its partition. Every
aggregation over a distributed input splits into a partial step before
the exchange and a final step after it, and both reduce through the
segment-reduce kernel (``ops/kernels.py``). Stages execute bottom-up
with a barrier per fragment (``streaming_execution`` off) or all at
once with streaming exchanges (on, the default).

The JAX engine's ``trino_tpu/parallel/distributed.py`` on torch. Its
``jax.devices()`` mesh is the runner's ``devices`` list (default
``[device]``, ``"cuda"`` unless the caller asks for the CPU; devices
may repeat, as ``["cuda:0"] * 4`` on one card): task t runs on
``devices[t % len(devices)]``, the slab the device exchange gives its
partition and takes its output from, so a hash boundary's consumer reads
only its own partition's slab. Tasks run on the device's current
stream, so pages handed through a buffer or the exchange need no stream
bookkeeping. In-process
workers share this process's ``cache.template_seeds()``,
``telemetry.stats_store``, the profiler and the exchange sizing history,
so history is coherent across tasks by construction.

Each statement runs in a context of its own (``_Statement``): its
tracer, spans, plan, memory pool, history binding, stats and device-read
counters, so statements in flight at once share none of them.

Tracing (``query_tracing_enabled``): a ``query`` root span, opened before
parsing; the statement spans beneath it (``span_kind`` ``statement``:
``parse``, ``plan`` with ``plan_cache_hit``, ``results``, ``history``);
one ``stage f<id>`` span per fragment, one ``task f<id>.<t>`` span per
task and the task's operator spans
(``telemetry.tracing.add_driver_spans``) ride ``stats["trace"]`` and
EXPLAIN ANALYZE's Trace line; a query slower than
``slow_query_log_threshold`` gets ``stats["slow_query"]`` with its
critical path. The host's reads of device tensors
(``telemetry.device_reads``) are charged to the operator that made
them, else to the task, else to the statement, and ride the operator,
task and root spans.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .. import session_properties as SP
from .. import types as T
from ..block import Page
from ..connectors.spi import Connector
from ..exec.local_planner import (LocalExecutionPlanner,
                                  PhysicalPipeline, grouping_options)
from ..ops.output import OutputBuffer, PartitionedOutputOperator
from ..planner.exchanges import add_exchanges
from ..planner.fragmenter import PlanFragment, fragment_plan, fragments_str
from ..planner.logical_planner import LogicalPlanner, Metadata
from ..planner.optimizer import optimize
from ..planner.plan import OutputNode
from ..runner import QueryResult
from ..sql import ast
from ..sql.analyzer import Session
from ..sql.parser import parse_statement
from ..telemetry import device_reads
from ..telemetry.tracing import (NULL_SPAN, NULL_TRACER, Tracer,
                                 span_counters)


class _Statement:
    """What one statement's execution owns: its tracer and root span,
    its device-read counters, its plan and fragments, its memory pool,
    history binding and per-stage stats."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.root_span = NULL_SPAN
        #: reads made outside any operator's or task's quantum
        self.reads = device_reads.Reads()
        self.root: Optional[OutputNode] = None
        self.fragments: Optional[List[PlanFragment]] = None
        self.plan_shape = None
        self.hbo = None
        self.hbo_estimates = None
        self.memory_pool = None
        self.collect_stats = False
        self.stage_stats: list = []

    def span(self, name: str, **attrs):
        """A statement span under the root (a no-op when tracing is
        off)."""
        return self.tracer.span(name, parent=self.root_span,
                                span_kind="statement", **attrs)


class DistributedQueryRunner:
    """Executes SQL over a simulated multi-worker cluster in one
    process, on ``device`` (``"cuda"`` by default; a runner asked for
    CUDA on a machine without a GPU raises; tests pass ``"cpu"``), or
    over ``devices``, the device slabs of the exchange's mesh (default
    ``[device]``)."""

    def __init__(self, connectors: Dict[str, Connector],
                 session: Optional[Session] = None,
                 n_workers: Optional[int] = None,
                 desired_splits: int = 8,
                 broadcast_threshold: Optional[float] = None,
                 device="cuda", devices=None):
        self.devices = [torch.device(x) for x in
                        (devices if devices is not None else [device])]
        assert self.devices, "DistributedQueryRunner: no devices"
        self.device = self.devices[0]
        if any(x.type == "cuda" for x in self.devices) \
                and not torch.cuda.is_available():
            raise T.DeviceUnavailableError(
                "DistributedQueryRunner: device 'cuda' requested but no "
                "CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        connectors = dict(connectors)
        if "system" not in connectors:
            # in-process workers share this runner's memory, so system
            # tables work here; the multi-process runner
            # (parallel/process_runner.py) routes statements that read
            # them to its coordinator instead
            from ..connectors.system import SystemConnector

            connectors["system"] = SystemConnector(source=self)
        self.metadata = Metadata(connectors)
        self.session = session or Session(
            catalog=next(iter(connectors), None))
        self.n_workers = n_workers if n_workers is not None \
            else SP.value(self.session, "task_concurrency")
        self.desired_splits = desired_splits
        self.broadcast_threshold = broadcast_threshold \
            if broadcast_threshold is not None \
            else SP.value(self.session, "broadcast_join_threshold")
        from ..cache import PlanCache

        #: fragment-plan cache (same PlanCache + key discipline as the
        #: local runner's): repeat statements skip plan/optimize/
        #: exchange planning, and a MATERIAL history misestimate on a
        #: decision node — join inputs, grouped aggs, and the
        #: DISTRIBUTION build sides — invalidates the shape so the
        #: next run re-plans from history
        self.plan_cache = PlanCache()

    # ------------------------------------------------------------------

    def metrics_families(self) -> list:
        """system.runtime.metrics source: the in-process runner exports
        the process-level families (program first calls, exchange and
        rebalance counters, profiler, history)."""
        from ..telemetry.metrics import process_families

        return process_families()

    def create_fragments(self, sql_or_stmt,
                         hbo=None) -> List[PlanFragment]:
        return self.plan_fragments(sql_or_stmt, hbo=hbo)[1]

    def plan_fragments(self, sql_or_stmt, hbo=None):
        """(plan root, fragments) of a statement."""
        stmt = sql_or_stmt if isinstance(sql_or_stmt, ast.Statement) \
            else parse_statement(sql_or_stmt)
        planner = LogicalPlanner(self.metadata, self.session)
        root = planner.plan(stmt)
        root = optimize(root, self.metadata, planner.allocator,
                        self.session, hbo=hbo)
        trace = getattr(root, "optimizer_trace", None)
        root = add_exchanges(
            root, self.metadata, planner.allocator,
            self.broadcast_threshold,
            SP.value(self.session, "join_distribution_type"),
            scale_writers=SP.value(self.session, "scale_writers_enabled"),
            hbo=hbo if SP.value(self.session,
                                "hbo_distribution_enabled") else None)
        if trace is not None:  # exchange planning rebuilt the root node
            root.optimizer_trace = trace
        return root, fragment_plan(root)

    def explain(self, sql: Optional[str], stmt=None) -> str:
        from ..planner.optimizer import provenance_lines

        if stmt is None:
            stmt = parse_statement(sql)
        # EXPLAIN plans through the statement's history view, so the
        # rendered join order / distribution / strategy choices are
        # exactly what the next execution would run
        root, fragments = self.plan_fragments(
            stmt, hbo=self._hbo_context(stmt))
        text = fragments_str(fragments)
        prov = provenance_lines(root)
        return text + ("\n" + "\n".join(prov) if prov else "")

    def execute(self, sql: str) -> QueryResult:
        return self._execute(sql)

    def _execute_query(self, stmt: ast.Statement,
                       collect_stats: bool = False) -> QueryResult:
        """A parsed query, INSERT or CTAS, run as ``execute`` runs it
        (without a parse span); ``collect_stats`` keeps the stats tree
        (``stats["query_stats"]``)."""
        return self._execute(stmt, collect_stats)

    def _execute(self, sql, collect_stats: bool = False) -> QueryResult:
        """One statement (SQL text, or a parsed statement) in a context
        of its own."""
        from ..telemetry import profiler

        st = _Statement(Tracer(process="coordinator")
                        if SP.value(self.session, "query_tracing_enabled")
                        else NULL_TRACER)
        t0 = time.perf_counter()
        verbose = before = None
        with device_reads.charging(st.reads), \
                st.tracer.span("query") as root:
            st.root_span = root
            if isinstance(sql, ast.Statement):
                stmt = sql
            else:
                with st.span("parse"):
                    stmt = parse_statement(sql)
            if isinstance(stmt, ast.Explain) and stmt.analyze and \
                    isinstance(stmt.statement, (ast.QueryStatement,
                                                ast.Insert,
                                                ast.CreateTableAsSelect)):
                # DML included: the writer path's exchange surface (scaled
                # writers' rebalance counters) is only observable here.
                # VERBOSE enables the compiled-program profiler so
                # per-operator rows carry flops / bytes / compile-ms
                verbose, stmt = stmt.verbose, stmt.statement
                before = profiler.totals() if verbose else None
                with profiler.profiling(verbose):
                    res = self._run_query(st, stmt, collect_stats=True)
            elif isinstance(stmt, (ast.QueryStatement, ast.Insert,
                                   ast.CreateTableAsSelect)):
                # writes distribute: scaled writer tasks in the source
                # stage, rowcounts summed (exchanges._v_TableWriterNode)
                res = self._run_query(st, stmt, collect_stats)
            else:
                # remaining DDL doesn't distribute; delegate
                from ..runner import LocalQueryRunner

                return LocalQueryRunner(self.metadata.connectors,
                                        self.session,
                                        device=self.device).execute(sql)
            root.set("statement", type(stmt).__name__)
            for key, value in span_counters(st.reads).items():
                root.set(key, value)
        self._finish(st, res, time.perf_counter() - t0)
        if verbose is not None:
            return self._explain_analyze(st, res, verbose, before)
        return res

    def _explain_analyze(self, st: _Statement, res: QueryResult,
                         verbose: bool, before) -> QueryResult:
        """Distributed EXPLAIN ANALYZE: render the query/stage/task
        stats tree the run collected (reference: the QueryStats
        hierarchy + planprinter), under the fragments it ran; VERBOSE
        adds a Kernels line of what this run compiled vs reused."""
        from ..telemetry import profiler

        tree = res.stats["query_stats"]
        lines = fragments_str(st.fragments).splitlines()
        lines.append("")
        lines.extend(tree.render())
        if verbose:
            from ..runner import _kernels_line

            lines.append(_kernels_line(before, profiler.totals()))
        return QueryResult(["Query Plan"], [T.VARCHAR],
                           [(line,) for line in lines],
                           stats={"query_stats": tree.to_dict()})

    def _finish(self, st: _Statement, res: QueryResult,
                wall_s: float) -> None:
        """The finished trace onto the result (and its stats tree), and
        the slow-query record of a statement slower than
        ``slow_query_log_threshold``."""
        if st.tracer.enabled:
            spans = st.tracer.finished()
            res.stats["trace"] = spans
            tree = res.stats.get("query_stats")
            if tree is not None:
                tree.trace = spans
        threshold = SP.value(self.session, "slow_query_log_threshold")
        if threshold and wall_s > threshold:
            from ..telemetry.tracing import slow_query_record

            res.stats["slow_query"] = slow_query_record(
                res.stats.get("trace"), wall_s * 1e3, threshold,
                worst_misestimate=(res.stats.get("hbo") or {}).get("worst"))

    def _run_query(self, st: _Statement, stmt: ast.QueryStatement,
                   collect_stats: bool = False) -> QueryResult:
        """Profiling envelope around the execution body: the
        ``query_profiling_enabled`` session knob turns the compiled-
        program registry on for this query (EXPLAIN ANALYZE VERBOSE
        layers its own ``profiling(True)`` on top)."""
        from ..telemetry.profiler import profiling

        with profiling(SP.value(self.session, "query_profiling_enabled")):
            return self._execute_query_body(st, stmt, collect_stats)

    def _hbo_context(self, stmt):
        """History-based-statistics binding (same exclusions as the
        local runner: hbo_enabled off, non-queries, unversioned
        catalogs -> None)."""
        if not SP.value(self.session, "hbo_enabled"):
            return None
        from ..telemetry.stats_store import HboContext

        return HboContext.for_statement(
            stmt, self.session, self.metadata,
            alpha=SP.value(self.session, "hbo_ewma_alpha"))

    def _execute_query_body(self, st: _Statement,
                            stmt: ast.QueryStatement,
                            collect_stats: bool = False) -> QueryResult:
        from ..exec.stats import QueryStatsTree

        with st.span("plan") as plan_span:
            st.hbo = hbo_ctx = self._hbo_context(stmt)
            key = self._plan_cache_key(stmt)
            cached = self.plan_cache.lookup(key) if key is not None \
                else None
            plan_hit = cached is not None
            if cached is None:
                cached = self.plan_fragments(stmt, hbo=hbo_ctx)
                if key is not None:
                    self.plan_cache.store(key, cached, 128)
            st.root, st.fragments = cached
            plan_span.set("plan_cache_hit", plan_hit)
        st.plan_shape = key[0] if key is not None else None
        root: OutputNode = st.root
        fragments = st.fragments
        buffers: Dict[int, OutputBuffer] = {}
        result_pages: List[Page] = []
        from ..exec.memory import pool_from_session

        # one pool per query across all tasks: device HBM is a
        # per-process resource (reference: ClusterMemoryManager enforcing
        # a query's global limit over per-node reservations)
        st.memory_pool = pool_from_session(self.session)
        # history recording needs per-operator row counts, so HBO turns
        # the stats-collecting driver path on even for plain execute();
        # so do the operator spans of a traced query
        st.collect_stats = collect_stats or hbo_ctx is not None \
            or st.tracer.enabled
        t0 = time.perf_counter()

        # tasks run as cooperative generators on the process-wide
        # TaskExecutor: concurrent queries time-share the pool through
        # the multilevel feedback queue instead of each query pinning
        # its own threads (reference: TaskExecutor.java per worker JVM)
        from ..exec.task_executor import shared_executor

        executor = shared_executor()
        streaming = SP.value(self.session, "streaming_execution")
        try:
            if streaming:
                result_pages = self._execute_streaming(
                    st, executor, fragments, root, buffers)
            else:
                for frag in fragments:
                    ntasks = 1 if frag.partitioning == "single" \
                        else self.n_workers
                    if frag.output_kind == "output":
                        collected = self._run_output_fragment(
                            st, executor, frag, root, ntasks, buffers)
                        result_pages = collected
                    else:
                        buffers[frag.fragment_id] = self._run_fragment(
                            st, executor, frag, ntasks, buffers)

            rows: List[tuple] = []
            with st.span("results"):
                for p in result_pages:
                    rows.extend(p.to_rows())
            stats = {"memory": st.memory_pool.stats()}
        except BaseException:
            # reap spill files + free residue even when the query dies
            st.memory_pool.close()
            raise
        names = root.column_names
        types_ = [s.type for s in root.outputs]
        if streaming:
            stats["streaming_overlap"] = {
                fid: buf.overlapped for fid, buf in buffers.items()
                if isinstance(buf, OutputBuffer)}
        # every stage boundary's exchange stats by producing fragment,
        # and (when the drivers collected stats) each operator's name and
        # metrics, task by task — the local runner's ``operators``
        stats["exchanges"] = {fid: getattr(buf, "stats", None)
                              for fid, buf in buffers.items()}
        stats["operators"] = [
            dict(o.metrics or {}, name=o.name, stage=s.stage_id,
                 task=t.task_id)
            for s in st.stage_stats for t in s.tasks
            for o in t.operators]
        if plan_hit:
            stats["plan_cache"] = "hit"
        if hbo_ctx is not None:
            with st.span("history"):
                summary = self._hbo_record(st, hbo_ctx, root, stats)
            if summary:
                stats["hbo"] = summary
        if collect_stats:
            # attach each stage's output-boundary exchange skew stats —
            # only now, after every consumer ran: the device collective
            # is consumer-triggered, so producer-stage completion would
            # be too early to read it
            by_stage = {s.stage_id: s for s in st.stage_stats}
            for fid, buf in buffers.items():
                stage = by_stage.get(fid)
                if stage is not None:
                    stage.exchange = getattr(buf, "stats", None)
            tree = QueryStatsTree(
                stages=st.stage_stats,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                memory=st.memory_pool.stats())
            if hbo_ctx is not None:
                tree.estimates = st.hbo_estimates
                tree.worst_misestimate = (stats.get("hbo") or
                                          {}).get("worst")
            stats["query_stats"] = tree
        st.memory_pool.close()  # reap spill files, free residue
        return QueryResult(names, types_, rows, stats=stats)

    def _plan_cache_key(self, stmt) -> Optional[tuple]:
        """Fragment-plan cache key, or None when uncacheable: mirrors
        the local runner's discipline (shape + literals + session and
        snapshot fingerprints — SET SESSION and DDL/writes move the
        key), plus the planning inputs owned by this runner."""
        if not SP.value(self.session, "plan_cache_enabled"):
            return None
        if not isinstance(stmt, ast.QueryStatement):
            return None
        from ..cache import (normalize_statement, session_fingerprint,
                             snapshot_fingerprint, statement_catalogs)

        shape, literals = normalize_statement(stmt)
        snap = snapshot_fingerprint(
            statement_catalogs(stmt, self.session), self.metadata)
        if snap is None:
            return None
        return (shape, literals, session_fingerprint(self.session),
                snap, self.n_workers, self.desired_splits,
                self.broadcast_threshold)

    def _hbo_record(self, st: _Statement, hbo_ctx, root,
                    stats) -> Optional[dict]:
        """Fold this query's per-node actuals (summed across every
        stage's tasks) into the history store; stashes the estimate
        map for EXPLAIN ANALYZE's per-node Q-error rendering.  A
        material misestimate on a decision node (join input, grouped
        agg, or a DISTRIBUTION build side) drops cached fragment plans
        of the shape — the next run re-plans against history."""
        op_stats = [o for s in st.stage_stats
                    for t in s.tasks for o in t.operators]
        est = hbo_ctx.estimates(root, self.metadata)
        st.hbo_estimates = est[0]
        scan_rows = sum(o.output_rows for o in op_stats
                        if o.name == "TableScanOperator")
        mem = stats.get("memory") or {}
        summary = hbo_ctx.record(root, self.metadata, op_stats,
                                 peak_bytes=mem.get("peak_bytes", 0),
                                 scan_rows=scan_rows, estimates=est)
        shape = st.plan_shape
        if summary and summary["material"] and shape is not None:
            self.plan_cache.invalidate_shape(shape)
        return summary

    # ----------------------------------------------- streaming mode ----

    def _execute_streaming(self, st: _Statement, executor, fragments,
                           root: OutputNode,
                           buffers: Dict[int, "OutputBuffer"]):
        """All stages run CONCURRENTLY: every fragment's tasks are
        submitted at once, exchange sources consume pages as producers
        enqueue them (parking on listen tokens while empty), and
        bounded buffers push backpressure upstream (reference:
        execution/scheduler/PipelinedQueryScheduler.java:155)."""
        import threading

        from ..exec.stats import StageStatsTree

        max_pending = SP.value(self.session, "exchange_max_pending_pages")
        plans = []
        for frag in fragments:
            ntasks = 1 if frag.partitioning == "single" \
                else self.n_workers
            out = None
            if frag.output_kind != "output":
                device_ex = self._device_exchange_for(frag, ntasks)
                if device_ex is not None:
                    out = device_ex
                elif frag.output_kind == "single":
                    out = OutputBuffer(1, max_pending_pages=max_pending)
                elif frag.output_kind == "merge":
                    # one partition PER PRODUCER: each task's sorted run
                    # stays separate for the consumer's k-way merge
                    out = OutputBuffer(ntasks,
                                       max_pending_pages=max_pending)
                elif frag.output_kind == "broadcast":
                    out = OutputBuffer(self.n_workers, broadcast=True)
                else:
                    out = OutputBuffer(self.n_workers,
                                       max_pending_pages=max_pending)
                    out.rebalancer = self._rebalancer_for(frag)
                buffers[frag.fragment_id] = out
            plans.append((frag, ntasks, out))

        futures = []
        stages = []
        results: List[List[Page]] = []
        for frag, ntasks, out in plans:
            stage = StageStatsTree(frag.fragment_id, frag.partitioning,
                                   frag.output_kind)
            stages.append(stage)
            stage_span = self._stage_span(st, frag)
            is_output = frag.output_kind == "output"
            if is_output:
                results = [[] for _ in range(ntasks)]
            # producers-done wiring: the LAST task of the fragment to
            # exit (normally or not) marks the stream ended, so
            # consumers always unblock
            remaining = [ntasks]
            rlock = threading.Lock()

            def wrapped(gen, out=out, remaining=remaining, rlock=rlock,
                        stage_span=stage_span):
                try:
                    yield from gen
                finally:
                    with rlock:
                        remaining[0] -= 1
                        last = remaining[0] == 0
                    if last:
                        stage_span.finish()
                        if out is not None:
                            out.set_no_more_pages()

            for t in range(ntasks):
                gen = self._task_gen(st, frag, ntasks, t, out, buffers,
                                     stage, root if is_output else None,
                                     results if is_output else None,
                                     streaming=True, stage_span=stage_span)
                futures.append(executor.submit(wrapped(gen)))

        self._wait_all(futures,
                       [b for b in buffers.values()])
        if st.collect_stats:
            for stage in stages:
                stage.tasks.sort(key=lambda t: t.task_id)
                st.stage_stats.append(stage)
        return [p for r in results for p in r]

    def _wait_all(self, futures, bufs):
        """Wait for every task; on the first error, abort all buffers so
        parked producers/consumers unwind instead of deadlocking, then
        keep waiting so no generator outlives the query."""
        errors: List[BaseException] = []
        aborted = False
        pending = list(futures)
        while pending:
            still = []
            for f in pending:
                if f._event.wait(0.02):
                    if f._error is not None:
                        errors.append(f._error)
                else:
                    still.append(f)
            if errors and not aborted:
                aborted = True
                for b in bufs:
                    b.abort()
            pending = still
        if errors:
            raise errors[0]

    # ------------------------------------------------------------------

    def _make_reader(self, buffers: Dict[int, OutputBuffer], task_id: int,
                     streaming: bool = False):
        def reader(fragment_id: int, kind: str):
            buf = buffers[fragment_id]
            if kind == "merge":
                # per-producer sorted streams for the k-way merge
                if streaming:
                    return [buf.channel(p)
                            for p in range(buf.num_partitions)]
                return [(lambda p=p: buf.pages(p))
                        for p in range(buf.num_partitions)]
            part = 0 if kind == "single" else task_id
            if streaming:
                from .device_exchange import DeviceExchange

                if isinstance(buf, DeviceExchange):
                    return buf.channel(part)
                return buf.channel(part, consumer_id=task_id)

            def thunk():
                return buf.pages(part)

            return thunk

        return reader

    def _stage_span(self, st: _Statement, frag: PlanFragment):
        """The trace span of one fragment's stage (a no-op span when
        tracing is off)."""
        return st.tracer.span(
            f"stage f{frag.fragment_id}", parent=st.root_span,
            span_kind="stage", fragment=frag.fragment_id,
            partitioning=frag.partitioning, output=frag.output_kind)

    def _task_gen(self, st: _Statement, frag: PlanFragment, ntasks: int,
                  t: int, out, buffers, stage, root: Optional[OutputNode],
                  results: Optional[List[List[Page]]],
                  streaming: bool = False, stage_span=None):
        """One task of one fragment as a cooperative generator. ``out``
        is the fragment's output (OutputBuffer | DeviceExchange | None
        for the output fragment, which collects into ``results[t]``).
        In streaming mode a no-progress quantum yields Blocked(tokens)
        so the executor parks the task. Its trace span (child of
        ``stage_span``) covers the task from its first quantum to its
        end, its drivers' operator spans beneath it; the reads its
        quanta make outside an operator's call are charged to it."""
        reads = device_reads.Reads()
        with st.tracer.span(
                f"task f{frag.fragment_id}.{t}", parent=stage_span,
                span_kind="task", fragment=frag.fragment_id,
                task_id=t) as task_span:
            yield from device_reads.charged(
                self._task_body(st, frag, ntasks, t, out, buffers, stage,
                                root, results, streaming, task_span),
                reads)
            for key, value in span_counters(reads).items():
                task_span.set(key, value)

    def _task_body(self, st: _Statement, frag: PlanFragment, ntasks: int,
                   t: int, out, buffers, stage, root: Optional[OutputNode],
                   results: Optional[List[List[Page]]], streaming: bool,
                   task_span):
        from ..exec.driver import Driver
        from ..exec.local_planner import project_to_wire_layout
        from ..exec.stats import TaskStatsTree
        from ..exec.task_executor import Blocked
        from ..telemetry.tracing import add_driver_spans

        planner = LocalExecutionPlanner(
            self.metadata, self.devices[t % len(self.devices)],
            self.desired_splits, task_id=t,
            task_count=ntasks,
            exchange_reader=self._make_reader(buffers, t, streaming),
            memory_pool=st.memory_pool,
            join_max_lanes=SP.value(self.session,
                                    "join_max_expand_lanes"),
            dynamic_filtering=SP.value(
                self.session, "enable_dynamic_filtering"),
            scan_coalesce=SP.value(self.session, "scan_coalesce_enabled"),
            hbo=st.hbo,
            **grouping_options(self.session.properties))
        collect = st.collect_stats
        task = TaskStatsTree(t)
        if root is not None:
            plan = planner.plan(OutputNode(frag.root, root.column_names,
                                           root.outputs))
            pipelines = plan.pipelines
        else:
            ops, layout, types_ = planner.visit(frag.root)
            ops, layout, types_, key_channels = project_to_wire_layout(
                frag, ops, layout, types_)
            from .device_exchange import DeviceExchange

            if isinstance(out, DeviceExchange):
                from .device_exchange import DeviceExchangeSinkOperator

                ops.append(DeviceExchangeSinkOperator(
                    types_, key_channels, out, t))
            else:
                ops.append(PartitionedOutputOperator(
                    types_, key_channels, out, frag.output_kind,
                    task_partition=t,
                    rebalancer=getattr(out, "rebalancer", None),
                    hot_split_threshold=SP.value(
                        self.session, "hot_partition_split_threshold")))
            planner.pipelines.append(PhysicalPipeline(ops))
            pipelines = planner.pipelines
        for p in pipelines:
            d = Driver(p.operators, collect_stats=collect)
            for _ in range(10_000_000):
                if d.process():
                    break
                if streaming:
                    # park only after a NO-PROGRESS quantum: a blocked
                    # source with runnable downstream work must keep
                    # running
                    toks = [] if d.last_moved else d.blocked_tokens()
                    yield Blocked(toks) if toks else None
                else:
                    yield  # quantum boundary: hand the thread back
            else:
                raise T.TrinoError("driver did not finish",
                                   "GENERIC_INTERNAL_ERROR")
            if collect:
                d.collect_operator_metrics()
                task.operators.extend(d.stats)
                add_driver_spans(st.tracer, d, task_span)
        if root is not None and results is not None:
            results[t] = plan.sink.pages
        if collect:
            stage.tasks.append(task)

    def _rebalancer_for(self, frag: PlanFragment):
        """The scaled-writer rebalancer for a scale_writers hash
        boundary (see rebalancer.writer_rebalancer for the sharing
        contract)."""
        if frag.output_kind != "hash" or not frag.scale_writers:
            return None
        from .rebalancer import writer_rebalancer

        return writer_rebalancer(
            (str(s.type) for s in frag.output_symbols), self.n_workers,
            SP.value(self.session, "rebalance_min_collectives"))

    def _device_exchange_for(self, frag: PlanFragment, ntasks: int):
        """The flagship TPU-native path: a hash stage boundary between
        co-resident stages runs as one all_to_all collective over the
        mesh instead of host-side partitioning (SURVEY.md §2.8). Returns
        None when the fragment must take the host path."""
        if frag.output_kind != "hash" or ntasks != self.n_workers:
            return None
        if frag.scale_writers:
            # scaled-writer boundaries rebalance on the HOST: the
            # partition->lane map mutates across pages, which a compiled
            # collective cannot follow (and writers consume host pages)
            return None
        if not SP.value(self.session, "device_exchange"):
            return None
        from .device_exchange import (DeviceExchange,
                                      device_exchange_supported)

        if not device_exchange_supported(
                [s.type for s in frag.output_symbols]):
            return None
        # fewer devices than workers is fine: DeviceExchange lays p
        # partitions over d devices (p % d) and carries partition ids
        # through the exchange, so a single device still executes the
        # flagship path (the JAX runner hands it ``jax.devices()``)
        return DeviceExchange(
            self.n_workers, self.devices,
            sizing=SP.value(self.session, "device_exchange_sizing"),
            hot_split_threshold=SP.value(
                self.session, "hot_partition_split_threshold"))

    def _run_fragment(self, st: _Statement, executor, frag: PlanFragment,
                      ntasks: int, buffers: Dict[int, OutputBuffer]):
        # consumer partition count: single -> 1, hash -> n_workers,
        # broadcast -> replicated
        device_ex = self._device_exchange_for(frag, ntasks)
        if device_ex is not None:
            out = device_ex
        elif frag.output_kind == "single":
            out = OutputBuffer(1)
        elif frag.output_kind == "merge":
            out = OutputBuffer(ntasks)  # one partition per producer
        elif frag.output_kind == "broadcast":
            out = OutputBuffer(self.n_workers, broadcast=True)
        else:
            out = OutputBuffer(self.n_workers)
            out.rebalancer = self._rebalancer_for(frag)

        from ..exec.stats import StageStatsTree

        stage = StageStatsTree(frag.fragment_id, frag.partitioning,
                               frag.output_kind)
        with self._stage_span(st, frag) as stage_span:
            executor.run_all([
                self._task_gen(st, frag, ntasks, t, out, buffers, stage,
                               None, None, stage_span=stage_span)
                for t in range(ntasks)])
        if st.collect_stats:
            stage.tasks.sort(key=lambda t: t.task_id)
            st.stage_stats.append(stage)
        return out

    def _run_output_fragment(self, st: _Statement, executor,
                             frag: PlanFragment, root: OutputNode,
                             ntasks: int, buffers) -> List[Page]:
        from ..exec.stats import StageStatsTree

        results: List[List[Page]] = [[] for _ in range(ntasks)]
        stage = StageStatsTree(frag.fragment_id, frag.partitioning,
                               frag.output_kind)
        with self._stage_span(st, frag) as stage_span:
            executor.run_all([
                self._task_gen(st, frag, ntasks, t, None, buffers, stage,
                               root, results, stage_span=stage_span)
                for t in range(ntasks)])
        if st.collect_stats:
            stage.tasks.sort(key=lambda t: t.task_id)
            st.stage_stats.append(stage)
        return [p for r in results for p in r]
