"""Worker process: runs fragment tasks, buffers output, serves pulls.

Reference analog: the worker half of the engine — ``SqlTaskManager``
(``execution/SqlTaskManager.java:446`` applying TaskUpdateRequests),
task execution (``SqlTaskExecution.java``), and the result endpoint
(``server/TaskResource.java:308`` ``GET .../results/{bufferId}``).
One process per worker.

The JAX engine's ``trino_tpu/parallel/worker.py`` on torch. That engine
pins its workers to the CPU (its TPU belongs to the in-process mesh
path); here every worker runs on the device the coordinator names,
``cuda`` unless the runner was asked for the CPU, because several
processes can share one CUDA card, each with its own context and
caching allocator. Each worker's operators run on that device: the
partial aggregations and final merges reduce through the segment-reduce
kernel (``ops/kernels.py``), whose library each process loads itself.
Pages cross the wire only as serde frames (``exec/serde.py``), compacted
on the device before their one copy to the host; every number a
response carries is a Python int or float.

Two execution modes, selected per task by the coordinator:
- streaming (default): ``run_task`` returns immediately, the task runs
  in a background thread against a BOUNDED output buffer, consumers
  long-poll ``get_page_stream`` incrementally, and upstream reads go
  through RemoteExchangeChannels — all stages of a query run
  concurrently across processes (reference:
  execution/scheduler/PipelinedQueryScheduler.java:155);
- barrier: ``run_task`` blocks until the task finished and buffered its
  whole output; consumers pull the snapshot with ``get_results`` (the
  fault-tolerant shape: outputs survive for task retry).

Protocol (rpc.py framing; one request per connection):
  configure       {catalogs, properties}            -> {ok}
  run_task        {task_id, fragment, task_index, task_count,
                   output_kind, n_partitions, upstream, session,
                   streaming?, buffer_bound?, coordinator?,
                   remote_write_catalogs?, fault? (FaultSchedule
                   directive; legacy inject_failure => kind=error)}
                          -> {ok, rows?, memory_peak?} | {error,
                              error_type, error_code, remote_traceback,
                              memory_peak?}
  get_results     {task_id, partition}              -> header + frames
  get_page_stream {task_id, partition, consumer_id, wait, cursor, ack}
                     -> {n_pages, start, done} + frames. Ack-based
                     cursor protocol: frames index from 0 per stream,
                     ``cursor`` asks for frames from that index,
                     ``ack`` releases retained frames below it — a
                     consumer reconnecting after a torn connection
                     replays the unacked range byte-identically
  task_status     {task_ids}                        -> {statuses}
  abort_task      {task_id}                         -> {ok}
  sync_table      {catalog, schema, table, columns, frames} -> {ok}
  drop_table      {catalog, schema, table}          -> {ok}
  release_task    {task_id}                         -> {ok}
  ping            {}                 -> {ok, tasks, memory} (the node
                   memory-pool snapshot piggybacks on the heartbeat)
  profile         {}                 -> {kernels, totals, device_memory}
  kernel_launches {reset?}           -> {ok, launches} (this process's
                   kernel launch counters, zeroed after the read with
                   reset: a run's launches on the card are summed over
                   the processes)
  kernel_calls    {record, path?, kernel?}
                                     -> {ok, calls} (with record, keep a
                   copy of the inputs of every launch of ``kernel``
                   (default segment_reduce, or hash_insert) from now on;
                   without, stop and write the calls kept to ``path``
                   with torch.save, so another process replays them
                   against the plain version)
  shutdown        {}                                -> {ok} (then exits)

Memory governance: ``configure`` builds the worker-wide NodeMemoryPool
(``node_max_memory_bytes``; 0 = the device's whole memory, so on a card
shared by several workers set it to each process's share); each query's
tasks share a refcounted per-query child pool charged by the operators'
memory contexts, with host-RAM and disk spill tiers below it.

Start: ``python -m trino_tpu_torch.parallel.worker [PORT] [--device DEV]``
prints ``WORKER_READY <port>`` once the device is open, or
``WORKER_FAILED <cause>`` and exits 1.
"""

from __future__ import annotations

import os
import socketserver
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from .rpc import recv_msg, send_frame, send_msg


class _RetainedStream:
    """Per-(partition, consumer) streaming output cursor: serialized
    frames are RETAINED until the consumer acks that range, so a
    reconnecting consumer replays from its last acked frame instead of
    losing the pages the buffer's drain cursor already freed (the
    "streaming pulls do not reconnect" limitation this removes).
    Retention is bounded: the consumer acks everything it received on
    its next poll, so at most one response batch stays parked."""

    __slots__ = ("ser", "frames", "base", "sent", "lock")

    def __init__(self):
        from ..exec.serde import PageSerializer

        self.ser = PageSerializer()
        self.frames: List[bytes] = []
        self.base = 0           # stream index of frames[0]
        self.sent = 0           # high-water frame index ever sent
        self.lock = threading.Lock()

    def discard_acked(self, ack: int):
        with self.lock:
            drop = min(max(ack - self.base, 0), len(self.frames))
            if drop:
                del self.frames[:drop]
                self.base += drop


class _TaskState:
    def __init__(self):
        self.status = "running"
        self.error = None
        self.failure = None         # fault.serialize_failure dict
        self.buffer = None          # ops.output.OutputBuffer
        self.rows = 0
        self.abort = threading.Event()
        #: set once the run_task response is on the wire (or failed to
        #: get there): a streaming task's injected kill waits for it
        self.acked = threading.Event()
        #: per-(partition, consumer) retained-frame cursors for the
        #: ack-based streaming pull protocol
        self.streams: Dict[tuple, _RetainedStream] = {}
        self.channels: List = []    # RemoteExchangeChannels to close
        self.thread = None
        #: finished trace spans of this task (streaming tasks outlive
        #: the run_task RPC, so spans are collected via task_status)
        self.spans: List[dict] = []
        #: per-plan-node actuals of this task (fingerprint-keyed dicts;
        #: telemetry.stats_store shape) — piggybacked on the run_task
        #: response (barrier) / task_status poll (streaming), so the
        #: coordinator's history store learns worker actuals with no
        #: extra RPC
        self.hbo_actuals: List[dict] = []
        #: armed drop-connection occurrences: result pulls for this task
        #: close mid-frame this many times (FaultSchedule directive)
        self.drop_results = 0
        #: durable streams (partial-stage retry): retain ALL serialized
        #: frames instead of discarding acked ones, so a RESTARTED
        #: consumer (fresh cursor 0) replays the full byte-identical
        #: stream; memory stays bounded by the consumer-relative flow
        #: control window
        self.retain = False
        #: spool tee for streaming output (partial-stage retry): the
        #: task's pages also publish to the external spool backend, so
        #: its output outlives this process
        self.spool_writer = None


class WorkerServer:
    def __init__(self, port: int = 0, device="cuda"):
        import torch

        #: the device every task of this worker runs on
        self.device = torch.device(device)
        self.tasks: Dict[str, _TaskState] = {}
        self.connectors = {}
        self.properties: dict = {}
        self._lock = threading.Lock()
        #: worker-wide pool all queries charge (built at configure);
        #: per-query children are refcounted by their running tasks
        self.node_pool = None
        self._pool_refs: Dict[str, int] = {}
        #: lifetime task counters for the metrics surface (heartbeat-
        #: piggybacked; reference: SqlTaskManager's task stats).
        #: Updated via _count_task under the lock: concurrent streaming
        #: task threads would lose unsynchronized increments
        self.tasks_finished = 0
        self.tasks_failed = 0
        self.task_rows = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = recv_msg(self.request)
                except ConnectionError:
                    return
                try:
                    outer.dispatch(self.request, req)
                except Exception as e:  # report, never kill the server
                    from .fault import serialize_failure

                    traceback.print_exc()
                    try:
                        # full taxonomy payload, not a bare repr: the
                        # coordinator's retry dispatch keys off the type
                        send_msg(self.request, serialize_failure(e))
                    except OSError:
                        pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]

    # ------------------------------------------------------------------

    def dispatch(self, sock, req: dict):
        op = req.get("op")
        if op == "configure":
            from .. import session_properties as SP
            from ..connectors.catalog import create_catalogs
            from ..exec.memory import (NodeMemoryPool,
                                       default_node_memory_bytes)

            self.connectors = create_catalogs(req["catalogs"])
            self.properties = dict(req.get("properties", {}))
            # 0 = auto: size the node pool from what the device
            # actually has instead of a hardwired constant
            self.node_pool = NodeMemoryPool(
                SP.prop_value(self.properties, "node_max_memory_bytes")
                or default_node_memory_bytes(self.device),
                host_spill_limit=SP.prop_value(
                    self.properties, "spill_host_memory_bytes"))
            seeded = 0
            if req.get("hbo_seed"):
                # coordinator history piggybacks on configure: worker-
                # local planning (adaptive partial-agg seeding) then
                # sees the same cardinalities the coordinator planned
                # from, instead of starting blind every process life
                from ..telemetry import stats_store

                seeded = stats_store.store().import_seed(
                    req["hbo_seed"])
            template_seeded = 0
            if req.get("template_seed"):
                # template-earn state rides the same transport (round
                # 17): a replacement worker rides already-earned plan
                # templates on its FIRST statement instead of
                # re-earning min_shape_uses locally
                from ..cache import template_seeds

                template_seeded = template_seeds().import_seed(
                    req["template_seed"])
            sizing_seeded = 0
            if req.get("sizing_seed"):
                # exchange-sizing knowledge rides the same transport: a
                # joiner presizes device exchanges from cluster history
                # instead of re-learning shape by shape
                from .device_exchange import SIZING_HISTORY

                sizing_seeded = SIZING_HISTORY.import_seed(
                    req["sizing_seed"])
            send_msg(sock, {"ok": True, "hbo_seeded": seeded,
                            "template_seeded": template_seeded,
                            "sizing_seeded": sizing_seeded})
        elif op == "run_task":
            try:
                send_msg(sock, self.run_task(req))
            finally:
                with self._lock:
                    state = self.tasks.get(req["task_id"])
                if state is not None:
                    state.acked.set()
        elif op == "get_results":
            self.send_results(sock, req["task_id"], req["partition"])
        elif op == "get_page_stream":
            self.stream_results(sock, req)
        elif op == "task_status":
            send_msg(sock, {"statuses": self.task_statuses(
                req.get("task_ids"),
                include_spans=bool(req.get("include_spans")))})
        elif op == "abort_task":
            self._abort_task(req["task_id"])
            send_msg(sock, {"ok": True})
        elif op == "sync_table":
            send_msg(sock, self.sync_table(req))
        elif op == "drop_table":
            conn = self.connectors.get(req["catalog"])
            if conn is not None:
                h = conn.metadata().get_table_handle(req["schema"],
                                                     req["table"])
                if h is not None:
                    conn.metadata().drop_table(h)
            send_msg(sock, {"ok": True})
        elif op == "release_task":
            self._abort_task(req["task_id"])
            with self._lock:
                self.tasks.pop(req["task_id"], None)
            send_msg(sock, {"ok": True})
        elif op == "profile":
            from ..telemetry import profiler

            send_msg(sock, {
                "kernels": profiler.snapshot(),
                "totals": profiler.totals(),
                "device_memory": profiler.device_memory_stats()})
        elif op == "kernel_launches":
            from ..ops import kernels

            send_msg(sock, {"ok": True, "launches": kernels.launch_counts(
                reset=bool(req.get("reset")))})
        elif op == "kernel_calls":
            from ..ops import kernels

            kept = kernels.record_calls(
                bool(req.get("record")),
                req.get("kernel", "segment_reduce"))
            if req.get("path"):
                import torch

                torch.save(kept, req["path"])
            send_msg(sock, {"ok": True, "calls": len(kept)})
        elif op == "ping":
            # the heartbeat PIGGYBACKS the node pool snapshot AND the
            # metrics-registry snapshot: the coordinator's
            # ClusterMemoryManager/ClusterMetrics see every worker's
            # state without an extra RPC (reference: MemoryInfo riding
            # the ServerInfo heartbeat).  ONE snapshot() call — its
            # blocked_events delta is consumed on read, so the metrics
            # families must reuse it, never re-sample
            memory = self.node_pool.snapshot() \
                if self.node_pool is not None else None
            template_seeded = 0
            if req.get("template_seed"):
                # coordinator template-earn deltas piggyback on the
                # heartbeat (round 17): steady-state workers converge
                # on earned templates without an extra RPC
                from ..cache import template_seeds

                template_seeded = template_seeds().import_seed(
                    req["template_seed"])
            # sizing observations travel the OTHER way on the same
            # ping: the coordinator merges them and seeds joiners
            from .device_exchange import SIZING_HISTORY

            send_msg(sock, {"ok": True, "pid": os.getpid(),
                            "tasks": len(self.tasks),
                            "memory": memory,
                            "template_seeded": template_seeded,
                            "sizing": SIZING_HISTORY.export_seed()
                            or None,
                            "metrics": self.metrics_families(memory)})
        elif op == "shutdown":
            send_msg(sock, {"ok": True})
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
        else:
            send_msg(sock, {"error": f"unknown op {op!r}"})

    def _abort_task(self, task_id: str):
        with self._lock:
            state = self.tasks.get(task_id)
        if state is not None:
            state.abort.set()
            if state.buffer is not None:
                state.buffer.abort()
            for ch in state.channels:
                ch.close()

    def task_statuses(self, task_ids, include_spans: bool = False
                      ) -> dict:
        out = {}
        with self._lock:
            items = [(tid, self.tasks.get(tid)) for tid in task_ids] \
                if task_ids is not None else list(self.tasks.items())
        for tid, state in items:
            if state is None:
                out[tid] = {"status": "missing"}
            else:
                out[tid] = {
                    "status": state.status, "error": state.error,
                    "error_type": (state.failure or {}).get("error_type"),
                    "rows": state.rows,
                    "overlapped": (state.buffer.overlapped
                                   if state.buffer is not None and
                                   hasattr(state.buffer, "overlapped")
                                   else False)}
                if include_spans:
                    # streaming tasks outlive their run_task ack: the
                    # coordinator collects their finished spans here
                    # (the heartbeat-piggyback pattern)
                    out[tid]["spans"] = list(state.spans)
                if state.hbo_actuals:
                    # same piggyback for history actuals: streaming
                    # tasks report them on the end-of-query poll
                    out[tid]["hbo"] = list(state.hbo_actuals)
        return out

    def metrics_families(self, memory: Optional[dict]) -> list:
        """This process's metric families for the heartbeat piggyback:
        the shared process-level sources (jit traces, exchange splits,
        node pool) plus worker task counters."""
        from ..telemetry.metrics import MetricsRegistry, process_families

        fams = process_families(tasks=len(self.tasks), memory=memory)
        reg = MetricsRegistry()
        with self._lock:
            finished, failed = self.tasks_finished, self.tasks_failed
            rows = self.task_rows
        c = reg.counter("trino_tasks_total",
                        "Tasks run by this worker, by terminal status")
        c.inc(finished, status="finished")
        c.inc(failed, status="failed")
        reg.counter("trino_task_rows_total",
                    "Rows produced by finished tasks on this worker"
                    ).inc(rows)
        return fams + reg.collect()

    def _count_task(self, ok: bool, rows: int = 0):
        with self._lock:
            if ok:
                self.tasks_finished += 1
                self.task_rows += rows
            else:
                self.tasks_failed += 1

    @staticmethod
    def _tracer_for(trace: Optional[dict]):
        """A per-task tracer continuing the coordinator's trace, or the
        shared no-op tracer when the request carries no context (tracing
        off => zero work, nothing shipped back)."""
        from ..telemetry.tracing import NULL_TRACER, Tracer

        if not trace:
            return NULL_TRACER
        return Tracer(process=f"worker-{os.getpid()}",
                      trace_id=trace.get("trace_id"))

    def sync_table(self, req: dict) -> dict:
        """Bring the local replica of a memory-catalog table up to the
        coordinator's committed state (replicated storage: every worker
        scans its own full copy). ``start`` is the coordinator's
        replication cursor: pages [start:] are appended when the local
        replica matches it, start=0 replaces wholesale; a mismatch asks
        the coordinator for a full resync."""
        from ..exec.serde import PageDeserializer

        conn = self.connectors.get(req["catalog"])
        if conn is None:
            return {"error": f"no catalog {req['catalog']!r}"}
        md = conn.metadata()
        schema, table = req["schema"], req["table"]
        handle = md.get_table_handle(schema, table)
        if handle is None:
            md.create_table(schema, table, req["columns"])
        data = conn.tables[(schema, table)]
        start = int(req.get("start", 0))
        de = PageDeserializer()
        pages = [data.canonicalize(de.deserialize(f))
                 for f in req.get("frames", [])]
        with data.lock:
            if start == 0:
                data.pages = pages
            elif start == len(data.pages):
                data.pages.extend(pages)
            else:
                return {"resync": True, "have": len(data.pages)}
            total = len(data.pages)
        return {"ok": True, "pages": total}

    # ------------------------------------------------------------------

    def _bump_pool_ref(self, qid: str):
        with self._lock:
            self._pool_refs[qid] = self._pool_refs.get(qid, 0) + 1

    def _acquire_query_pool(self, task_id: str, session: dict):
        """The per-query child of the node pool, refcounted by running
        tasks: concurrent tasks of one query share its QueryMemoryPool,
        and the last release closes it (freeing spill files). The
        session-property reads here are honored on EVERY acquire —
        ``create_query_pool`` widens a hit's budget/spill config
        instead of serving the first caller's settings stale (the
        qlint cache-coherence class: a memory-aware retry re-admits
        with an escalated budget while a straggler holds a ref)."""
        if self.node_pool is None:
            return None
        from .. import session_properties as SP

        qid = task_id.split(".", 1)[0]
        self._bump_pool_ref(qid)
        return self.node_pool.create_query_pool(
            qid,
            SP.prop_value(session, "query_max_memory_bytes"),
            SP.prop_value(session, "spill_enabled"),
            SP.prop_value(session, "spill_to_disk_enabled"))

    def _release_query_pool(self, task_id: str):
        if self.node_pool is None:
            return
        qid = task_id.split(".", 1)[0]
        # pop + release under ONE lock hold: a sibling task acquiring
        # between them would get a pool we are about to close (freed
        # contexts, reaped spill dir)
        with self._lock:
            refs = self._pool_refs.get(qid, 0) - 1
            if refs > 0:
                self._pool_refs[qid] = refs
                return
            self._pool_refs.pop(qid, None)
            self.node_pool.release_query(qid)

    def run_task(self, req: dict) -> dict:
        from ..ops.output import OutputBuffer
        from .fault import serialize_failure

        task_id = req["task_id"]
        state = _TaskState()
        fault = self._task_fault(req)
        if fault.get("kind") == "drop-connection":
            # fires at the result-serving seam, not task execution
            state.drop_results = 1
        with self._lock:
            self.tasks[task_id] = state
        if not req.get("streaming"):
            pool = self._acquire_query_pool(task_id,
                                            req.get("session", {}))
            tracer, task_span = self._open_task_span(req, task_id)
            try:
                self._apply_start_fault(fault, task_id)
                state.rows = self._execute_fragment(req, state,
                                                    fault=fault,
                                                    memory_pool=pool,
                                                    tracer=tracer,
                                                    task_span=task_span)
                state.status = "finished"
                self._count_task(True, state.rows)
                task_span.set("rows", state.rows)
                task_span.finish()
                # the attempt's observed peak, the finished spans, AND
                # the per-plan-node actuals ride the response
                # (piggyback: no extra RPC), so the coordinator's
                # MemoryEstimator can size a retry, its tracer can
                # assemble the full tree, and its history store learns
                # worker actuals
                return {"ok": True, "rows": state.rows,
                        "memory_peak": pool.peak_bytes if pool else 0,
                        "spans": tracer.finished() or None,
                        "hbo": state.hbo_actuals or None}
            except Exception as e:
                state.status = "failed"
                self._count_task(False)
                state.failure = serialize_failure(e)
                state.error = state.failure["error"]
                task_span.set("error", state.failure["error"])
                task_span.set("error_type", state.failure["error_type"])
                task_span.finish()
                traceback.print_exc()
                return dict(state.failure, task_id=task_id,
                            memory_peak=pool.peak_bytes if pool else 0,
                            spans=tracer.finished() or None)
            finally:
                self._release_query_pool(task_id)
        # streaming: the buffer must exist before we acknowledge, so
        # consumers can start pulling immediately
        frag = req["fragment"]
        state.retain = bool(req.get("durable_streams"))
        state.buffer = OutputBuffer(
            1 if frag.output_kind in ("single", "merge")
            else req["n_partitions"],
            broadcast=frag.output_kind == "broadcast",
            max_pending_pages=req.get("buffer_bound"))
        state.thread = threading.Thread(
            target=self._run_streaming, args=(req, state, fault),
            daemon=True)
        state.thread.start()
        return {"ok": True, "started": True}

    def _open_task_span(self, req: dict, task_id: str):
        """(tracer, task span) for one task attempt: parented to the
        coordinator's attempt span via the RPC trace envelope, tagged
        with attempt number / speculative flag so retries read as
        sibling attempts in the tree."""
        trace = req.get("trace")
        tracer = self._tracer_for(trace)
        attrs = {"task_id": task_id, "span_kind": "task",
                 "fragment": getattr(req.get("fragment"), "fragment_id",
                                     None),
                 "pid": os.getpid()}
        if trace:
            for key in ("attempt", "speculative"):
                if key in trace:
                    attrs[key] = trace[key]
        return tracer, tracer.span(f"task {task_id}", parent=trace,
                                   **attrs)

    @staticmethod
    def _task_fault(req: dict) -> dict:
        """The coordinator's fault directive for this launch; the
        legacy one-shot ``inject_failure`` flag maps to kind=error."""
        fault = req.get("fault") or {}
        if not fault and req.get("inject_failure"):
            fault = {"kind": "error"}
        return fault

    @staticmethod
    def _apply_start_fault(fault: dict, task_id: str):
        """Faults that fire at task start (reference:
        FailureInjector.injectTaskFailure with an error type)."""
        kind = fault.get("kind")
        if not kind:
            return
        if kind == "error":
            # chaos harness: an injected crash must present as an
            # UNtyped generic failure — that is the class under test
            raise RuntimeError(  # qlint: ignore[taxonomy] chaos harness: untyped crash IS the class under test
                f"injected failure for task {task_id}")
        if kind == "user-error":
            from ..types import TrinoError

            raise TrinoError(
                f"injected user error for task {task_id}",
                fault.get("error_code", "DIVISION_BY_ZERO"))
        if kind == "kill-worker":
            # the process dies mid-RPC: the coordinator observes a
            # connection drop, exactly like a crashed/OOM-killed worker
            sys.stderr.write(f"worker: injected kill for {task_id}\n")
            sys.stderr.flush()
            os._exit(137)
        if kind == "delay":
            time.sleep(float(fault.get("delay_s", 1.0)))

    def _run_streaming(self, req: dict, state: _TaskState, fault: dict):
        from .fault import serialize_failure
        from .remote_exchange import ExchangeConnectionLost

        pool = self._acquire_query_pool(req["task_id"],
                                        req.get("session", {}))
        tracer, task_span = self._open_task_span(req, req["task_id"])
        try:
            if fault.get("kind") == "kill-worker":
                # the worker dies mid-stream, after the coordinator
                # holds the launch's acknowledgement: a death racing
                # the ack would fail the launch RPC instead, another
                # recovery path than the one the fault stands for
                state.acked.wait(timeout=60)
            self._apply_start_fault(fault, req["task_id"])
            state.rows = self._execute_fragment(req, state,
                                                streaming=True,
                                                fault=fault,
                                                memory_pool=pool,
                                                tracer=tracer,
                                                task_span=task_span)
            state.status = "finished"
            self._count_task(True, state.rows)
            task_span.set("rows", state.rows)
            task_span.finish()
            # park spans BEFORE signalling EOS: a consumer that saw the
            # end of this buffer must find the spans already collectable
            # via task_status (no race with the span-collection poll)
            state.spans = tracer.finished()
            state.buffer.set_no_more_pages()
        except ExchangeConnectionLost as e:
            state.error = f"[connection-lost] {e!r}"
            state.failure = serialize_failure(e)
            state.failure["error"] = state.error
            state.failure["connection_lost"] = True
            state.status = "failed"
            self._count_task(False)
            state.buffer.abort()
        except Exception as e:
            state.failure = serialize_failure(e)
            state.error = state.failure["error"]
            state.status = "failed"
            self._count_task(False)
            if not state.abort.is_set():
                traceback.print_exc()
            state.buffer.abort()
        finally:
            if state.failure is not None:
                task_span.set("error", state.failure["error"])
                task_span.set("error_type",
                              state.failure["error_type"])
            task_span.finish()
            # a streaming task outlives its run_task ack: finished
            # spans park on the state for task_status collection
            if not state.spans:
                state.spans = tracer.finished()
            self._release_query_pool(req["task_id"])
            if state.spool_writer is not None \
                    and state.status != "finished":
                # never publish a failed attempt's partial frames
                state.spool_writer.abort()
            for ch in state.channels:
                ch.close()

    def _sink_factory(self, req: dict):
        """Write-sink resolution for worker-side TableWriter tasks:
        coordinator-owned catalogs (memory) write through the page-sink
        RPC; everything else uses the local connector sink."""
        remote_catalogs = set(req.get("remote_write_catalogs") or ())
        coordinator = req.get("coordinator")

        def factory(node):
            from ..exec.local_planner import create_table_idempotent
            from .remote_exchange import RemotePageSink
            from .rpc import call

            conn = self.connectors[node.catalog]
            if coordinator and node.catalog in remote_catalogs:
                if node.create:
                    resp = call(tuple(coordinator), {
                        "op": "create_table", "catalog": node.catalog,
                        "schema": node.schema, "table": node.table_name,
                        "columns": node.columns})
                    if not resp.get("ok"):
                        from .fault import INTERNAL, RemoteTaskError

                        raise RemoteTaskError(
                            f"coordinator create_table failed: "
                            f"{resp.get('error')}", INTERNAL,
                            "REMOTE_TASK_ERROR")
                return RemotePageSink(tuple(coordinator), node.catalog,
                                      node.schema, node.table_name,
                                      task_id=req["task_id"])
            if node.create:
                handle = create_table_idempotent(
                    conn, node.schema, node.table_name, node.columns)
            else:
                handle = conn.metadata().get_table_handle(
                    node.schema, node.table_name)
            return conn.page_sink(handle, node.columns)

        return factory

    def _execute_fragment(self, req: dict, state: _TaskState,
                          streaming: bool = False,
                          fault: Optional[dict] = None,
                          memory_pool=None, tracer=None,
                          task_span=None) -> int:
        """Profiling envelope: SCOPED to this fragment execution (the
        refcounted ``profiling`` context), so one VERBOSE/bench query
        cannot leave the per-call profiled path enabled for every later
        query on this worker — the session property's zero-cost-when-
        off claim holds per task."""
        from .. import session_properties as SP
        from ..telemetry.profiler import profiling

        with profiling(SP.prop_value(req.get("session", {}),
                                     "query_profiling_enabled")):
            return self._execute_fragment_body(
                req, state, streaming=streaming, fault=fault,
                memory_pool=memory_pool, tracer=tracer,
                task_span=task_span)

    def _execute_fragment_body(self, req: dict, state: _TaskState,
                               streaming: bool = False,
                               fault: Optional[dict] = None,
                               memory_pool=None, tracer=None,
                               task_span=None) -> int:
        from ..exec.driver import Driver
        from ..exec.local_planner import (LocalExecutionPlanner,
                                          grouping_options,
                                          PhysicalPipeline,
                                          project_to_wire_layout)
        from ..exec.serde import PageDeserializer
        from ..ops.output import OutputBuffer, PartitionedOutputOperator
        from ..planner.logical_planner import Metadata
        from ..telemetry.tracing import NULL_TRACER, add_driver_spans
        from .remote_exchange import (RemoteExchangeChannel,
                                      run_barrier_driver,
                                      run_driver_blocking)
        from .rpc import fetch_pages

        if tracer is None:
            tracer = NULL_TRACER
        if (fault or {}).get("kind") == "revoke-memory" \
                and memory_pool is not None:
            memory_pool.fault_revoke_countdown = \
                max(1, int(fault.get("countdown") or 1))
        frag = req["fragment"]
        upstream: Dict[int, dict] = req["upstream"]
        task_index = req["task_index"]
        rpc_timeout = float(req.get("session", {}).get(
            "rpc_request_timeout", 600.0))
        coordinator = req.get("coordinator")
        recover = None
        if streaming and req.get("partial_retry") and coordinator:
            from .rpc import call as _coord_call

            def recover(lost_task_id, cursor, failed_addr):
                # partial-stage retry: ask the coordinator where the
                # lost producer's output lives NOW — a restarted task
                # (repoint + replay from our ack cursor) or its durable
                # spool — instead of failing the whole query
                resp = _coord_call(tuple(coordinator), {
                    "op": "resolve_task", "task_id": lost_task_id,
                    "cursor": int(cursor),
                    "failed_addr": list(failed_addr)},
                    timeout=rpc_timeout)
                return resp.get("resolution")

        def exchange_reader(fragment_id: int, kind: str):
            src = upstream[fragment_id]
            if kind == "merge":
                # one sorted stream PER PRODUCER TASK for the consumer's
                # k-way merge (each producer buffers its run at
                # partition 0 of its own task buffer)
                if src.get("spool_dir"):
                    from .spool import spool_task_cursor

                    # page-range cursors: the merge streams the durable
                    # runs frame-per-page instead of materializing files
                    cursors = [spool_task_cursor(src["spool_dir"], 0, i)
                               for i in range(len(src["locations"]))]
                    state.channels.extend(cursors)
                    return cursors
                if streaming:
                    chans = [RemoteExchangeChannel([loc], 0,
                                                   consumer_id=task_index,
                                                   rpc_timeout=rpc_timeout,
                                                   recover=recover)
                             for loc in src["locations"]]
                    state.channels.extend(chans)
                    return chans

                def task_thunk(loc):
                    def thunk():
                        return fetch_pages(tuple(loc[0]), loc[1], 0,
                                           timeout=rpc_timeout)

                    return thunk

                return [task_thunk(loc) for loc in src["locations"]]
            part = 0 if src["kind"] in ("single", "broadcast") \
                else task_index
            if src.get("spool_dir"):
                # fault-tolerant mode: inputs replay from the durable
                # spool — the producing worker may be gone; the cursor
                # channel streams it frame-per-page
                from .spool import spool_channel

                chan = spool_channel(src["spool_dir"], part)
                state.channels.append(chan)
                return chan
            if streaming:
                chan = RemoteExchangeChannel(
                    src["locations"], part, consumer_id=task_index,
                    rpc_timeout=rpc_timeout, recover=recover)
                state.channels.append(chan)
                return chan

            def thunk():
                pages: List = []
                for addr, up_task in src["locations"]:
                    pages.extend(fetch_pages(tuple(addr), up_task, part,
                                             timeout=rpc_timeout))
                return pages

            return thunk

        session_props = req.get("session", {})
        metadata = Metadata(self.connectors)
        from .. import session_properties as SP

        hbo_on = SP.prop_value(session_props, "hbo_enabled")
        hbo_ctx = None
        if hbo_on:
            # the worker TAGS operators with node fingerprints (actuals
            # ride the task response back to the coordinator's store)
            # AND, when the coordinator shipped the statement binding,
            # READS the configure-time seed through the worker-local
            # store — worker-side planning decisions (adaptive
            # partial-agg seeding) then run from the same history the
            # coordinator planned from. Binding absent = tag-only.
            from ..telemetry import stats_store
            from ..telemetry.stats_store import HboContext

            binding = req.get("hbo") or {}
            hbo_ctx = HboContext(
                binding.get("stmt_fp", ""), binding.get("snap", ""),
                stats_store.store() if binding else None)
        planner = LocalExecutionPlanner(
            metadata, self.device, req.get("desired_splits", 8),
            task_id=task_index, task_count=req["task_count"],
            exchange_reader=exchange_reader,
            memory_pool=memory_pool,
            join_max_lanes=session_props.get("join_max_expand_lanes"),
            dynamic_filtering=session_props.get(
                "enable_dynamic_filtering", True),
            page_sink_factory=self._sink_factory(req),
            scan_coalesce=session_props.get("scan_coalesce_enabled", True),
            hbo=hbo_ctx, **grouping_options(session_props))

        with tracer.span("plan", parent=task_span,
                         task_id=req["task_id"]):
            ops, layout, types_ = planner.visit(frag.root)
            ops, layout, types_, key_channels = project_to_wire_layout(
                frag, ops, layout, types_)
        if streaming:
            buffer = state.buffer  # pre-created by run_task
            ss = req.get("spool_stream")
            if ss:
                # tee every emitted page into the external spool: this
                # task's output then outlives the process, and a
                # consumer that loses the stream replays committed
                # pages from the backend. The tee mirrors enqueue's
                # empty-page skip so spool page N == stream page N
                # (the ack cursor indexes both identically).
                from .spool_backend import SpooledTaskWriter, backend_for

                writer = SpooledTaskWriter(
                    backend_for(ss["dir"]), ss["query"], ss["stage"],
                    ss["task"], int(ss.get("attempt") or 0),
                    1 if frag.output_kind in ("single", "merge",
                                              "broadcast")
                    else req["n_partitions"])
                state.spool_writer = writer
                orig_enqueue = buffer.enqueue
                broadcast_out = frag.output_kind == "broadcast"

                def tee_enqueue(partition, page, _orig=orig_enqueue,
                                _w=writer, _bc=broadcast_out):
                    if page.num_rows:
                        _w.add(0 if _bc else partition, page)
                    _orig(partition, page)

                buffer.enqueue = tee_enqueue
        else:
            buffer = OutputBuffer(
                1 if frag.output_kind in ("single", "merge")
                else req["n_partitions"],
                broadcast=frag.output_kind == "broadcast")
            state.buffer = buffer
        rebalancer = None
        if frag.output_kind == "hash" and getattr(frag, "scale_writers",
                                                  False):
            from .. import session_properties as SP
            from .rebalancer import writer_rebalancer

            rebalancer = writer_rebalancer(
                (str(t) for t in types_), req["n_partitions"],
                SP.prop_value(session_props,
                              "rebalance_min_collectives"))
            buffer.rebalancer = rebalancer  # stage-level stats surface
        from .. import session_properties as SP

        ops.append(PartitionedOutputOperator(
            types_, key_channels, buffer, frag.output_kind,
            rebalancer=rebalancer,
            hot_split_threshold=SP.prop_value(
                session_props, "hot_partition_split_threshold")))
        planner.pipelines.append(PhysicalPipeline(ops))
        # the exec span is the driver-run wall: its operator children's
        # busy time must account for ~all of it (the trace-tree test's
        # attribution invariant); stats collection costs two clock
        # reads per page move and only runs when tracing or history
        # recording wants the per-operator counts
        with tracer.span("exec", parent=task_span,
                         task_id=req["task_id"],
                         span_kind="exec") as exec_span:
            drivers = []
            for p in planner.pipelines:
                d = Driver(p.operators,
                           collect_stats=tracer.enabled or hbo_on)
                drivers.append(d)
                if streaming:
                    run_driver_blocking(d, state.abort)
                else:
                    run_barrier_driver(d, state.abort)
        for d in drivers:
            add_driver_spans(tracer, d, exec_span)
        if hbo_ctx is not None:
            for d in drivers:
                d.collect_operator_metrics()
            state.hbo_actuals = hbo_ctx.collect_actuals(
                [st for d in drivers for st in d.stats])
        if streaming and state.spool_writer is not None:
            if state.abort.is_set():
                state.spool_writer.abort()
            else:
                state.spool_writer.commit()
                if (fault or {}).get("kind") == "kill-after-publish":
                    # the spool now owns the output: dying here must
                    # not cost consumers anything
                    sys.stderr.write(
                        f"worker: injected kill after publish for "
                        f"{req['task_id']}\n")
                    sys.stderr.flush()
                    os._exit(137)
        spool_dir = req.get("spool_dir")
        if spool_dir:
            # durable publish BEFORE reporting success: a retried
            # consumer must find the complete output on disk even if
            # this process dies right after responding
            from .spool import ExchangeSink

            if state.abort.is_set():
                # a sibling attempt already won (speculative execution):
                # publishing now would race the query teardown
                from .fault import INTERNAL, RemoteTaskError

                raise RemoteTaskError(
                    f"task {req['task_id']} aborted before spool "
                    f"publish", INTERNAL, "GENERIC_INTERNAL_ERROR")
            nparts = 1 if frag.output_kind in ("single", "broadcast",
                                               "merge") \
                else req["n_partitions"]
            sink = ExchangeSink(spool_dir, task_index, nparts)
            try:
                for part in range(nparts):
                    for page in buffer.pages(part):
                        sink.add(part, page)
                sink.finish()
            except BaseException:
                sink.abort()
                raise
            self._apply_post_publish_fault(fault or {}, req, spool_dir,
                                           task_index, nparts)
        if not streaming and (fault or {}).get("kind") \
                == "kill-after-publish" and not spool_dir:
            # no durable output was requested: treat as plain kill
            sys.stderr.write(f"worker: injected kill for "
                             f"{req['task_id']}\n")
            sys.stderr.flush()
            os._exit(137)
        return buffer.total_rows

    @staticmethod
    def _apply_post_publish_fault(fault: dict, req: dict,
                                  spool_dir: str, task_index: int,
                                  nparts: int):
        """Faults that fire AFTER the durable publish: the retry path
        must observe first-publish-wins (fail-after-publish) and detect
        torn files (truncate-spool)."""
        kind = fault.get("kind")
        if kind == "fail-after-publish":
            # chaos harness: deliberately untyped, like a real crash
            raise RuntimeError(  # qlint: ignore[taxonomy] chaos harness: untyped crash IS the class under test
                f"injected failure after spool publish for task "
                f"{req['task_id']}")
        if kind == "kill-after-publish":
            # the process dies right after the durable publish: retried
            # consumers must be served from the spool, not a relaunch
            sys.stderr.write(f"worker: injected kill after publish for "
                             f"{req['task_id']}\n")
            sys.stderr.flush()
            os._exit(137)
        if kind == "truncate-spool":
            # tear the last published partition file mid-frame: readers
            # must fail loudly (short read), never return partial rows
            for part in reversed(range(nparts)):
                path = os.path.join(spool_dir,
                                    f"p{part}.t{task_index}.bin")
                size = os.path.getsize(path)
                if size > 3:
                    with open(path, "r+b") as f:
                        f.truncate(size - 3)
                    break

    # ------------------------------------------------------------------

    def send_results(self, sock, task_id: str, partition: int):
        from ..exec.serde import PageSerializer
        from .fault import EXTERNAL

        with self._lock:
            state = self.tasks.get(task_id)
        if state is None or state.status != "finished":
            resp = {"error": f"task {task_id} not finished "
                    f"({'missing' if state is None else state.status})"}
            if state is None:
                # buffers gone (released/expired): transport-class loss
                resp.update(error_type=EXTERNAL, connection_lost=True)
            elif state.failure is not None:
                # surface the REAL task failure (type + remote stack),
                # not a flattened "not finished" string
                resp = dict(state.failure)
            send_msg(sock, resp)
            return
        pages = state.buffer.pages(partition)
        ser = PageSerializer()
        frames = [ser.serialize(p) for p in pages]
        if state.drop_results > 0:
            state.drop_results -= 1
            self._send_torn_frame(sock, {"n_pages": len(frames)}, frames)
            return
        send_msg(sock, {"n_pages": len(frames)})
        for f in frames:
            send_frame(sock, f)

    @staticmethod
    def _send_torn_frame(sock, head: dict, frames: List[bytes]):
        """Injected drop-RPC-connection-mid-frame (one seam for both
        pull paths): claim the full response, ship half of the first
        frame, close. The consumer sees "peer closed mid-frame" exactly
        as with a worker crash between frames."""
        import struct as _struct

        send_msg(sock, head)
        blob = frames[0] if frames else b"\0" * 64
        sock.sendall(_struct.pack("<I", len(blob)) +
                     blob[:max(1, len(blob) // 2)])
        sock.close()

    def stream_results(self, sock, req: dict):
        """Incremental long-poll pull of one consumer's partition with
        an ACK-BASED CURSOR (reference: TaskResource GET results with
        the ack token): ``cursor`` is the index of the first frame the
        consumer wants, ``ack`` the range it confirms received. Frames
        past the ack stay retained (_RetainedStream), so a connection
        torn mid-frame reconnects and replays byte-identical frames
        from the consumer's cursor instead of failing the query."""
        from ..ops.output import wait_readable

        task_id = req["task_id"]
        partition = req["partition"]
        consumer = req.get("consumer_id", 0)
        cursor = int(req.get("cursor", 0))
        ack = int(req.get("ack", cursor))
        deadline = time.monotonic() + float(req.get("wait", 0.5))
        with self._lock:
            state = self.tasks.get(task_id)
        if state is None or state.buffer is None:
            send_msg(sock, {"error": f"task {task_id} missing",
                            "connection_lost": True})
            return
        buf = state.buffer
        with self._lock:
            rs = state.streams.setdefault((partition, consumer),
                                          _RetainedStream())
        if not state.retain:
            # durable streams keep every frame: a restarted consumer
            # re-enters at cursor 0 and must find the full stream
            rs.discard_acked(min(ack, cursor))
        while True:
            with rs.lock:
                # serialize newly-drained pages onto the retained tail
                # (a reconnect's replay re-sends these same bytes, so
                # one serde stream per consumer stays consistent)
                while rs.base + len(rs.frames) - cursor < 64:
                    p = buf.poll(partition, consumer)
                    if p is None:
                        break
                    rs.frames.append(rs.ser.serialize(p))
                start = max(cursor, rs.base)
                frames = list(rs.frames[start - rs.base:])
                # frames below the sent high-water mark are re-sends of
                # a torn response: the replay-counter observability
                replayed = max(0, min(rs.sent, start + len(frames))
                               - start)
                rs.sent = max(rs.sent, start + len(frames))
            done = False
            if buf.at_end(partition, consumer):
                # re-check the retained tail AFTER observing at_end: a
                # stale duplicate handler (consumer timed out and
                # reconnected while we were parked) may have drained
                # more pages between our snapshot and the buffer
                # emptying — done against the stale total would drop
                # that tail silently
                with rs.lock:
                    done = start + len(frames) == \
                        rs.base + len(rs.frames)
            # status AFTER at_end: abort() follows the status write, so
            # an at_end that observed the aborted (emptied) buffer is
            # guaranteed to see status=="failed" here — a done=True
            # reply must never paper over a failure as clean EOS
            if state.status == "failed":
                resp = dict(state.failure) if state.failure else {}
                resp.setdefault("error", state.error or "task failed")
                resp.setdefault("connection_lost", "[connection-lost]"
                                in (state.error or ""))
                send_msg(sock, resp)
                return
            if frames or done or time.monotonic() >= deadline:
                break
            wait_readable(buf, timeout=min(
                0.25, max(0.0, deadline - time.monotonic())))
        head = {"n_pages": len(frames), "start": start, "done": done,
                "replayed": replayed}
        if state.drop_results > 0 and frames:
            # injected mid-frame drop on the streaming pull: the frames
            # stay retained (unacked), so the reconnecting consumer
            # replays them from its cursor — byte-equal, no query retry
            state.drop_results -= 1
            self._send_torn_frame(sock, head, frames)
            return
        send_msg(sock, head)
        for f in frames:
            send_frame(sock, f)

    def serve_forever(self):
        self.server.serve_forever()


def open_device(device):
    """Open ``device`` before the worker reports ready: one allocation
    and a synchronize create the CUDA context here, so a card that is
    absent or full fails the start, not the first task. A CPU worker
    runs torch on one intra-op thread: the host runs the coordinator and
    every worker, each with its own task threads."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            from ..types import DeviceUnavailableError

            raise DeviceUnavailableError("no CUDA device is available")
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    else:
        torch.set_num_threads(1)
    return device


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="trino_tpu_torch.parallel.worker")
    parser.add_argument("port", nargs="?", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    try:
        device = open_device(args.device)
        server = WorkerServer(args.port, device)
    except Exception as e:  # qlint: ignore[taxonomy] a start-up failure ends the process: reported as WORKER_FAILED <cause> (the coordinator's error names it), then exit 1
        print(f"WORKER_FAILED {type(e).__name__}: {e}".replace("\n", " "),
              flush=True)
        sys.exit(1)
    print(f"WORKER_READY {server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
