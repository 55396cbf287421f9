"""ProcessQueryRunner: coordinator + N real worker processes.

Reference analog: the actual deployment shape — a coordinator scheduling
fragments onto worker JVMs over task RPC
(``server/remotetask/HttpRemoteTask.java:599``), workers pulling shuffle
data from each other (``operator/DirectExchangeClient.java``), plus the
failure-detector / retry seam (``failuredetector/
HeartbeatFailureDetector.java:78``, ``dispatcher/``).

Round-5 shape: a real MPP engine —
- STREAMING execution (default): every fragment's tasks start at once
  across the worker processes, exchange data flows over incremental
  long-poll pulls with end-to-end backpressure, and a mid-plan stage's
  consumer can be draining pages while the producer is still running
  (reference: execution/scheduler/PipelinedQueryScheduler.java:155);
  failures retry the whole query (RetryPolicy.QUERY — outputs are not
  durable; the spooled exchange adds task-level retry);
- CONCURRENT queries: no coordinator-wide lock; per-query scheduling
  state is call-local and workers multiplex tasks of many queries;
- DISTRIBUTED writes: INSERT/CTAS writer tasks run on the workers and
  ship written pages to the coordinator's catalog over the page-sink
  RPC; commits replicate the table to every worker (replicated memory
  storage), so subsequent distributed scans read local replicas;
- barrier mode (session ``streaming_execution=false``): stage-by-stage
  with whole-output buffering and task-level retry on another worker.

Round-6 shape: SELF-HEALING fault tolerance —
- worker replacement: a background heartbeat loop (and the on-demand
  heal on worker loss) detects dead workers, respawns a replacement
  process, re-registers it and re-syncs replicated tables, so capacity
  recovers instead of decaying to "no live workers";
- failure taxonomy: every task/RPC failure carries a USER / INTERNAL /
  EXTERNAL / INSUFFICIENT_RESOURCES type plus the remote traceback
  (parallel/fault.py); USER errors fail fast with ZERO retries, only
  infrastructure faults consume the retry budget;
- deadlines + backoff: ``query_max_run_time`` caps every
  coordinator->worker RPC, ``rpc_request_timeout`` replaces the old
  hardwired 600 s, and query/task retries use seeded exponential
  backoff inside a per-query attempt budget (``retry_max_attempts``);
- speculative stragglers: under retry_policy=TASK a task running far
  past the median of its completed siblings is re-dispatched on another
  worker — the spool's first-publish-wins rename makes the duplicate
  safe;
- deterministic chaos: ``FaultSchedule`` injects kill-worker /
  drop-connection / delay / fail-after-publish / truncate-spool faults
  by (task-id pattern, occurrence), seeded for exact replay.

Round-7 shape: CLUSTER MEMORY GOVERNANCE —
- every heartbeat ping piggybacks the worker's NodeMemoryPool snapshot
  into the coordinator's ``ClusterMemoryManager`` (reference:
  memory/ClusterMemoryManager.java polling MemoryInfo);
- a pluggable low-memory killer (``memory_killer_policy``) kills the
  policy-chosen victim query when nodes report blocked pools, with
  EXCEEDED_CLUSTER_MEMORY (INSUFFICIENT_RESOURCES);
- INSUFFICIENT_RESOURCES retries are MEMORY-AWARE: the next attempt
  re-admits with a budget grown from the observed peak
  (``MemoryEstimator``; the ``memory_peak`` each task response
  piggybacks) and a halved concurrent-task width;
- task/retry placement consults per-worker decaying failure stats
  (``DecayingFailureStats``) so flapping workers shed load.

The JAX engine's ``trino_tpu/parallel/process_runner.py`` on torch. The
runner has a device (``"cuda"`` unless the caller passes ``"cpu"``; CUDA
asked for and absent raises) and hands it to every worker it spawns
(``python -m trino_tpu_torch.parallel.worker --device ...``); the
coordinator runs the output fragment, and any statement it executes
locally, on the same device. On CUDA the runner builds the kernel
library once before it spawns the workers, so N workers do not each run
``nvcc``; each worker loads it into its own CUDA context. Query, attempt
and task ids are formatted exactly as the JAX engine formats them
(``q{n}a{attempt}.f{fragment}.t{task}...``), so one ``FaultSchedule``
arms the same tasks in both engines.
"""

from __future__ import annotations

import os
import select
import socketserver
import statistics
import subprocess
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from .. import session_properties as SP
from .. import types as T
from ..block import Page
from ..events import (EventListenerManager, MemoryKillEvent,
                      NodeJoinedEvent, NodeRetiredEvent, QueryMonitor,
                      TaskRetryEvent, WorkerReplacedEvent)
from ..exec.serde import PageDeserializer, PageSerializer
from ..exec.stats import QueryStatsTree
from ..planner.fragmenter import PlanFragment
from ..runner import QueryResult
from ..sql import ast
from ..sql.analyzer import Session
from ..sql.parser import parse_statement
from ..telemetry.metrics import ClusterMetrics
from ..telemetry.tracing import (NULL_SPAN, NULL_TRACER, Tracer,
                                 add_driver_spans)
from ..types import TrinoError
from .autoscaler import Autoscaler
from .cluster import ClusterLedger, place_task
from .cluster_memory import ClusterMemoryManager
from .fault import (EXTERNAL, INSUFFICIENT_RESOURCES, INTERNAL, USER,
                    BackoffPolicy, Deadline, DecayingFailureStats,
                    FaultSchedule, RecoveryStats, RemoteTaskError,
                    classify_error_code, classify_exception,
                    serialize_failure)
from .rpc import call, fetch_pages, recv_msg, send_msg, with_trace
from .spool_backend import (LocalFileSpoolBackend, backend_for,
                            committed_attempt)


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, addr: Tuple[str, int],
                 generation: int = 0):
        self.proc = proc
        self.addr = addr
        self.alive = True
        self.generation = generation   # bumps on replacement
        #: exponentially-decayed failure score (reference:
        #: HeartbeatFailureDetector): placement prefers low scores so a
        #: flapping worker sheds load without being fenced outright
        self.failure_stats = DecayingFailureStats()
        #: replication cursors: (catalog, schema, table) -> number of
        #: committed pages this worker's replica already holds, so
        #: append-only commits ship only the tail (not O(N^2) re-sends)
        self.synced: Dict[Tuple[str, str, str], int] = {}
        #: seed-import observability (set at configure time): how many
        #: HBO statements / template shapes the worker imported, and
        #: the template-seed version last shipped (heartbeat delta gate)
        self.hbo_seeded = 0
        self.template_seeded = 0
        self.template_seed_version = 0
        #: elastic-membership state: a draining worker finishes its
        #: running tasks but takes no NEW placements; node_id /
        #: member_generation tie the handle to its ledger record so a
        #: straggling RPC against a retired slot is attributable
        self.draining = False
        self.node_id: Optional[str] = None
        self.member_generation = 0
        #: exchange-sizing seed rows the worker imported at configure
        self.sizing_seeded = 0

    def rpc(self, request: dict, timeout: float = 600.0) -> dict:
        return call(self.addr, request, timeout=timeout)


#: a worker whose decayed failure score reaches this is skipped for
#: placement while any healthier candidate exists: one fresh failure
#: (score 1.0) keeps a worker avoided for a full half-life
_FLAPPING_SCORE = 0.5


def prefer_healthy(workers: List[WorkerHandle]) -> List[WorkerHandle]:
    """Placement filter over live workers: drop the ones currently
    scored as flapping, unless that would leave nobody."""
    healthy = [w for w in workers
               if w.failure_stats.score() < _FLAPPING_SCORE]
    return healthy or workers


class _QueryCtx:
    """Per-query retry/deadline state threaded through one execution:
    call-local so concurrent queries cannot perturb each other."""

    def __init__(self, session: Session, seed_id: str):
        self.deadline = Deadline(SP.value(session, "query_max_run_time"))
        self.rpc_timeout = float(SP.value(session, "rpc_request_timeout"))
        self.backoff = BackoffPolicy(
            initial=SP.value(session, "retry_initial_backoff"),
            maximum=SP.value(session, "retry_max_backoff"),
            seed=BackoffPolicy.seed_for(seed_id))
        self.recovery = RecoveryStats()
        self.spec_enabled = SP.value(session,
                                     "speculative_execution_enabled")
        self.spec_multiplier = SP.value(session, "speculation_multiplier")
        self.spec_min_s = SP.value(session, "speculation_min_seconds")
        #: memory-aware retry state: per-attempt session overrides
        #: (grown query_max_memory_bytes) and reduced task width, set by
        #: the escalation path after an INSUFFICIENT_RESOURCES failure
        self.session_overrides: Dict[str, object] = {}
        self.task_width: Optional[int] = None
        #: distributed-trace state (telemetry.tracing): the per-query
        #: tracer plus the root and current-attempt spans fragment/task
        #: spans parent to; the shared no-op defaults make every span
        #: site zero-cost when query_tracing_enabled is off
        self.tracer = NULL_TRACER
        self.root_span = NULL_SPAN
        self.attempt_span = NULL_SPAN
        #: history-based statistics (telemetry.stats_store): the
        #: per-query HboContext (None = hbo off / unversionable
        #: statement), the plan root of the winning attempt, and the
        #: per-task actual lists piggybacked on task responses
        self.hbo = None
        self.hbo_root = None
        self.hbo_actuals: List[list] = []
        self.hbo_lock = threading.Lock()
        #: membership width CAPTURED once per attempt: an elastic
        #: scale-up/down mid-query must not skew task fan-out against
        #: the already-planned partition count
        self.cluster_width: Optional[int] = None

    def timeout(self, base: Optional[float] = None) -> float:
        """RPC timeout capped by the query deadline (raises
        EXCEEDED_TIME_LIMIT once the deadline passed)."""
        return self.deadline.rpc_timeout(
            self.rpc_timeout if base is None else base)


class _CoordinatorService:
    """The coordinator's own RPC endpoint: write sinks and DDL from
    worker-side TableWriter tasks land here (the metastore/commit half
    of the reference's coordinator)."""

    def __init__(self, runner: "ProcessQueryRunner"):
        outer = runner

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = recv_msg(self.request)
                except ConnectionError:
                    return
                try:
                    send_msg(self.request, outer._service_dispatch(req))
                except Exception as e:
                    traceback.print_exc()
                    try:
                        # full taxonomy payload, not a bare repr: the
                        # caller's retry dispatch needs the error type
                        send_msg(self.request, serialize_failure(e))
                    except OSError:
                        pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server(("127.0.0.1", 0), Handler)
        self.addr = ("127.0.0.1", self.server.server_address[1])
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()


class ProcessQueryRunner:
    """Coordinator over N spawned worker processes, all on ``device``
    (``"cuda"`` by default; a runner asked for CUDA on a machine without
    a GPU raises; tests pass ``"cpu"``)."""

    def __init__(self, catalogs: Dict[str, dict],
                 session: Optional[Session] = None,
                 n_workers: int = 2, desired_splits: int = 8,
                 broadcast_threshold: Optional[float] = None,
                 task_retries: int = 1,
                 heartbeat_interval: Optional[float] = 5.0,
                 worker_replacement: bool = True,
                 event_listeners: Optional[list] = None,
                 resource_groups=None, device="cuda"):
        from ..connectors.catalog import create_catalogs
        from ..planner.logical_planner import Metadata

        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise T.DeviceUnavailableError(
                    "ProcessQueryRunner: device 'cuda' requested but no "
                    "CUDA device is available; pass device='cpu' to run "
                    "on the CPU")
            # one build before the spawn: N workers would each run nvcc
            from ..ops import kernels

            kernels.build()

        self.catalog_config = catalogs
        self.connectors = create_catalogs(catalogs)
        self.metadata = Metadata(self.connectors)
        self.session = session or Session(
            catalog=next(iter(catalogs), None))
        self.n_workers = n_workers
        self.desired_splits = desired_splits
        self.broadcast_threshold = broadcast_threshold \
            if broadcast_threshold is not None \
            else SP.value(self.session, "broadcast_join_threshold")
        self.task_retries = task_retries
        #: write staging (commit-on-query-success): attempt task id ->
        #: [(catalog, schema, table, Page)]
        self._staged: Dict[str, list] = {}
        self._sink_streams: Dict[tuple, PageDeserializer] = {}
        self._stage_lock = threading.Lock()
        self.workers: List[WorkerHandle] = []
        #: deterministic chaos harness (generalizes the seed's one-shot
        #: inject_task_failure); armed faults ride along run_task
        self.fault_schedule = FaultSchedule()
        #: every task attempt launched (test observability: retry-from-
        #: spool asserts producer stages launch exactly once)
        self.task_launches: List[str] = []
        self._seq_lock = threading.Lock()
        self._task_seq = 0
        # catalogs whose committed state is OWNED by the coordinator and
        # replicated to workers (the memory connector): writes RPC here,
        # commits push replicas out
        self._replicated = {name for name, c in catalogs.items()
                            if c.get("connector", name) == "memory"}
        #: cumulative self-healing counters across all queries + the
        #: background monitor (per-query deltas ride QueryResult.stats)
        self.recovery_total = RecoveryStats()
        self.event_manager = EventListenerManager(
            list(event_listeners or ()))
        #: coordinator-side memory governance: aggregates pool snapshots
        #: piggybacked on heartbeats, enforces query_max_total_memory,
        #: and runs the low-memory killer (ref: ClusterMemoryManager)
        self.cluster_memory = ClusterMemoryManager(
            SP.value(self.session, "memory_killer_policy"),
            SP.value(self.session, "query_max_total_memory"))
        #: coordinator-side aggregation of the metric snapshots each
        #: heartbeat ping piggybacks (served on GET /v1/metrics and
        #: system.runtime.metrics)
        self.cluster_metrics = ClusterMetrics()
        # the system catalog serves this coordinator's live state as
        # SQL tables (system.runtime.*); it stays coordinator-local —
        # worker processes never see it in catalog_config
        if "system" not in self.connectors:
            from ..connectors.system import SystemConnector

            self.connectors["system"] = SystemConnector(source=self)
            self.metadata = Metadata(self.connectors)
        self.worker_replacement = worker_replacement
        self.heartbeat_interval = heartbeat_interval
        #: slot indexes with a replacement in flight (guarded by
        #: _heal_lock): concurrent heals claim before spawning, so one
        #: dead worker never gets two replacements; releases notify
        #: _heal_done so a heal that found its slots already claimed
        #: can WAIT for the concurrent replacement instead of reporting
        #: the slot dead
        self._healing: set = set()
        self._heal_lock = threading.Lock()
        self._heal_done = threading.Condition(self._heal_lock)
        self._closed = threading.Event()
        #: resource-group admission (a ResourceGroupManager or None =
        #: unmanaged): execute() runs each statement under the user's
        #: group, which makes queue depth a real autoscaling signal
        self.resource_groups = resource_groups
        #: membership event log + generation counter (the ledger behind
        #: system.runtime.nodes; self.workers stays the placement view)
        self.cluster = ClusterLedger()
        #: deterministic scale-up/down policy, monitor-thread driven
        self.autoscaler = Autoscaler()
        #: durable stream-output store: under partial_stage_retry every
        #: streaming task TEES its output pages here, so a task's
        #: published output outlives its worker process
        self.stream_spool = LocalFileSpoolBackend()
        #: partial-retry registry: wire task_id -> relaunch state
        self._stream_tasks: Dict[str, dict] = {}
        self._stream_lock = threading.Lock()
        self.service = _CoordinatorService(self)
        self._spawn_workers()
        self._monitor_thread = None
        if heartbeat_interval is not None and worker_replacement:
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, daemon=True)
            self._monitor_thread.start()

    # -- cluster lifecycle ----------------------------------------------

    def _spawn_worker_process(self, generation: int = 0,
                              reason: str = "initial",
                              index: int = -1) -> WorkerHandle:
        # fork + exec: a fresh interpreter that opens its own CUDA
        # context (this process may hold one already, and a forked CUDA
        # context is unusable)
        proc = subprocess.Popen(
            [sys.executable, "-m", "trino_tpu_torch.parallel.worker",
             "--device", str(self.device)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            text=True)
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline:
            # bounded: a worker hung before its first line must not
            # block the coordinator past the deadline
            ready, _, _ = select.select(
                [proc.stdout], [], [], max(0.0, deadline - time.time()))
            if not ready:
                break
            line = proc.stdout.readline()
            if line.startswith(("WORKER_READY", "WORKER_FAILED")):
                break
            if line == "" or proc.poll() is not None:
                break  # EOF: the worker died during startup
        if not line.startswith("WORKER_READY"):
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
            cause = line[len("WORKER_FAILED"):].strip() \
                if line.startswith("WORKER_FAILED") else "no ready line"
            raise TrinoError(
                f"worker failed to start on {self.device}: {cause}",
                "GENERIC_INTERNAL_ERROR")
        port = int(line.split()[1])
        handle = WorkerHandle(proc, ("127.0.0.1", port), generation)
        cfg = {"op": "configure",
               "catalogs": self.catalog_config,
               "properties": dict(self.session.properties)}
        if SP.value(self.session, "hbo_enabled"):  # qlint: ignore[cache-coherence] _replace_worker's slot swap memo-matches a builder, but configure must see the LIVE flag (SET SESSION can flip hbo_enabled after construction)
            # piggyback a bounded history snapshot: workers tag and
            # report actuals but PLAN locally too (adaptive partial-agg
            # seeding) — without this they plan from nothing, and a
            # replacement worker spawned mid-life would forever lag
            # the cluster's learned cardinalities
            from ..telemetry.stats_store import store as _hbo_store

            seed = _hbo_store().export_seed()
            if seed["statements"]:
                cfg["hbo_seed"] = seed
        from ..cache import template_seeds as _tseeds

        if (SP.value(self.session, "plan_template_enabled")  # qlint: ignore[cache-coherence] same LIVE-flag rule as hbo_enabled above: SET SESSION can flip the knobs after construction
                and SP.value(self.session, "plan_template_seed_enabled")):  # qlint: ignore[cache-coherence] same LIVE-flag rule as hbo_enabled above
            # template-earn state rides beside the HBO seed (round 17):
            # a replacement worker rides already-earned plan templates
            # on its first statement instead of re-earning
            # min_shape_uses locally
            tseed = _tseeds().export_seed()
            if tseed["shapes"]:
                cfg["template_seed"] = tseed
        # exchange-sizing knowledge rides beside the HBO/template seeds:
        # a joiner (scale-up OR replacement) presizes its device
        # exchanges from cluster history instead of re-learning
        from .device_exchange import SIZING_HISTORY

        sseed = SIZING_HISTORY.export_seed()
        if sseed:
            cfg["sizing_seed"] = sseed
        resp = handle.rpc(cfg, timeout=60)
        #: statements the seed actually imported into the worker's
        #: store (observability: tests + replacement-worker freshness)
        handle.hbo_seeded = int(resp.get("hbo_seeded") or 0)
        #: shapes the template seed imported (same observability role)
        handle.template_seeded = int(resp.get("template_seeded") or 0)
        #: template-seed version last shipped to this worker — the
        #: heartbeat re-ships only when the local store has advanced
        handle.template_seed_version = _tseeds().version
        handle.sizing_seeded = int(resp.get("sizing_seeded") or 0)
        node = self.cluster.record_join(handle.addr, proc.pid,
                                        reason=reason)
        handle.node_id = node.node_id
        handle.member_generation = node.generation
        self.event_manager.fire_node_joined(NodeJoinedEvent(
            node.node_id, index, proc.pid, node.generation, reason,
            time.time()))
        return handle

    def _spawn_workers(self):
        for i in range(self.n_workers):  # qlint: ignore[guarded-by] pre-publication: __init__ runs before the monitor thread exists
            self.workers.append(self._spawn_worker_process(index=i))  # qlint: ignore[guarded-by] pre-publication: __init__ appends before the monitor thread exists

    @staticmethod
    def _placeable(workers: List[WorkerHandle]) -> List[WorkerHandle]:
        """Live workers eligible for NEW task placement: a draining
        worker finishes what it has but takes nothing new (falls back
        to the full live set if everyone is draining)."""
        live = [w for w in workers if w.alive]
        active = [w for w in live if not w.draining]
        return active or live

    def add_workers(self, n: int, reason: str = "scale-up") -> int:
        """Elastic scale-up: spawn + configure (catalogs, session, and
        the HBO / template / sizing seeds — exactly the replacement
        path), re-sync replicated tables, then PUBLISH the slot. The
        slow work runs outside _heal_lock; only the append takes it.
        Returns the number of workers that actually joined."""
        added = 0
        for _ in range(max(0, n)):
            if self._closed.is_set():
                break
            with self._heal_lock:
                next_index = len(self.workers)
            try:
                new = self._spawn_worker_process(
                    reason=reason, index=next_index)
                self._sync_worker_replicas(new)
            except Exception as e:
                print(f"[scale-up] worker join failed "
                      f"({classify_exception(e)}): {e!r}",
                      file=sys.stderr)
                traceback.print_exc()
                break
            with self._heal_lock:
                torn = self._closed.is_set()
                if not torn:
                    self.workers.append(new)
                    self.n_workers = len(self.workers)
            if torn:  # cluster closed mid-join: reap the orphan
                try:
                    new.proc.kill()
                except OSError:
                    pass
                break
            added += 1
        return added

    def retire_worker(self, slot: int, drain: bool = True,
                      timeout: float = 60.0,
                      reason: str = "scale-down") -> bool:
        """Elastic scale-down: mark the slot draining (placement skips
        it), wait for its running tasks to finish, then remove it from
        the membership and reap the process. Refuses to retire the
        last non-draining live worker. Returns True once it left."""
        with self._heal_lock:
            if not (0 <= slot < len(self.workers)):
                return False
            w = self.workers[slot]
            others = [x for x in self.workers
                      if x is not w and x.alive and not x.draining]
            if not others:
                return False
            w.draining = True
        if w.node_id is not None:
            self.cluster.mark_draining(w.node_id)
        drained = not drain
        if drain and w.alive:
            deadline = time.time() + timeout
            while time.time() < deadline and not self._closed.is_set():
                try:
                    resp = w.rpc({"op": "ping"}, timeout=10)
                except OSError:
                    break  # already dead: nothing left to drain
                if not resp.get("tasks"):
                    drained = True
                    break
                time.sleep(0.1)
        # wait out in-flight replacements before resizing the slot
        # list: a concurrent _replace_worker swaps by index
        self._await_heal_drain(
            None, "[retire] in-flight worker replacement did not "
                  "resolve within 300s; removing the slot anyway\n",
            stop_on_close=True)
        with self._heal_lock:
            try:
                idx = self.workers.index(w)
            except ValueError:
                return False  # concurrently removed (close/retire race)
            del self.workers[idx]
            self.n_workers = len(self.workers)
            n_now = len(self.workers)
        # index-keyed governance state shifted down past the removed
        # slot: forget the tail, the next heartbeat tick repopulates
        for i in range(idx, n_now + 1):
            self.cluster_memory.forget_worker(i)
            self.cluster_metrics.forget(i)
        try:
            w.rpc({"op": "shutdown"}, timeout=5)
        except OSError:
            pass
        w.proc.terminate()
        try:
            w.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            w.proc.kill()
        self._retire_node(w, reason, drained)
        return True

    def _retire_node(self, w: WorkerHandle, reason: str, drained: bool):
        """Record a worker's departure in the ledger (generation bump)
        and fire the membership event — shared by retire_worker and
        the heal path's replacement of a dead worker."""
        if w.node_id is None:
            return
        if self.cluster.record_retire(w.node_id, reason) is None:
            return  # double-retire: already recorded
        self.event_manager.fire_node_retired(NodeRetiredEvent(
            w.node_id, w.proc.pid, self.cluster.generation, reason,
            drained, time.time()))

    def _await_heal_drain(self, slots, note: str,
                          stop_on_close: bool = False):
        """Wait (bounded) until no claimed slot in ``slots`` (None =
        any) remains in ``_healing`` — the one wait loop heal() and
        close() share. The 300 s backstop only trips when a heal
        thread died without running its claim-clearing ``finally``;
        ``note`` is written to stderr then so the hang has a name."""
        with self._heal_done:
            deadline = time.time() + 300

            def pending():
                return self._healing if slots is None \
                    else slots & self._healing

            while pending() and time.time() < deadline:
                if stop_on_close and self._closed.is_set():
                    return
                self._heal_done.wait(timeout=1.0)
            if pending():
                sys.stderr.write(note)

    def _worker_snapshot(self) -> List[WorkerHandle]:
        """Consistent copy of the worker slots for lock-free readers.
        Replacement swaps handles IN PLACE under ``_heal_lock``
        (``_replace_worker``); every reader that iterates the slots
        without the lock copies through here, so it can never observe
        a half-applied swap or race a concurrent ``list`` resize.
        Callers must NOT hold ``_heal_lock`` (plain Lock)."""
        with self._heal_lock:
            return list(self.workers)

    def close(self):
        self._closed.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=10)
        # drain in-flight replacements BEFORE the kill sweep: the spawn
        # runs outside the lock and re-checks _closed to reap its own
        # process, but "closed" has always meant "no worker process
        # survives this call" — returning mid-spawn would orphan the
        # replacement
        self._await_heal_drain(
            None, "[close] in-flight worker replacement did not "
                  "resolve within 300s; a replacement process may be "
                  "orphaned\n")
        with self._heal_lock:
            for w in self.workers:
                try:
                    w.rpc({"op": "shutdown"}, timeout=5)
                except OSError:
                    pass
                w.proc.terminate()
            for w in self.workers:
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
            self.workers = []
        self.service.close()
        self.stream_spool.remove_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- coordinator service (page-sink RPC + replication) ---------------

    def _service_dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "sink_pages":
            # STAGE, don't commit: pages apply to the table only when
            # the query succeeds (_commit_staged), so query/task retry
            # cannot double-write (reference: TableFinishOperator's
            # commit after all writer fragments succeed)
            task = req["task"]
            rows = 0
            with self._stage_lock:
                de = self._sink_streams.setdefault(
                    (task, req["catalog"], req["schema"], req["table"]),
                    PageDeserializer())
                entry = self._staged.setdefault(task, [])
                for frame in req["frames"]:
                    page = de.deserialize(frame)
                    entry.append((req["catalog"], req["schema"],
                                  req["table"], page))
                    rows += page.num_rows
            return {"ok": True, "rows": rows}
        if op == "create_table":
            from ..exec.local_planner import create_table_idempotent

            conn = self.connectors[req["catalog"]]
            create_table_idempotent(conn, req["schema"], req["table"],
                                    req["columns"])
            return {"ok": True}
        if op == "resolve_task":
            # a consumer lost its stream to a producer task: repoint /
            # serve-from-spool / restart (partial-stage retry)
            return {"ok": True,
                    "resolution": self._resolve_lost_producer(
                        req["task_id"], int(req.get("cursor") or 0),
                        tuple(req["failed_addr"]))}
        return {"error": f"unknown coordinator op {op!r}"}

    def _sync_table(self, catalog: str, schema: str, table: str,
                    full: bool = False):
        """Push the coordinator's committed table state to every live
        worker (replicated storage commit). Append-only commits
        (INSERT/CTAS) ship only the pages past each worker's
        replication cursor; rewrites (DELETE) force ``full``."""
        key = (catalog, schema, table)
        conn = self.connectors[catalog]
        handle = conn.metadata().get_table_handle(schema, table)
        if handle is None:  # dropped: propagate the drop
            for w in self._worker_snapshot():
                w.synced.pop(key, None)
                if w.alive:
                    try:
                        w.rpc({"op": "drop_table", "catalog": catalog,
                               "schema": schema, "table": table})
                    except OSError:
                        w.alive = False
            return
        data = conn.tables[(schema, table)]
        with data.lock:
            pages = list(data.pages)
        for w in self._worker_snapshot():
            if not w.alive:
                continue
            self._sync_worker_table(w, catalog, schema, table,
                                    data.columns, pages, full=full)

    def _sync_worker_table(self, w: WorkerHandle, catalog: str,
                           schema: str, table: str, columns, pages,
                           full: bool = False):
        key = (catalog, schema, table)
        start = 0 if full else min(w.synced.get(key, 0), len(pages))
        ser = PageSerializer()  # per-receiver stream
        frames = [ser.serialize(p) for p in pages[start:]]
        try:
            resp = w.rpc({"op": "sync_table", "catalog": catalog,
                          "schema": schema, "table": table,
                          "columns": columns, "start": start,
                          "frames": frames})
            if resp.get("resync"):  # replica diverged: full resend
                ser = PageSerializer()
                resp = w.rpc({
                    "op": "sync_table", "catalog": catalog,
                    "schema": schema, "table": table,
                    "columns": columns, "start": 0,
                    "frames": [ser.serialize(p) for p in pages]})
            if resp.get("ok"):
                w.synced[key] = len(pages)
        except OSError:
            w.alive = False

    def _sync_worker_replicas(self, w: WorkerHandle):
        """Full replica push to one (new) worker: every table of every
        replicated catalog — the re-register half of worker
        replacement."""
        for catalog in sorted(self._replicated):
            conn = self.connectors[catalog]
            for (schema, table), data in list(conn.tables.items()):
                with data.lock:
                    pages = list(data.pages)
                self._sync_worker_table(w, catalog, schema, table,
                                        data.columns, pages, full=True)

    # -- failure detection + self-healing --------------------------------

    def heartbeat(self) -> List[bool]:
        """Ping every worker (reference: HeartbeatFailureDetector.ping);
        marks dead workers so scheduling skips them. Pure probe — use
        ``heal()`` to also replace the dead. Each ping's response
        piggybacks the worker's memory-pool snapshot into the
        ClusterMemoryManager (no extra RPC)."""
        ok = []
        # template-earn deltas ride the heartbeat (round 17): workers
        # whose last-shipped seed version lags the local store get the
        # fresh snapshot piggybacked on their ping, so steady-state
        # workers converge on earned templates without an extra RPC
        tseed = None
        tversion = 0
        if SP.value(self.session, "plan_template_enabled") and \
                SP.value(self.session, "plan_template_seed_enabled"):
            from ..cache import template_seeds

            tversion = template_seeds().version
        for i, w in enumerate(self._worker_snapshot()):
            memory = metrics = None
            req = {"op": "ping"}
            ship = bool(tversion) and \
                getattr(w, "template_seed_version", 0) < tversion
            if ship:
                if tseed is None:
                    from ..cache import template_seeds

                    tseed = template_seeds().export_seed()
                if tseed["shapes"]:
                    req["template_seed"] = tseed
                else:
                    ship = False
            try:
                resp = w.rpc(req, timeout=10)
                alive = bool(resp.get("ok"))
                memory = resp.get("memory")
                metrics = resp.get("metrics")
                if alive and ship:
                    w.template_seed_version = tversion
                if alive and resp.get("sizing"):
                    # exchange-sizing observations travel worker ->
                    # coordinator on the heartbeat; configure ships the
                    # merged seed to every joiner, so presize learning
                    # survives membership churn
                    from .device_exchange import SIZING_HISTORY

                    SIZING_HISTORY.import_seed(resp.get("sizing"))
            except OSError:
                alive = False
            was_alive = w.alive
            w.alive = w.alive and alive and w.proc.poll() is None
            if was_alive and not w.alive:
                w.failure_stats.record()
            with self._heal_lock:
                swapped = i >= len(self.workers) \
                    or self.workers[i] is not w
            if swapped:
                # a heal replaced this slot MID-LOOP: the cluster
                # memory/metrics keyed by i now belong to the live
                # replacement — wiping them here would blind one
                # governance tick for a healthy worker
                ok.append(w.alive)
                continue
            if w.alive:
                self.cluster_memory.update(i, memory)
                self.cluster_metrics.update(i, metrics)
            else:
                self.cluster_memory.forget_worker(i)
                self.cluster_metrics.forget(i)
            ok.append(w.alive)
        return ok

    def heal(self, recovery: Optional[RecoveryStats] = None,
             reason: str = "on-demand") -> List[bool]:
        """Probe all workers and replace the dead ones (spawn + register
        + re-sync replicated tables): the self-healing step that keeps
        cluster capacity from decaying to zero.

        _heal_lock is held only to CLAIM dead slots and to SWAP the
        finished replacement in — never across the spawn/configure/
        re-sync work (seconds to a minute): query-path readers take
        `_worker_snapshot()` on every candidate scan, and a heal that
        held the lock for the whole replacement would stall every
        in-flight query on one dead worker."""
        self.heartbeat()
        if self.worker_replacement:
            with self._heal_lock:
                # claim dead slots so concurrent heals (monitor tick +
                # query-path on-demand) never double-spawn for one slot
                dead = []
                busy = set()
                for i, w in enumerate(self.workers):
                    if w.alive:
                        continue
                    if i in self._healing:
                        busy.add(i)
                    else:
                        dead.append(i)
                self._healing.update(dead)
            try:
                for i in dead:
                    self._replace_worker(i, reason, recovery)
            finally:
                with self._heal_done:
                    self._healing.difference_update(dead)
                    self._heal_done.notify_all()
            # slots a CONCURRENT heal claimed: wait for those
            # replacements to resolve (either way) before reporting —
            # an on-demand heal racing the monitor tick must observe
            # the outcome, not report the slot dead mid-spawn (the old
            # whole-replacement lock gave callers exactly this wait)
            if busy:
                self._await_heal_drain(
                    busy, "[heal] concurrent replacement did not "
                          "resolve within 300s; reporting the slot "
                          "as-is\n", stop_on_close=True)
        return [w.alive for w in self._worker_snapshot()]

    def _replace_worker(self, index: int, reason: str,
                        recovery: Optional[RecoveryStats] = None):
        """Spawn, register and re-sync a replacement for one dead
        worker (caller claimed the slot in ``_healing``). The slow work
        runs OUTSIDE _heal_lock; only the final slot swap takes it.
        Failures leave the slot dead — the next heal retries."""
        with self._heal_lock:
            if self._closed.is_set() or index >= len(self.workers):
                return  # shutting down: don't spawn into a closed cluster
            old = self.workers[index]
        if old.alive:
            return
        new = None
        try:
            new = self._spawn_worker_process(old.generation + 1,
                                             reason="heal", index=index)
            self._sync_worker_replicas(new)
        except Exception as e:
            # swallow deliberately (the next heal tick retries) but
            # keep the taxonomy in the log: a USER-typed failure here
            # is a programming error, not churn
            print(f"[heal] worker replacement failed "
                  f"({classify_exception(e)}): {e!r}", file=sys.stderr)
            traceback.print_exc()
            if new is not None:   # half-registered replacement: reap it
                try:
                    new.proc.kill()
                except OSError:
                    pass
            return
        with self._heal_lock:
            torn_down = self._closed.is_set() \
                or index >= len(self.workers)
            if not torn_down:
                # swap in-place: query threads snapshot self.workers
                # and pick up the replacement on their next scan
                self.workers[index] = new
        if torn_down:
            try:                  # cluster torn down mid-spawn
                new.proc.kill()
            except OSError:
                pass
            return
        try:
            old.proc.kill()
        except OSError:
            pass
        # count once: query-path replacements reach recovery_total via
        # the per-query merge; background ones are credited directly
        if recovery is not None:
            recovery.incr("workers_replaced")
        else:
            self.recovery_total.incr("workers_replaced")
        self.event_manager.fire_worker_replaced(WorkerReplacedEvent(
            index, old.proc.pid, new.proc.pid, reason, time.time()))
        self._retire_node(old, "replaced", drained=False)

    def _monitor_loop(self):
        """Background failure detector + memory governor: the
        configurable-interval heartbeat that makes worker replacement
        and low-memory kills autonomous rather than only
        retry-path-triggered."""
        while not self._closed.wait(self.heartbeat_interval):
            try:
                self.heal(reason="heartbeat")
                self.run_memory_governance()
                self.run_autoscaler()
            except Exception as e:
                # the monitor must survive any tick failure; classify
                # so the log distinguishes infra churn from bugs
                print(f"[monitor] heartbeat tick failed "
                      f"({classify_exception(e)}): {e!r}",
                      file=sys.stderr)
                traceback.print_exc()

    def run_memory_governance(self) -> Optional[str]:
        """One governance tick over the latest heartbeat snapshots:
        enforce query_max_total_memory and — when nodes report blocked
        pools — let the killer policy pick a victim. The victim's
        execution observes the kill as EXCEEDED_CLUSTER_MEMORY
        (INSUFFICIENT_RESOURCES), so its retry re-admits escalated."""
        victim = self.cluster_memory.maybe_kill()
        if victim is not None:
            totals = self.cluster_memory.query_totals()
            self.event_manager.fire_memory_kill(MemoryKillEvent(
                victim, self.cluster_memory.last_kill_source,
                totals.get(victim, 0), time.time()))
        return victim

    def run_autoscaler(self) -> Optional[dict]:
        """One autoscaling tick (monitor-thread driven, also callable
        directly in tests): resource-group queue depth + running count
        and the heartbeat-piggybacked blocked-node count feed the
        deterministic policy; decisions apply through the elastic
        membership API (add_workers / retire_worker)."""
        if not SP.value(self.session, "autoscale_enabled"):
            return None
        if self.resource_groups is not None:
            # `queued` counts only on the acquired group (no ancestor
            # propagation) -> total queue depth is the plain sum;
            # `running` propagates up, so sum the roots only
            queued = sum(r[2] for r in self.resource_groups.stats())
            running = sum(g.running for g in self.resource_groups.roots)
        else:
            queued = 0
            running = len(self.event_manager.running())
        blocked = self.cluster_memory.cluster_stats().get(
            "blocked_nodes", 0)
        with self._heal_lock:
            size = len(self.workers)
        decision = self.autoscaler.tick(
            size=size, queued=queued, running=running,
            min_workers=int(SP.value(self.session,
                                     "autoscale_min_workers")),
            max_workers=int(SP.value(self.session,
                                     "autoscale_max_workers")),
            cooldown_s=float(SP.value(self.session,
                                      "autoscale_cooldown_s")),
            up_queue_depth=int(SP.value(self.session,
                                        "autoscale_up_queue_depth")),
            down_idle_ticks=int(SP.value(self.session,
                                         "autoscale_down_idle_ticks")),
            blocked_nodes=blocked)
        if decision is None:
            return None
        if decision["direction"] == "up":
            self.add_workers(decision["to"] - decision["from"],
                             reason="autoscale-up")
        else:
            self.retire_worker(size - 1, drain=True, timeout=30.0,
                               reason="autoscale-down")
        return decision

    def inject_task_failure(self, task_prefix: str, times: int = 1):
        """Arm failure injection: the next `times` tasks whose id starts
        with task_prefix fail at the worker (reference:
        execution/FailureInjector.java:40). Kept as the one-shot facade
        over the generalized FaultSchedule."""
        self.fault_schedule.add(task_prefix, "error", times)

    @property
    def failure_injections(self) -> Dict[str, int]:
        """Back-compat view: armed (pattern -> remaining) counts."""
        return self.fault_schedule.pending()

    def _fire_retry(self, task_id: str, error_type: str, attempt: int,
                    speculative: bool = False, query_level: bool = False):
        self.event_manager.fire_task_retry(TaskRetryEvent(
            task_id, error_type, attempt, speculative, query_level,
            time.time()))

    def _escalate_memory(self, ctx: _QueryCtx, failed_qid: str):
        """Grow the next attempt's memory budget from the failed
        attempt's OBSERVED peak (heartbeat- or response-reported) and
        halve its concurrent-task width: re-admission under pressure
        must change the resource shape, not just replay."""
        est = self.cluster_memory.estimator
        cur = ctx.session_overrides.get(
            "query_max_memory_bytes",
            SP.value(self.session, "query_max_memory_bytes"))
        floor = SP.value(self.session, "retry_initial_memory")
        new = est.next_budget(failed_qid, int(cur), int(floor))
        if new > cur:
            ctx.session_overrides["query_max_memory_bytes"] = new
        width = ctx.task_width if ctx.task_width is not None \
            else self.n_workers  # qlint: ignore[guarded-by] point-in-time width hint; the halved replan tolerates staleness
        ctx.task_width = max(1, width // 2)
        ctx.recovery.incr("memory_escalations")

    def _session_for(self, ctx: _QueryCtx) -> dict:
        """The session properties shipped with this attempt's tasks:
        the configured session plus the escalation overrides."""
        props = dict(self.session.properties)
        props.update(ctx.session_overrides)
        return props

    def _record_peak(self, task_id: str, resp: dict):
        """Fold a task response's piggybacked pool peak into the
        estimator (covers short-lived pools no heartbeat sampled)."""
        peak = resp.get("memory_peak") if isinstance(resp, dict) else None
        if peak:
            self.cluster_memory.estimator.record_peak(
                task_id.split(".", 1)[0], peak)

    def _backoff_sleep(self, ctx: _QueryCtx, attempt: int):
        """Exponential backoff with deterministic jitter between retry
        attempts, capped by (and charged against) the query deadline."""
        delay = ctx.backoff.delay(attempt)
        rem = ctx.deadline.remaining()
        if rem is not None:
            delay = min(delay, max(0.0, rem))
        time.sleep(delay)
        ctx.recovery.incr("backoff_wall_s", delay)

    # -- statement routing -----------------------------------------------

    def execute(self, sql: str) -> QueryResult:
        """Statement routing wrapped in query lifecycle events
        (reference: DispatchManager + QueryMonitor): created/completed
        events feed the ring-buffer history that backs
        ``system.runtime.queries`` and ``/v1/query/{id}``, with the
        completed event carrying a stats payload (peak memory, recovery
        counters, wall breakdown — the QueryStatistics analog)."""
        stmt = parse_statement(sql)
        monitor = QueryMonitor(self.event_manager, self.session.user,
                               sql)
        monitor.created()
        t0 = time.perf_counter()
        try:
            if self.resource_groups is not None:
                # admission control: block (or reject at max_queued) in
                # the user's resource group — the queue the autoscaler
                # reads (reference: execution/resourcegroups/
                # InternalResourceGroup.run)
                group = self.resource_groups.select(self.session.user)
                with group.run():
                    res = self._route_statement(stmt, sql)
            else:
                res = self._route_statement(stmt, sql)
        except Exception as e:
            monitor.failed(e)
            raise
        monitor.completed(len(res.rows),
                          stats=self._event_stats(res, t0))
        return res

    def _route_statement(self, stmt, sql: str) -> QueryResult:
        if self._touches_system(stmt):
            # system.runtime tables are views over THIS coordinator's
            # live state: any statement reading them — plain SELECT,
            # EXPLAIN ANALYZE, INSERT ... SELECT, CTAS — executes here,
            # never as worker fragments (workers build connectors from
            # catalog_config, which never carries the system catalog;
            # the reference pins system-table splits to the coordinator
            # node). Writes sourced from system tables still replicate.
            from ..runner import LocalQueryRunner

            res = LocalQueryRunner(self.connectors, self.session,
                                   device=self.device).execute(sql)
            if isinstance(stmt, (ast.Insert, ast.CreateTableAsSelect)):
                self._sync_written(stmt)
            else:
                self._sync_after_local(stmt)
            return res
        if isinstance(stmt, ast.Explain) and stmt.analyze and \
                isinstance(stmt.statement, ast.QueryStatement):
            return self._explain_analyze(stmt.statement,
                                         verbose=stmt.verbose)
        if isinstance(stmt, (ast.QueryStatement, ast.Insert,
                             ast.CreateTableAsSelect)):
            res = self._execute_with_retry(stmt)
            if isinstance(stmt, (ast.Insert, ast.CreateTableAsSelect)):
                self._sync_written(stmt)
            return res
        # remaining DDL/DML executes at the coordinator's catalog (the
        # source of truth), then replicates
        from ..runner import LocalQueryRunner

        res = LocalQueryRunner(self.connectors, self.session,
                               device=self.device).execute(sql)
        self._sync_after_local(stmt)
        return res

    def _touches_system(self, stmt) -> bool:
        """Does any table reference of this statement resolve into the
        coordinator-local system catalog? Generic AST walk: table nodes
        can sit under joins, subqueries, and set operations."""
        import dataclasses

        def walk(node) -> bool:
            if isinstance(node, ast.Table):
                resolved = self.metadata.resolve_table(
                    node.name, self.session)
                return resolved is not None and resolved[0] == "system"
            if dataclasses.is_dataclass(node) and \
                    not isinstance(node, type):
                return any(walk(getattr(node, f.name))
                           for f in dataclasses.fields(node))
            if isinstance(node, (tuple, list)):
                return any(walk(x) for x in node)
            return False

        return walk(stmt)

    def _event_stats(self, res: QueryResult, t0: float) -> dict:
        """The QueryCompletedEvent stats payload (reference:
        QueryStatistics): peak memory, recovery counters, and a
        coordinator wall breakdown derived from the trace spans.  A
        wall past ``slow_query_log_threshold`` additionally attaches
        the structured slow-query record (trace critical path + top-3
        cost-attributed operators) that system.runtime.queries
        renders."""
        stats = res.stats or {}
        wall_s = time.perf_counter() - t0
        breakdown: Dict[str, float] = {}
        for s in stats.get("trace") or ():
            if s.get("process") == "coordinator":
                name = s["name"].split(" ")[0]
                breakdown[name] = round(
                    breakdown.get(name, 0.0)
                    + (s["end"] - s["start"]) * 1e3, 2)
        out = {
            "wall_ms": round(wall_s * 1e3, 2),
            "peak_memory_bytes":
                (stats.get("memory") or {}).get("peak_bytes", 0),
            "recovery": stats.get("recovery"),
            "cluster_memory": stats.get("cluster_memory"),
            "wall_breakdown": breakdown or None,
        }
        threshold = SP.value(self.session, "slow_query_log_threshold")
        if threshold and wall_s > threshold:
            from ..telemetry.tracing import slow_query_record

            out["slow_query"] = slow_query_record(
                stats.get("trace"), wall_s * 1e3, threshold,
                worst_misestimate=(stats.get("hbo") or {}).get("worst"))
        return out

    def _explain_analyze(self, stmt,
                         verbose: bool = False) -> QueryResult:
        """Distributed EXPLAIN ANALYZE: run the query through the full
        retry machinery and render wall time + recovery counters
        (exec/stats.QueryStatsTree — the reference's QueryStats
        hierarchy surface).  VERBOSE ships
        ``query_profiling_enabled`` to every task, so worker operator
        spans carry flops / compile-ms and the Trace line splits the
        critical path into compile vs execute; a Kernels line
        summarizes the cluster-wide program registries."""
        from ..telemetry import profiler

        t0 = time.perf_counter()
        with profiler.profiling(verbose):
            res = self._execute_with_retry(
                stmt, extra_props={"query_profiling_enabled": True}
                if verbose else None)
        tree = QueryStatsTree(
            wall_ms=(time.perf_counter() - t0) * 1e3,
            memory=(res.stats or {}).get("memory"),
            cluster_memory=(res.stats or {}).get("cluster_memory"),
            recovery=(res.stats or {}).get("recovery"),
            trace=(res.stats or {}).get("trace"))
        lines = tree.render()
        lines.append(f"Output: {len(res.rows)} rows")
        if verbose:
            snap = self.profile_snapshot()
            tot = snap["totals"]
            lines.append(
                f"Kernels: {tot['programs']} programs over "
                f"{1 + sum(1 for w in self._worker_snapshot() if w.alive)} "
                f"processes, {tot['compiles']} compiles "
                f"(compile {tot['compile_ms']:.1f}ms)")
        return QueryResult(["Query Plan"], [T.VARCHAR],
                           [(line,) for line in lines])

    def profile_snapshot(self) -> dict:
        """Cluster-wide flight-recorder table: the coordinator's
        program registry merged with every live worker's (the
        ``profile`` RPC), each row stamped with its process — the
        BENCH_PROFILE.json body."""
        from ..telemetry import profiler

        kernels = [dict(k, process="coordinator")
                   for k in profiler.snapshot()]
        totals = profiler.totals()
        device_memory = {}
        dm = profiler.device_memory_stats()
        if dm:
            device_memory["coordinator"] = dm
        for i, w in enumerate(self._worker_snapshot()):
            if not w.alive:
                continue
            try:
                resp = w.rpc({"op": "profile"}, timeout=30)
            except Exception:  # qlint: ignore[taxonomy] observability
                continue  # a dead worker must not fail the snapshot
            kernels.extend(dict(k, process=f"worker-{i}")
                           for k in resp.get("kernels") or ())
            wt = resp.get("totals") or {}
            for key in ("programs", "compiles", "calls", "fallbacks"):
                totals[key] = totals.get(key, 0) + wt.get(key, 0)
            for key in ("trace_ms", "compile_ms", "execute_ms",
                        "flops", "bytes_accessed"):
                totals[key] = round(
                    totals.get(key, 0.0) + wt.get(key, 0.0), 3)
            if resp.get("device_memory"):
                device_memory[f"worker-{i}"] = resp["device_memory"]
        return {"kernels": kernels, "totals": totals,
                "device_memory": device_memory}

    def kernel_launches(self, reset: bool = False) -> dict:
        """Every process's kernel launch counters: ``{"coordinator":
        {kernel: n}, "worker-i": {...}}``, each zeroed after the read
        with ``reset``. On CUDA the workers' tasks launch the kernels, so
        a run's launches are the sum over the processes."""
        from ..ops import kernels

        out = {"coordinator": kernels.launch_counts(reset=reset)}
        for i, w in enumerate(self._worker_snapshot()):
            if not w.alive:
                continue
            resp = w.rpc({"op": "kernel_launches", "reset": reset},
                         timeout=30)
            out[f"worker-{i}"] = resp["launches"]
        return out

    def record_kernel_calls(self, directory: Optional[str] = None,
                            kernel: str = "segment_reduce") -> dict:
        """Without ``directory``, every process starts keeping a copy of
        the inputs of each launch of ``kernel``; with it, every process
        stops and writes the calls it kept to ``<directory>/<process>.pt``
        (torch.save, a list of ``(cols, gid, num_segments, kinds,
        order)``, or of ``(key_ops, valid, rounds)`` for
        ``hash_insert``). Returns ``{process: calls kept}``."""
        from ..ops import kernels

        def path(name):
            return None if directory is None \
                else os.path.join(directory, f"{name}.pt")

        kept = kernels.record_calls(directory is None, kernel)
        if directory is not None:
            torch.save(kept, path("coordinator"))
        out = {"coordinator": len(kept)}
        for i, w in enumerate(self._worker_snapshot()):
            if not w.alive:
                continue
            resp = w.rpc({"op": "kernel_calls", "record": directory is None,
                          "path": path(f"worker-{i}"), "kernel": kernel},
                         timeout=120)
            out[f"worker-{i}"] = resp["calls"]
        return out

    def _write_target(self, stmt) -> Optional[Tuple[str, str, str]]:
        name = stmt.table if isinstance(stmt, (ast.Insert, ast.Delete)) \
            else stmt.name
        catalog, _conn, schema, table = self.metadata.resolve_target(
            name, self.session)
        return catalog, schema, table

    def _sync_written(self, stmt):
        catalog, schema, table = self._write_target(stmt)
        if catalog in self._replicated:
            self._sync_table(catalog, schema, table)

    def _sync_after_local(self, stmt):
        if isinstance(stmt, (ast.Delete, ast.CreateTable, ast.DropTable)):
            try:
                catalog, schema, table = self._write_target(stmt)
            except TrinoError:
                return  # e.g. IF EXISTS on a missing table
            if catalog in self._replicated:
                # DELETE rewrites pages in place: replicas must replace
                self._sync_table(catalog, schema, table,
                                 full=isinstance(stmt, ast.Delete))

    # -- query execution -------------------------------------------------

    def _execute_with_retry(self, stmt,
                            extra_props: Optional[dict] = None
                            ) -> QueryResult:
        ctx = _QueryCtx(self.session, f"q{self._task_seq + 1}")
        if extra_props:
            # rides _session_for() into every task request (the same
            # channel the memory-escalation overrides use)
            ctx.session_overrides.update(extra_props)
        if SP.value(self.session, "query_tracing_enabled"):
            ctx.tracer = Tracer(process="coordinator")
        if SP.value(self.session, "hbo_enabled"):
            from ..telemetry.stats_store import HboContext
            from ..telemetry.stats_store import store as _hbo_store

            path = SP.value(self.session, "hbo_store_path")
            if not hasattr(self, "_hbo_loaded"):
                self._hbo_loaded = set()
            if path and path not in self._hbo_loaded:
                _hbo_store().load(path)
                self._hbo_loaded.add(path)
            ctx.hbo = HboContext.for_statement(
                stmt, self.session, self.metadata,
                alpha=SP.value(self.session, "hbo_ewma_alpha"))
        try:
            with ctx.tracer.span(
                    "query", statement=type(stmt).__name__) as root:
                ctx.root_span = root
                res = self._retry_loop(stmt, ctx)
            if ctx.tracer.enabled:
                spans = ctx.tracer.finished()
                res.stats = dict(res.stats or {}, trace=spans)
                endpoint = SP.value(self.session,
                                    "tracing_otlp_endpoint")
                if endpoint:
                    # best-effort OTLP export of the finished tree on a
                    # daemon thread — a dead/slow collector must never
                    # fail OR STALL the query (the 2 s socket timeout
                    # would otherwise ride the completion path)
                    from ..telemetry.tracing import export_otlp

                    threading.Thread(target=export_otlp,
                                     args=(endpoint, list(spans)),
                                     daemon=True).start()
            return res
        finally:
            self.recovery_total.merge(ctx.recovery)

    def _retry_loop(self, stmt, ctx: _QueryCtx) -> QueryResult:
        """Attempt-budgeted retry with taxonomy-driven decisions:
        USER errors raise straight through (deterministic — retrying
        cannot help), everything else consumes the budget with backoff
        (reference: the faulttolerant scheduler's retry policy)."""
        policy = SP.value(self.session, "retry_policy")
        attempts = 1 if policy == "NONE" \
            else SP.value(self.session, "retry_max_attempts")
        last_error: Optional[Exception] = None
        for attempt in range(attempts):
            qid = self._next_qid(attempt)
            try:
                res = self._execute_once(stmt, qid, ctx)
                self._commit_staged(
                    getattr(res, "_query_tasks", []), qid)
                res.stats = dict(res.stats or {})
                res.stats["recovery"] = ctx.recovery.to_dict()
                res.stats["cluster_memory"] = \
                    self.cluster_memory.cluster_stats()
                peak = self.cluster_memory.estimator.peak_for(qid)
                if peak:
                    res.stats["memory"] = dict(
                        res.stats.get("memory") or {}, peak_bytes=peak)
                self._hbo_finish(ctx, res)
                return res
            except _WorkerLost as e:
                self._discard_staged(qid)
                last_error = e
                if attempt == attempts - 1:
                    break
                # self-heal BEFORE deciding whether retry is possible:
                # replacement restores capacity a bare heartbeat cannot
                self.heal(ctx.recovery, reason="on-demand")
                if not any(w.alive for w in self._worker_snapshot()):
                    break
                ctx.recovery.record_retry(e.error_type, query_level=True)
                self._fire_retry(qid, e.error_type, attempt,
                                 query_level=True)
                self._backoff_sleep(ctx, attempt)
            except _RetryableTaskError as e:
                # streaming/NONE have no task-level retry (outputs are
                # not durable); the query re-runs under the attempt
                # budget, then surfaces the underlying error
                self._discard_staged(qid)
                last_error = e
                if attempt == attempts - 1:
                    raise TrinoError(str(e), "GENERIC_INTERNAL_ERROR")
                ctx.recovery.record_retry(e.error_type, query_level=True)
                self._fire_retry(qid, e.error_type, attempt,
                                 query_level=True)
                self._backoff_sleep(ctx, attempt)
            except TrinoError as e:
                self._discard_staged(qid)
                # the taxonomy decides: resource exhaustion is worth a
                # backed-off re-run; USER and internal coordinator
                # errors are deterministic — fail fast
                if classify_error_code(e.code) != INSUFFICIENT_RESOURCES \
                        or attempt == attempts - 1:
                    raise
                last_error = e
                # memory-aware escalation: the next attempt re-admits
                # with a budget grown from the observed peak and a
                # reduced concurrent-task width — not the identical
                # doomed plan (reference: PartitionMemoryEstimator)
                self._escalate_memory(ctx, qid)
                ctx.recovery.record_retry(INSUFFICIENT_RESOURCES,
                                          query_level=True)
                self._fire_retry(qid, INSUFFICIENT_RESOURCES, attempt,
                                 query_level=True)
                self._backoff_sleep(ctx, attempt)
            except BaseException:
                self._discard_staged(qid)
                raise
        raise TrinoError(f"query failed after retry: {last_error}",
                         "GENERIC_INTERNAL_ERROR")

    @staticmethod
    def _hbo_binding(ctx: _QueryCtx):
        """The statement-shape key a worker needs to LOOK UP history
        in its configure-time seed (stmt fingerprint + connector
        snapshot); None when hbo is off or the statement is
        unversionable — the worker then tags without lookups."""
        if ctx.hbo is None:
            return None
        return {"stmt_fp": ctx.hbo.stmt_fp, "snap": ctx.hbo.snap}

    def _collect_local_hbo(self, ctx: _QueryCtx, drivers):
        """Fold the coordinator-run output stage's fingerprint-tagged
        operator stats into the query's actuals (the worker shards
        arrive via task-response piggyback)."""
        if ctx.hbo is None:
            return
        for d in drivers:
            d.collect_operator_metrics()
        actuals = ctx.hbo.collect_actuals(
            [st for d in drivers for st in d.stats])
        if actuals:
            with ctx.hbo_lock:
                ctx.hbo_actuals.append(actuals)

    def _hbo_finish(self, ctx: _QueryCtx, res: QueryResult):
        """Record the WINNING attempt's merged per-node actuals into
        the history store (worker piggybacks + coordinator output
        stage), persist the sidecar when configured, and attach the
        per-query summary to the result stats."""
        if ctx.hbo is None or ctx.hbo_root is None:
            return
        from ..telemetry.stats_store import merge_actuals

        with ctx.hbo_lock:
            merged = merge_actuals(ctx.hbo_actuals)
        if not merged:
            return
        scan_rows = sum(a["rows"] for a in merged
                        if a.get("name") == "TableScanOperator")
        peak = (res.stats.get("memory") or {}).get("peak_bytes", 0) \
            if res.stats else 0
        summary = ctx.hbo.record_actuals(
            ctx.hbo_root, self.metadata, merged,
            peak_bytes=peak, scan_rows=scan_rows)
        if summary:
            res.stats = dict(res.stats or {}, hbo=summary)
            path = SP.value(self.session, "hbo_store_path")
            if path:
                ctx.hbo.store.save(path)

    def _commit_staged(self, query_tasks, qid: str):
        """Apply the successful attempt's staged writes to the
        coordinator catalog, then drop this query's leftovers (failed
        sibling attempts)."""
        with self._stage_lock:
            for _addr, task_id in query_tasks:
                for catalog, schema, table, page in \
                        self._staged.pop(task_id, ()):
                    conn = self.connectors[catalog]
                    data = conn.tables[(schema, table)]
                    page = data.canonicalize(page)
                    with data.lock:
                        data.pages.append(page)
            self._drop_staged_locked(qid)

    def _discard_staged(self, qid: str):
        with self._stage_lock:
            self._drop_staged_locked(qid)

    def _drop_staged_locked(self, qid: str):
        for task_id in [t for t in self._staged if t.startswith(qid)]:
            del self._staged[task_id]
        for key in [k for k in self._sink_streams
                    if k[0].startswith(qid)]:
            del self._sink_streams[key]

    def _next_qid(self, attempt: int) -> str:
        with self._seq_lock:
            self._task_seq += 1
            return f"q{self._task_seq}a{attempt}"

    def _plan(self, stmt, hbo=None, width: Optional[int] = None):
        from .distributed import DistributedQueryRunner

        # reuse the exact planning path of the in-process runner
        planning = DistributedQueryRunner(
            self.connectors, self.session,
            n_workers=width or self.n_workers,  # qlint: ignore[guarded-by] point-in-time planning width; fan-out pins ctx.cluster_width
            desired_splits=self.desired_splits,
            broadcast_threshold=self.broadcast_threshold,
            device=self.device)
        root, fragments = planning.plan_fragments(stmt, hbo=hbo)
        return fragments, root

    def _execute_once(self, stmt, qid: str, ctx: _QueryCtx) -> QueryResult:
        with ctx.tracer.span(f"execute {qid}", parent=ctx.root_span,
                             qid=qid) as attempt_span:
            ctx.attempt_span = attempt_span
            # capture the membership width ONCE per attempt: planning
            # and task fan-out must agree even if an elastic scale-up/
            # down lands mid-query
            ctx.cluster_width = self.n_workers  # qlint: ignore[guarded-by] snapshot by design: see comment above
            with ctx.tracer.span("plan", parent=attempt_span):
                fragments, root = self._plan(stmt, hbo=ctx.hbo,
                                             width=ctx.cluster_width)
            with ctx.hbo_lock:
                # a fresh attempt discards the failed attempt's shards
                ctx.hbo_root = root
                ctx.hbo_actuals = []
            if ctx.hbo is not None:
                # seed the retry estimator from the statement's
                # observed peak: a memory failure on the FIRST attempt
                # of a known shape escalates from history, not hope
                hint = ctx.hbo.statement_hint()
                if hint and hint.get("peak_bytes"):
                    self.cluster_memory.estimator.record_peak(
                        qid, int(hint["peak_bytes"]))
            # TASK retry requires durable stage outputs, i.e. the
            # spooled barrier shape — the reference's fault-tolerant
            # execution also forgoes streaming pipelining under
            # RetryPolicy.TASK
            if SP.value(self.session, "retry_policy") != "TASK" and \
                    SP.value(self.session, "streaming_execution"):
                return self._execute_streaming(qid, fragments, root, ctx)
            return self._execute_barrier(qid, fragments, root, ctx)

    # ----------------------------------------------- streaming mode ----

    def _execute_streaming(self, qid: str, fragments, root,
                           ctx: _QueryCtx) -> QueryResult:
        """All fragments' tasks start immediately; the coordinator runs
        the output stage in-line, pulling from workers while they run."""
        bound = SP.value(self.session, "exchange_max_pending_pages")
        partial = bool(SP.value(self.session, "partial_stage_retry"))
        locations: Dict[int, dict] = {}
        query_tasks: List[Tuple[Tuple, str]] = []
        result_pages: List[Page] = []
        overlap: Dict[str, bool] = {}
        try:
            for frag in fragments:
                live = self._placeable(self._worker_snapshot())
                if not live:
                    raise _WorkerLost("no live workers")
                if frag.output_kind == "output":
                    result_pages = self._run_output_streaming(
                        frag, root, locations, ctx, partial=partial)
                else:
                    locations[frag.fragment_id] = self._start_fragment(
                        qid, frag, live, dict(locations), query_tasks,
                        bound, ctx, partial=partial)
            overlap = self._collect_overlap(query_tasks, ctx)
        finally:
            self._drop_stream_tasks(qid)
            self._release(query_tasks)
            if partial:
                self.stream_spool.delete_prefix(qid)
        rows: List[tuple] = []
        for p in result_pages:
            rows.extend(p.to_rows())
        names = root.column_names
        types_ = [s.type for s in root.outputs]
        res = QueryResult(names, types_, rows,
                          stats={"process_overlap": overlap})
        res._query_tasks = list(query_tasks)  # write-commit set
        return res

    def _start_fragment(self, qid: str, frag: PlanFragment,
                        live: List[WorkerHandle], upstream: dict,
                        query_tasks: List, bound: int,
                        ctx: _QueryCtx, partial: bool = False) -> dict:
        self.cluster_memory.check_killed(qid)
        width = ctx.task_width if ctx.task_width is not None \
            else (ctx.cluster_width or self.n_workers)  # qlint: ignore[guarded-by] fallback only when cluster_width unpinned (unit paths)
        ntasks = 1 if frag.partitioning == "single" else width
        placeable = prefer_healthy(live)
        # topology signal: the workers already holding this stage's
        # exchange inputs (upstream producer locations) — place_task
        # prefers them, degenerating to round-robin without signal
        upstream_addrs = [tuple(a) for loc in upstream.values()
                          for (a, _tid) in loc["locations"]]
        results = []
        # the streaming fragment span covers scheduling (the launch
        # RPCs); the tasks' own run time shows up in the worker task
        # spans collected at query end via task_status
        with ctx.tracer.span(f"fragment f{frag.fragment_id}",
                             parent=ctx.attempt_span,
                             fragment=frag.fragment_id) as frag_span:
            for t in range(ntasks):
                task_id = f"{qid}.f{frag.fragment_id}.t{t}.s"
                self.task_launches.append(task_id)
                ctx.recovery.incr("task_attempts")
                worker = place_task(t, 0, placeable, upstream_addrs)
                launch_span = ctx.tracer.span(
                    f"launch {task_id}", parent=frag_span,
                    task_id=task_id, attempt=0, span_kind="attempt",
                    fragment=frag.fragment_id)
                req = with_trace({
                    "op": "run_task", "task_id": task_id,
                    "fragment": frag, "task_index": t,
                    "task_count": ntasks,
                    "n_partitions": width,
                    "output_kind": frag.output_kind,
                    "upstream": upstream,
                    "desired_splits": self.desired_splits,
                    "session": self._session_for(ctx),
                    "streaming": True, "buffer_bound": bound,
                    "coordinator": self.service.addr,
                    "remote_write_catalogs": sorted(self._replicated),
                    "fault": self.fault_schedule.match(task_id),
                    "hbo": self._hbo_binding(ctx),
                }, launch_span, attempt=0)
                if partial:
                    # durable streams: the worker retains acked frames
                    # for replay, tees output pages into the external
                    # spool, and its consumers resolve lost producers
                    # through the coordinator instead of failing the
                    # query
                    req["durable_streams"] = True
                    req["partial_retry"] = True
                    req["spool_stream"] = {
                        "dir": self.stream_spool.base_dir,
                        "query": qid, "stage": frag.fragment_id,
                        "task": t, "attempt": 0}
                while True:
                    try:
                        # full rpc_request_timeout: the streaming ack is
                        # fast on a healthy worker, and the property must
                        # be able to RAISE the bound on slow hosts, not
                        # only lower it
                        resp = worker.rpc(req, timeout=ctx.timeout())
                        break
                    except OSError:
                        worker.alive = False
                        worker.failure_stats.record()
                        rest = [w for w in self._placeable(
                            self._worker_snapshot()) if w is not worker]
                        if not partial or not rest:
                            launch_span.set("error_type", EXTERNAL)
                            launch_span.finish()
                            raise _WorkerLost(
                                f"worker {worker.addr} unreachable")
                        # partial retry: fail the LAUNCH over to another
                        # worker instead of the whole query; strip the
                        # fault so an injected kill-worker cannot chain
                        # through the entire membership
                        ctx.recovery.record_retry(EXTERNAL)
                        self._fire_retry(task_id, EXTERNAL, 1)
                        req = dict(req)
                        req.pop("fault", None)
                        worker = place_task(t, 1, rest, upstream_addrs)
                launch_span.finish()
                if not resp.get("ok"):
                    ctx.tracer.add_finished(resp.get("spans"))
                    raise self._task_error(resp, task_id)
                results.append((worker.addr, task_id))
                query_tasks.append((worker.addr, task_id))
                if partial:
                    entry_req = dict(req)
                    entry_req.pop("fault", None)
                    with self._stream_lock:
                        self._stream_tasks[task_id] = {
                            "req": entry_req,
                            "addr": tuple(worker.addr),
                            "restarts": 0, "lock": threading.Lock(),
                            "ctx": ctx,
                            "spool": req["spool_stream"],
                            "query_tasks": query_tasks}
        return {"kind": frag.output_kind, "locations": results}

    def _drop_stream_tasks(self, qid: str):
        """Forget a finished query's partial-retry registry entries
        (resolve_task for them then answers None: query is over)."""
        with self._stream_lock:
            for tid in [t for t in self._stream_tasks
                        if t.startswith(qid + ".")]:
                del self._stream_tasks[tid]

    def _resolve_lost_producer(self, task_id: str, cursor: int,
                               failed_addr: Tuple[str, int]
                               ) -> Optional[dict]:
        """Partial-stage retry (the spooled-exchange upgrade): a
        consumer lost its stream to producer ``task_id``. Resolution
        order — (1) a sibling consumer already restarted it elsewhere:
        repoint; (2) its published output survives in the external
        spool: serve those durable bytes; (3) restart JUST that task
        under the same wire id on another worker — never the whole
        query. The consumer resumes from its ack cursor either way
        (deterministic re-execution replays identical frames; the
        spool cursor skips already-consumed pages)."""
        with self._stream_lock:
            entry = self._stream_tasks.get(task_id)
        if entry is None:
            return None  # query already over (or not partial-retry)
        with entry["lock"]:
            if tuple(entry["addr"]) != tuple(failed_addr):
                # another consumer's resolution already landed
                return {"addr": list(entry["addr"])}
            sp = entry["spool"]
            att = committed_attempt(backend_for(sp["dir"]),
                                    sp["query"], sp["stage"],
                                    sp["task"])
            if att is not None:
                # task output outlives its worker: serve the spool
                return {"spool": dict(sp, attempt=att)}
            if entry["restarts"] >= 3 or self._closed.is_set():
                return None
            for w in self._worker_snapshot():
                if tuple(w.addr) == tuple(failed_addr) and w.alive:
                    w.alive = False
                    w.failure_stats.record()
            cands = [w for w in self._placeable(self._worker_snapshot())
                     if tuple(w.addr) != tuple(failed_addr)]
            if not cands:
                return None
            entry["restarts"] += 1
            n = entry["restarts"]
            req = dict(entry["req"])
            req.pop("fault", None)
            ctx = entry["ctx"]
            worker = place_task(int(sp["task"]), n, cands)
            try:
                resp = worker.rpc(req, timeout=ctx.timeout())
            except OSError:
                worker.alive = False
                worker.failure_stats.record()
                return None  # next consumer poll retries the resolve
            if not resp.get("ok"):
                return None
            entry["addr"] = tuple(worker.addr)
            self.task_launches.append(f"{task_id}.r{n}")
            ctx.recovery.record_retry(EXTERNAL)
            self._fire_retry(task_id, EXTERNAL, n)
            entry["query_tasks"].append((worker.addr, task_id))
            return {"addr": list(worker.addr)}

    @staticmethod
    def _classify_remote(err: RemoteTaskError) -> Exception:
        """THE one recovery-decision point for typed remote failures:
        USER errors become the terminal TrinoError (fail fast, naming
        the real remote failure); a transport loss the worker observed
        upstream stays a worker-lost (the retry path must heal, not
        just re-run); query-scoped failures (torn spool) skip the
        pointless task retry; everything else is task-retryable with
        its type."""
        if err.error_type == USER:
            return TrinoError(str(err), err.error_code)
        if err.error_type == INSUFFICIENT_RESOURCES:
            # a memory failure re-fails identically on any worker at
            # the same budget: skip task-level retry and go straight to
            # the query-level memory-aware escalation (grown budget,
            # reduced width)
            return TrinoError(str(err), err.error_code)
        if err.connection_lost:
            return _WorkerLost(str(err), err.error_type)
        return _RetryableTaskError(str(err), err.error_type,
                                   query_only=err.retry_scope == "query")

    @classmethod
    def _task_error(cls, resp: dict, task_id: str) -> Exception:
        return cls._classify_remote(RemoteTaskError.from_response(
            resp, f"task {task_id} failed"))

    def _run_output_streaming(self, frag: PlanFragment, root,
                              locations: Dict[int, dict],
                              ctx: _QueryCtx,
                              partial: bool = False) -> List[Page]:
        from ..exec.driver import Driver
        from ..exec.local_planner import (LocalExecutionPlanner,
                                          grouping_options)
        from ..planner.plan import OutputNode
        from .remote_exchange import (ExchangeConnectionLost,
                                      RemoteExchangeChannel,
                                      run_driver_blocking)

        channels: List[RemoteExchangeChannel] = []
        # partial retry: the coordinator's own output-stage channels
        # resolve lost producers in-process (workers RPC the same
        # resolver through the resolve_task coordinator op)
        recover = self._resolve_lost_producer if partial else None

        def exchange_reader(fragment_id: int, kind: str):
            src = locations[fragment_id]
            if kind == "merge":  # per-producer streams for the merge
                chans = [RemoteExchangeChannel(
                    [loc], 0, consumer_id=0,
                    rpc_timeout=ctx.rpc_timeout, recover=recover)
                    for loc in src["locations"]]
                channels.extend(chans)
                return chans
            chan = RemoteExchangeChannel(src["locations"], 0,
                                         consumer_id=0,
                                         rpc_timeout=ctx.rpc_timeout,
                                         recover=recover)
            channels.append(chan)
            return chan

        planner = LocalExecutionPlanner(
            self.metadata, self.device, self.desired_splits, task_id=0,
            task_count=1,
            exchange_reader=exchange_reader, hbo=ctx.hbo,
            **grouping_options(self.session.properties))
        abort = threading.Event()
        try:
            with ctx.tracer.span(
                    f"fragment f{frag.fragment_id}",
                    parent=ctx.attempt_span,
                    fragment=frag.fragment_id) as frag_span:
                with ctx.tracer.span("plan", parent=frag_span):
                    plan = planner.plan(OutputNode(
                        frag.root, root.column_names, root.outputs))
                with ctx.tracer.span(
                        f"task output f{frag.fragment_id}",
                        parent=frag_span, span_kind="task",
                        fragment=frag.fragment_id,
                        task_id="output") as task_span:
                    drivers = []
                    for p in plan.pipelines:
                        d = Driver(p.operators,
                                   collect_stats=ctx.tracer.enabled
                                   or ctx.hbo is not None)
                        drivers.append(d)
                        run_driver_blocking(d, abort)
                for d in drivers:
                    add_driver_spans(ctx.tracer, d, task_span)
                self._collect_local_hbo(ctx, drivers)
            return plan.sink.pages
        except ExchangeConnectionLost as e:
            raise _WorkerLost(f"output stage pull failed: {e}")
        except RemoteTaskError as e:
            # typed upstream failure: the taxonomy decides — USER fails
            # fast, transport loss retries the query, the rest consume
            # the retry budget
            raise self._classify_remote(e)
        except RuntimeError as e:
            if "[connection-lost]" in str(e):
                raise _WorkerLost(str(e))
            raise _RetryableTaskError(str(e))
        finally:
            for ch in channels:
                ch.close()

    def _collect_overlap(self, query_tasks,
                         ctx: Optional[_QueryCtx] = None
                         ) -> Dict[str, bool]:
        """Per-task streaming witness: did a cross-process consumer
        drain this task's first page before the task finished? When
        tracing, the same poll also collects each task's finished spans
        (streaming tasks outlive their run_task ack, so their spans
        cannot ride the launch response)."""
        want_spans = ctx is not None and ctx.tracer.enabled
        want_hbo = ctx is not None and ctx.hbo is not None
        by_worker: Dict[tuple, List[str]] = {}
        for addr, task_id in query_tasks:
            by_worker.setdefault(tuple(addr), []).append(task_id)
        overlap: Dict[str, bool] = {}
        for addr, ids in by_worker.items():
            req = {"op": "task_status", "task_ids": ids}
            if want_spans:
                req["include_spans"] = True
            # the output stage observes exchange EOF the instant the
            # last page drains, a beat BEFORE the producer thread
            # finishes bookkeeping (finished spans, hbo actuals) and
            # flips its status — poll until every task is terminal
            # (bounded: producers are already done producing), else an
            # early read would record under-counted actuals into the
            # history store
            statuses: Dict[str, dict] = {}
            for _ in range(50):
                try:
                    resp = call(addr, req, timeout=10)
                except OSError:
                    break
                statuses = resp.get("statuses", {})
                if not (want_spans or want_hbo) or all(
                        st.get("status") != "running"
                        for st in statuses.values()):
                    break
                time.sleep(0.02)
            for tid, st in statuses.items():
                overlap[tid] = bool(st.get("overlapped"))
                if want_spans:
                    ctx.tracer.add_finished(st.get("spans"))
                if want_hbo and st.get("hbo") \
                        and st.get("status") == "finished":
                    # streaming tasks outlive their launch ack: their
                    # actuals ride the same end-of-query poll as spans
                    with ctx.hbo_lock:
                        ctx.hbo_actuals.append(st["hbo"])
        return overlap

    # ----------------------------------------------- barrier mode ------

    def _execute_barrier(self, qid: str, fragments, root,
                         ctx: _QueryCtx) -> QueryResult:
        # fragment_id -> {kind, locations: [((host, port), task_id)],
        #                 spool_dir?}
        spool_mgr = None
        if SP.value(self.session, "retry_policy") == "TASK":
            from .spool import FileSystemExchangeManager

            spool_mgr = FileSystemExchangeManager()
        locations: Dict[int, dict] = {}
        query_tasks: List[Tuple[Tuple, str]] = []
        result_pages: List[Page] = []
        try:
            for frag in fragments:
                live = self._placeable(self._worker_snapshot())
                if not live:
                    raise _WorkerLost("no live workers")
                if frag.output_kind == "output":
                    result_pages = self._run_output_fragment(
                        frag, root, locations, ctx)
                else:
                    locations[frag.fragment_id] = self._run_fragment(
                        qid, frag, locations, query_tasks, spool_mgr,
                        ctx)
        finally:
            # release worker buffers on success AND on failed/retried
            # attempts — abandoned attempts must not leak pages
            self._release(query_tasks)
            if spool_mgr is not None:
                spool_mgr.remove_all()
        rows: List[tuple] = []
        for p in result_pages:
            rows.extend(p.to_rows())
        names = root.column_names
        types_ = [s.type for s in root.outputs]
        res = QueryResult(names, types_, rows)
        res._query_tasks = list(query_tasks)  # write-commit set
        return res

    def _run_fragment(self, qid: str, frag: PlanFragment,
                      locations: Dict[int, dict],
                      query_tasks: List, spool_mgr,
                      ctx: _QueryCtx) -> dict:
        """One barrier stage: launch every task, retry failed attempts
        on other workers (taxonomy-gated), speculatively re-dispatch
        stragglers when outputs are durable, enforce the query deadline
        while waiting. The stage runs under a fragment span; every task
        attempt (first launch, retries, speculative re-dispatches) is a
        SIBLING attempt span beneath it, failed ones tagged with their
        fault taxonomy — the tree EXPLAIN ANALYZE's Trace: line and the
        Chrome-trace export render."""
        with ctx.tracer.span(f"fragment f{frag.fragment_id}",
                             parent=ctx.attempt_span,
                             fragment=frag.fragment_id) as frag_span:
            return self._run_fragment_tasks(qid, frag, locations,
                                            query_tasks, spool_mgr, ctx,
                                            frag_span)

    def _run_fragment_tasks(self, qid: str, frag: PlanFragment,
                            locations: Dict[int, dict],
                            query_tasks: List, spool_mgr,
                            ctx: _QueryCtx, frag_span) -> dict:
        width = ctx.task_width if ctx.task_width is not None \
            else (ctx.cluster_width or self.n_workers)  # qlint: ignore[guarded-by] fallback only when cluster_width unpinned (unit paths)
        ntasks = 1 if frag.partitioning == "single" else width
        upstream = {fid: loc for fid, loc in locations.items()}
        spool_dir = None
        if spool_mgr is not None:
            spool_dir = spool_mgr.exchange_dir(qid, frag.fragment_id)
        results: List[Optional[Tuple[Tuple, str]]] = [None] * ntasks
        #: terminal per-task failure: (message, error_type)
        errors: List[Optional[Tuple[str, str]]] = [None] * ntasks
        fatal: List[Exception] = []     # USER/deadline: abort the query
        done = [threading.Event() for _ in range(ntasks)]
        started: Dict[int, float] = {}
        durations: Dict[int, float] = {}
        current_attempt: Dict[int, Tuple[WorkerHandle, str]] = {}
        reg_lock = threading.Lock()
        closed: List[bool] = []   # set once the stage resolved

        def build_req(t: int, attempt_id: str) -> dict:
            return {
                "op": "run_task", "task_id": attempt_id,
                "fragment": frag, "task_index": t,
                "task_count": ntasks,
                "n_partitions": width,
                "output_kind": frag.output_kind,
                "upstream": upstream,
                "desired_splits": self.desired_splits,
                "session": self._session_for(ctx),
                "coordinator": self.service.addr,
                "remote_write_catalogs": sorted(self._replicated),
                "spool_dir": spool_dir,
                "fault": self.fault_schedule.match(attempt_id),
                "hbo": self._hbo_binding(ctx),
            }

        def attempt(t: int, attempt_id: str, worker: WorkerHandle):
            """Run one attempt to completion; first successful attempt
            of a task registers its location (first-publish-wins at the
            spool makes the losing duplicate harmless)."""
            self.task_launches.append(attempt_id)
            ctx.recovery.incr("task_attempts")
            # attempt identity from the id suffix (.rN / .spec): the
            # span is tagged so retries and speculative re-dispatches
            # read as sibling attempts with their taxonomy
            suffix = attempt_id.rsplit(".", 1)[-1]
            speculative = suffix == "spec"
            attempt_no = int(suffix[1:]) if suffix.startswith("r") \
                and suffix[1:].isdigit() else 0
            span = ctx.tracer.span(
                f"attempt {attempt_id}", parent=frag_span,
                task_id=attempt_id, attempt=attempt_no,
                speculative=speculative, span_kind="attempt",
                fragment=frag.fragment_id)
            req = with_trace(build_req(t, attempt_id), span,
                             attempt=attempt_no,
                             speculative=speculative)
            try:
                resp = worker.rpc(req, timeout=ctx.timeout())
            except OSError:
                worker.alive = False
                worker.failure_stats.record()
                span.set("error", f"worker {worker.addr} lost mid-RPC")
                span.set("error_type", EXTERNAL)
                span.finish()
                return "lost-worker", None
            self._record_peak(attempt_id, resp)
            ctx.tracer.add_finished(resp.get("spans"))
            if not resp.get("ok"):
                span.set("error", resp.get("error"))
                span.set("error_type", resp.get("error_type", INTERNAL))
            span.finish()
            if resp.get("ok"):
                with reg_lock:
                    if results[t] is None and not closed:
                        results[t] = (worker.addr, attempt_id)
                        query_tasks.append((worker.addr, attempt_id))
                        durations[t] = time.monotonic() - started[t]
                        done[t].set()
                        if ctx.hbo is not None and resp.get("hbo"):
                            # only the WINNING attempt's actuals count:
                            # a superseded speculative duplicate would
                            # double every node's rows
                            with ctx.hbo_lock:
                                ctx.hbo_actuals.append(resp["hbo"])
                        return "win", None
                # a sibling attempt won (speculation) or the stage
                # already resolved: free this attempt's buffers
                try:
                    call(worker.addr, {"op": "release_task",
                                       "task_id": attempt_id}, timeout=5)
                except OSError:
                    pass
                return "superseded", None
            return "failed", resp

        def run_one(t: int):
            task_id = f"{qid}.f{frag.fragment_id}.t{t}"
            tried: List[WorkerHandle] = []
            started[t] = time.monotonic()
            try:
                for retry in range(self.task_retries + 1):
                    if done[t].is_set() or fatal:
                        return
                    # ONE snapshot for both scans: a heal swap landing
                    # between two live iterations could mix a dead
                    # handle with its replacement in the candidate set
                    pool = self._placeable(self._worker_snapshot())
                    candidates = [w for w in pool
                                  if w not in tried] or pool
                    if not candidates:
                        errors[t] = ("no live workers", EXTERNAL)
                        return
                    # flapping workers (decayed failure score) shed
                    # load: place on the healthy subset when one exists
                    candidates = prefer_healthy(candidates)
                    worker = candidates[(t + retry) % len(candidates)]
                    tried.append(worker)
                    attempt_id = f"{task_id}.r{retry}"
                    current_attempt[t] = (worker, attempt_id)
                    if retry > 0:
                        _msg, etype = errors[t] or ("", EXTERNAL)
                        ctx.recovery.record_retry(etype)
                        self._fire_retry(attempt_id, etype, retry)
                        self._backoff_sleep(ctx, retry - 1)
                    # the straggler clock measures THIS attempt: failed
                    # attempts + backoff must not make a fresh retry
                    # look speculation-worthy the moment it launches
                    started[t] = time.monotonic()
                    status, resp = attempt(t, attempt_id, worker)
                    if status in ("win", "superseded"):
                        return
                    if status == "lost-worker":
                        if spool_dir is not None and \
                                self._spool_published(spool_dir, frag,
                                                      t, width):
                            # kill-after-publish: the task's spool
                            # output already outlives the dead worker —
                            # adopt it instead of relaunching; the
                            # consumers read the spool, release on the
                            # dead address is best-effort
                            with reg_lock:
                                if results[t] is None and not closed:
                                    results[t] = (worker.addr,
                                                  attempt_id)
                                    query_tasks.append(
                                        (worker.addr, attempt_id))
                                    durations[t] = time.monotonic() \
                                        - started[t]
                                    done[t].set()
                                    return
                        errors[t] = (f"worker {worker.addr} lost",
                                     EXTERNAL)
                        continue
                    err = self._task_error(resp, attempt_id)
                    if isinstance(err, (TrinoError, _WorkerLost)) or \
                            getattr(err, "query_only", False):
                        # USER: abort now; worker-lost / query-scoped
                        # (torn spool): another worker hits the same
                        # wall — only heal + query retry can recover
                        fatal.append(err)
                        return
                    errors[t] = (str(err), err.error_type)
                # exhausted retries
            except TrinoError as e:   # deadline expired mid-attempt
                fatal.append(e)
            except BaseException as e:
                errors[t] = (repr(e), classify_exception(e))
            finally:
                done[t].set()

        threads = [threading.Thread(target=run_one, args=(t,),
                                    daemon=True)
                   for t in range(ntasks)]
        for th in threads:
            th.start()
        self._supervise(ntasks, done, durations, started,
                        current_attempt, fatal, qid, frag, spool_dir,
                        attempt, ctx)
        with reg_lock:
            closed.append(True)
        if fatal:
            raise fatal[0]
        for t in range(ntasks):
            if results[t] is None:
                msg, etype = errors[t] or ("task lost", EXTERNAL)
                if "no live workers" not in msg \
                        and all(w.alive for w in self._worker_snapshot()):
                    raise _RetryableTaskError(
                        f"task {t} of fragment {frag.fragment_id} "
                        f"failed: {msg}", etype)
                raise _WorkerLost(msg, etype)
        loc = {"kind": frag.output_kind,
               "locations": [results[t] for t in range(ntasks)]}
        if spool_dir is not None:
            loc["spool_dir"] = spool_dir
        return loc

    @staticmethod
    def _spool_published(spool_dir: str, frag: PlanFragment, t: int,
                         width: int) -> bool:
        """Did task ``t`` fully publish its spool output before its
        worker died? ExchangeSink publishes each partition file by an
        atomic link at finish, so existence of EVERY partition file is
        the commit witness (a kill mid-publish leaves some missing and
        the normal retry path runs instead)."""
        nparts = 1 if frag.output_kind in ("single", "broadcast",
                                           "merge") else width
        return all(os.path.exists(os.path.join(
            spool_dir, f"p{p}.t{t}.bin")) for p in range(nparts))

    def _supervise(self, ntasks, done, durations, started,
                   current_attempt, fatal, qid, frag, spool_dir,
                   attempt, ctx: _QueryCtx):
        """Wait for the stage while (a) enforcing the query deadline and
        (b) speculatively re-dispatching stragglers: when a task has run
        far past the median of its completed siblings and outputs are
        durable (spool), a second attempt launches on another worker —
        first publish wins (reference: the faulttolerant scheduler's
        speculative task execution)."""
        speculated = set()
        speculate = (spool_dir is not None and ctx.spec_enabled
                     and ntasks > 1)

        def spec_run(t: int, worker: WorkerHandle):
            attempt_id = f"{qid}.f{frag.fragment_id}.t{t}.spec"
            try:
                status, _resp = attempt(t, attempt_id, worker)
            except BaseException:  # qlint: ignore[taxonomy] speculative loser: discarded by design
                return  # a failed speculation never hurts the original
            if status == "win":
                ctx.recovery.incr("speculative_wins")
                # the straggling original is now pointless: abort it so
                # it cannot publish into a torn-down query
                orig = current_attempt.get(t)
                if orig is not None:
                    try:
                        call(orig[0].addr, {"op": "abort_task",
                                            "task_id": orig[1]},
                             timeout=5)
                    except OSError:
                        pass

        while not all(ev.is_set() for ev in done):
            try:
                ctx.deadline.check()
                # a low-memory kill lands here: the supervised stage
                # aborts with EXCEEDED_CLUSTER_MEMORY and the retry
                # loop re-admits with an escalated budget
                self.cluster_memory.check_killed(qid)
            except TrinoError as e:
                fatal.append(e)
                # the victim's in-flight attempts must actually STOP:
                # streaming tasks abort between frames, and barrier
                # tasks observe the flag at their next page-move
                # quantum (run_barrier_driver) — without the broadcast
                # a killed query's tasks kept computing with their
                # reservations pinned until they finished on their own
                for t in range(ntasks):
                    cur = current_attempt.get(t)
                    if cur is None or done[t].is_set():
                        continue
                    try:
                        call(cur[0].addr, {"op": "abort_task",
                                           "task_id": cur[1]},
                             timeout=5)
                    except OSError:
                        pass
                # unblock run_one threads waiting on nothing; attempts
                # in flight resolve as superseded once `closed` is set
                for ev in done:
                    ev.set()
                return
            if speculate and len(durations) >= max(1, ntasks // 2):
                median = statistics.median(durations.values())
                threshold = max(ctx.spec_min_s,
                                ctx.spec_multiplier * median)
                now = time.monotonic()
                for t in range(ntasks):
                    if done[t].is_set() or t in speculated \
                            or t not in started \
                            or now - started[t] <= threshold:
                        continue
                    straggler = current_attempt.get(t)
                    others = [w for w in self._worker_snapshot() if w.alive and
                              (straggler is None or w is not straggler[0])]
                    if not others:
                        continue
                    speculated.add(t)
                    ctx.recovery.incr("speculative_launched")
                    self._fire_retry(
                        f"{qid}.f{frag.fragment_id}.t{t}.spec",
                        EXTERNAL, 0, speculative=True)
                    threading.Thread(
                        target=spec_run, args=(t, others[t % len(others)]),
                        daemon=True).start()
            time.sleep(0.02)

    def _run_output_fragment(self, frag: PlanFragment, root,
                             locations: Dict[int, dict],
                             ctx: _QueryCtx) -> List[Page]:
        """The root (single) fragment runs in the coordinator, pulling
        from workers — the reference's coordinator-only output stage."""
        from ..exec.local_planner import (LocalExecutionPlanner,
                                          grouping_options)
        from ..planner.plan import OutputNode
        from .spool import SpoolCorruption

        def on_retry(exc):
            ctx.recovery.record_retry(EXTERNAL)

        # spool cursors hold an open fd across polls: track them so a
        # failed execution closes them deterministically instead of
        # waiting for the plan object's GC
        spool_cursors: List = []

        def exchange_reader(fragment_id: int, kind: str):
            src = locations[fragment_id]
            part = 0  # output stage is task 0 of 1
            if kind == "merge":
                if src.get("spool_dir"):
                    from .spool import spool_task_cursor

                    cursors = [spool_task_cursor(src["spool_dir"], 0, i)
                               for i in range(len(src["locations"]))]
                    spool_cursors.extend(cursors)
                    return cursors

                def task_thunk(loc):
                    def thunk():
                        return fetch_pages(tuple(loc[0]), loc[1], 0,
                                           timeout=ctx.timeout(),
                                           on_retry=on_retry)

                    return thunk

                return [task_thunk(loc) for loc in src["locations"]]
            if src.get("spool_dir"):
                from .spool import spool_channel

                # frame-per-page cursor stream over the durable output
                chan = spool_channel(src["spool_dir"], part)
                spool_cursors.append(chan)
                return chan

            def thunk():
                pages: List[Page] = []
                for addr, up_task in src["locations"]:
                    pages.extend(fetch_pages(tuple(addr), up_task, part,
                                             timeout=ctx.timeout(),
                                             on_retry=on_retry))
                return pages

            return thunk

        planner = LocalExecutionPlanner(
            self.metadata, self.device, self.desired_splits, task_id=0,
            task_count=1,
            exchange_reader=exchange_reader, hbo=ctx.hbo,
            **grouping_options(self.session.properties))
        try:
            with ctx.tracer.span(
                    f"fragment f{frag.fragment_id}",
                    parent=ctx.attempt_span,
                    fragment=frag.fragment_id) as frag_span:
                with ctx.tracer.span("plan", parent=frag_span):
                    plan = planner.plan(OutputNode(
                        frag.root, root.column_names, root.outputs))
                with ctx.tracer.span(
                        f"task output f{frag.fragment_id}",
                        parent=frag_span, span_kind="task",
                        fragment=frag.fragment_id,
                        task_id="output") as task_span:
                    pages = plan.execute(
                        collect_stats=ctx.tracer.enabled
                        or ctx.hbo is not None)
                for d in getattr(plan, "drivers", ()):
                    add_driver_spans(ctx.tracer, d, task_span)
                self._collect_local_hbo(ctx,
                                        getattr(plan, "drivers", ()))
            return pages
        except RemoteTaskError as e:
            # the taxonomy decides (round-6 satellite: a deterministic
            # execution error must NOT masquerade as a lost worker and
            # trigger a pointless full-query retry)
            raise self._classify_remote(e)
        except SpoolCorruption as e:
            # a task retry would re-read the same torn bytes; only a
            # fresh query attempt (new spool) can recover
            raise _RetryableTaskError(str(e), EXTERNAL, query_only=True)
        except OSError as e:
            # transport-only: the producing worker or its buffers are
            # gone (FileNotFoundError covers an unpublished spool)
            raise _WorkerLost(f"output stage pull failed: {e}")
        finally:
            for cur in spool_cursors:
                cur.close()

    def _release(self, query_tasks):
        """Free worker-side task buffers once results are drained
        (reference: DELETE /v1/task/{id}); aborting also unwinds any
        still-parked producer."""
        for addr, task_id in query_tasks:
            try:
                call(addr, {"op": "release_task", "task_id": task_id},
                     timeout=10)
            except OSError:
                pass

    # -- observability surface -------------------------------------------

    def metrics_families(self) -> list:
        """The cluster metrics view: coordinator-process families
        (recovery, cluster memory, query/worker state, jit/exchange
        counters) merged with the latest heartbeat-piggybacked worker
        snapshots — what GET /v1/metrics renders and
        ``system.runtime.metrics`` serves as rows."""
        from ..telemetry.metrics import MetricsRegistry, process_families

        reg = MetricsRegistry()
        rec = self.recovery_total.to_dict()
        c = reg.counter("trino_recovery_events_total",
                        "Self-healing counters by kind (task_attempts, "
                        "retries, worker replacements, speculation, "
                        "memory escalations)")
        for kind in ("task_attempts", "task_retries", "query_retries",
                     "workers_replaced", "speculative_launched",
                     "speculative_wins", "memory_escalations"):
            c.inc(rec.get(kind, 0), kind=kind)
        cm = self.cluster_memory.cluster_stats()
        g = reg.gauge("trino_cluster_memory_bytes",
                      "Cluster-wide memory pool state (kind=reserved|"
                      "max)")
        g.set(cm.get("total_reserved_bytes", 0), kind="reserved")
        g.set(cm.get("total_max_bytes", 0), kind="max")
        reg.gauge("trino_cluster_blocked_nodes",
                  "Workers reporting blocked memory pools").set(
            cm.get("blocked_nodes", 0))
        reg.counter("trino_memory_kills_total",
                    "Queries killed by the low-memory killer / cluster "
                    "cap").inc(cm.get("kills", 0))
        states: Dict[str, int] = {}
        for e in self.event_manager.history(10_000):
            states[e.state] = states.get(e.state, 0) + 1
        qc = reg.counter("trino_queries_total",
                         "Completed queries by terminal state")
        for state_name in ("FINISHED", "FAILED"):
            qc.inc(states.get(state_name, 0), state=state_name)
        reg.gauge("trino_queries_running",
                  "Queries currently executing").set(
            len(self.event_manager.running()))
        reg.gauge("trino_workers_alive",
                  "Live worker processes").set(
            sum(1 for w in self._worker_snapshot() if w.alive))
        slots = self._worker_snapshot()
        reg.gauge("trino_cluster_size",
                  "Worker slots in the membership (elastic: changes "
                  "with add_workers/retire_worker)").set(len(slots))
        joined, retired = self.cluster.counts()
        nt = reg.counter("trino_nodes_total",
                         "Membership churn events by kind")
        nt.inc(joined, event="joined")
        nt.inc(retired, event="retired")
        snap = self.autoscaler.snapshot()
        ad = reg.counter("trino_autoscaler_decisions_total",
                         "Autoscaler decisions by direction")
        ad.inc(snap["scale_ups"], direction="up")
        ad.inc(snap["scale_downs"], direction="down")
        reg.gauge("trino_autoscaler_target_workers",
                  "Most recent autoscaler target size").set(
            snap["target"] if snap["target"] is not None
            else len(slots))
        return self.cluster_metrics.collect(process_families()
                                            + reg.collect())

    def runtime_tasks(self) -> list:
        """Rows for ``system.runtime.tasks``: every task currently
        tracked by a live worker (running AND finished-but-unreleased),
        one poll per worker."""
        rows = []
        for i, w in enumerate(self._worker_snapshot()):
            if not w.alive:
                continue
            try:
                resp = w.rpc({"op": "task_status", "task_ids": None},
                             timeout=10)
            except OSError:
                continue
            for tid, st in sorted(resp.get("statuses", {}).items()):
                rows.append((tid, tid.split(".", 1)[0], f"worker-{i}",
                             (st.get("status") or "?").upper(),
                             st.get("rows"), st.get("error_type")))
        return rows

    def runtime_nodes(self) -> list:
        """Rows for ``system.runtime.nodes``: the membership ledger —
        every node that ever joined this cluster, its lifecycle state
        and the cluster generation at which it joined."""
        return [(n.node_id, f"{n.address[0]}:{n.address[1]}",
                 n.state.upper(), n.pid, n.generation,
                 n.reason or None, n.retired_reason or None)
                for n in self.cluster.snapshot()]


class _WorkerLost(Exception):
    """A worker died or its buffers are gone: retry the whole query
    (reference: RetryPolicy.QUERY — stage outputs were lost, task-level
    retry cannot recover them)."""

    def __init__(self, message: str, error_type: str = EXTERNAL):
        super().__init__(message)
        self.error_type = error_type


class _RetryableTaskError(Exception):
    """A task failed with a retryable (non-USER) error where task-level
    retry cannot replay it in place: re-run the query under the attempt
    budget (the spooled exchange upgrades this to retry-from-spool).
    ``query_only`` marks failures a task retry can NEVER fix (torn
    spool: another worker re-reads the same bytes)."""

    def __init__(self, message: str, error_type: str = INTERNAL,
                 query_only: bool = False):
        super().__init__(message)
        self.error_type = error_type
        self.query_only = query_only
