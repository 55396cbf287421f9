"""HTTP client protocol: POST /v1/statement + nextUri paging.

Reference analog: ``dispatcher/QueuedStatementResource.java:154-219``
(query submission, queued nextUri hops) and ``server/protocol/
ExecutingStatementResource.java:73,160`` (result paging), serving the
same JSON document shape ``client/trino-client/.../StatementClientV1``
polls: ``{id, columns, data, nextUri, stats, error}``.

Implementation: stdlib ThreadingHTTPServer over any engine runner
(LocalQueryRunner / DistributedQueryRunner / ProcessQueryRunner — they
share the execute() surface).  Queries run on a small executor;
results page out ``page_size`` rows per GET with token-sequenced
nextUris; abandoned queries (no poll within ``query_ttl``) are evicted
on a background timer so disconnected clients cannot pin materialized
results (and ``_QueryState`` stays bounded under sustained load).

Admission batching: when the runner supports
``execute_batch`` and ``admission_batching_enabled`` is on, submitted
query statements enter a backlog keyed by their normalized shape
(``cache.QueryCache.parse``); an executor drain pops one head plus
every same-(shape, user) statement queued behind it — a burst of
repeat dashboard statements rides ONE resource-group admission slot,
identical texts coalesce to a single execution, and any divergent
shape falls back to its own drain (serial, byte-equal).  The tenant
arrives via the ``X-Trino-User`` header (reference: the dispatcher's
session context resolution).

The JAX engine's ``trino_tpu/server/protocol.py``, copied; it serves the
torch engine's ``LocalQueryRunner``.
"""

from __future__ import annotations

import datetime
import json
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from decimal import Decimal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .. import types as T

EPOCH = datetime.date(1970, 1, 1)


def _json_value(v, type_: T.Type):
    if v is None:
        return None
    if isinstance(v, Decimal):
        return str(v)
    if type_ == T.DATE and isinstance(v, int):
        return (EPOCH + datetime.timedelta(days=v)).isoformat()
    if isinstance(v, datetime.datetime):  # timestamp with time zone
        return v.isoformat()
    return v


class _QueryState:
    def __init__(self, qid: str, sql: str = "",
                 user: Optional[str] = None):
        import time

        self.id = qid
        self.sql = sql
        self.user = user
        self.shape = None         # normalized-AST shape (batch grouping)
        self.state = "QUEUED"
        self.error: Optional[dict] = None
        self.result = None
        self.created = time.time()
        self.last_poll = self.created


class ProtocolServer:
    """The coordinator's client-facing HTTP surface.

    Endpoints beyond the statement protocol (reference:
    ``server/QueryResource.java`` + the metrics exposition):
    - ``GET /v1/query/{id}``: the query's stats tree
      (``QueryStatsTree.to_dict()`` — memory, recovery, cluster memory,
      trace spans) for running and finished queries; finished ones are
      retained in a bounded history, 404 once evicted;
    - ``GET /v1/metrics``: Prometheus text exposition of the runner's
      metric families (cluster-aggregated for the process runner) plus
      this server's own query counters.
    """

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0,
                 page_size: int = 1000, query_ttl: float = 3600.0,
                 history_size: int = 100,
                 evict_interval: Optional[float] = None):
        import collections

        from ..telemetry.metrics import MetricsRegistry

        self.runner = runner
        self.page_size = page_size
        self.query_ttl = query_ttl
        #: abandoned-query sweep cadence: a TIMER, not per-submit — at
        #: high QPS an O(n) scan per submission is overhead, and with
        #: no traffic at all an abandoned _QueryState must still evict
        #: (deterministic bounded memory under sustained load)
        self.evict_interval = evict_interval if evict_interval \
            is not None else max(1.0, min(query_ttl / 4, 30.0))
        self._stop_evictor = threading.Event()
        self.queries: Dict[str, _QueryState] = {}
        #: admission-batching backlog: submitted statements waiting for
        #: an executor worker; a drain pops one head and takes every
        #: same-(shape, user) statement queued behind it, up to
        #: admission_batch_max, into ONE resource-group slot
        self._backlog = collections.deque()
        self._backlog_lock = threading.Lock()
        #: finished-query info retained for GET /v1/query/{id}
        #: (bounded ring: oldest evicted first -> 404); the lock keeps
        #: concurrent executor threads from double-popping the same
        #: oldest key at capacity
        self.finished: "Dict[str, dict]" = {}
        self._finished_lock = threading.Lock()
        self.history_size = history_size
        self.registry = MetricsRegistry()
        # progress-capable runner? (LocalQueryRunner.execute takes a
        # telemetry.progress tracker; other runners are served state-
        # only live stats)
        import inspect

        try:
            self._progress_capable = "progress" in inspect.signature(
                runner.execute).parameters
        except (TypeError, ValueError):
            self._progress_capable = False
        self._http_queries = self.registry.counter(
            "trino_http_statements_total",
            "Statements submitted over /v1/statement, by outcome")
        self._batches = self.registry.counter(
            "trino_http_admission_batches_total",
            "Admission batches drained by size bucket "
            "(size=1 means no burst was waiting)")
        self.registry.gauge_fn(
            "trino_http_query_states",
            "Live _QueryState entries (submitted, not yet delivered "
            "or evicted) — bounded under sustained load",
            lambda: len(self.queries))
        self.executor = ThreadPoolExecutor(max_workers=4)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, doc: dict):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, code: int, text: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/v1/statement":
                    self._reply(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(n).decode()
                # reference: X-Trino-User identifies the tenant for
                # resource-group routing + admission batching
                user = self.headers.get("X-Trino-User")
                self._reply(200, outer.submit(sql, user=user))

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                # /v1/statement/executing/{id}/{token}
                if len(parts) == 5 and parts[:3] == \
                        ["v1", "statement", "executing"]:
                    self._reply(200, outer.poll(parts[3], int(parts[4])))
                elif self.path == "/v1/info":
                    self._reply(200, {"nodeVersion":
                                      {"version": "trino-tpu-torch-0.3"},
                                      "coordinator": True,
                                      "starting": False})
                elif self.path == "/v1/status":
                    self._reply(200, {"nodeId": "coordinator",
                                      "state": "ACTIVE"})
                elif self.path == "/v1/metrics":
                    self._reply_text(200, outer.metrics_text())
                elif len(parts) == 3 and parts[:2] == ["v1", "query"]:
                    info = outer.query_info(parts[2])
                    if info is None:
                        self._reply(404, {"error":
                                          f"unknown query {parts[2]}"})
                    else:
                        self._reply(200, info)
                else:
                    self._reply(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if len(parts) >= 4 and parts[:3] == \
                        ["v1", "statement", "executing"]:
                    outer.cancel(parts[3])
                    # 204: no body allowed on a keep-alive connection
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                else:
                    self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.addr = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    @property
    def uri(self) -> str:
        return f"http://{self.addr[0]}:{self.addr[1]}"

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        threading.Thread(target=self._evict_loop, daemon=True).start()
        return self

    def stop(self):
        self._stop_evictor.set()
        if self._thread is not None:   # shutdown() hangs if never served
            self.httpd.shutdown()
        self.httpd.server_close()
        self.executor.shutdown(wait=False)

    # ------------------------------------------------------------------

    def _evict_loop(self):
        """Background sweep: eviction must happen on a CLOCK, not only
        when fresh traffic arrives — a burst of abandoned clients
        followed by silence must still drain to zero _QueryStates."""
        while not self._stop_evictor.wait(self.evict_interval):
            self._evict_abandoned()

    def _evict_abandoned(self):
        """Drop finished queries no client polled within query_ttl —
        abandoned clients must not pin materialized results forever.
        Non-terminal states get a 10x grace: a client's poll can stall
        behind a long compile, and reaping a RUNNING query under load
        would fail healthy waiters (the timer sweep made that a real
        hazard the old traffic-driven sweep only hid)."""
        import time

        now = time.time()
        for qid, q in list(self.queries.items()):
            idle = now - q.last_poll
            if idle > self.query_ttl and \
                    (q.state in ("FINISHED", "FAILED")
                     or idle > 10 * self.query_ttl):
                self.queries.pop(qid, None)

    def _batching_enabled(self) -> bool:
        from .. import session_properties as SP

        session = getattr(self.runner, "session", None)
        return session is not None \
            and hasattr(self.runner, "execute_batch") \
            and SP.value(session, "admission_batching_enabled")

    def submit(self, sql: str, user: Optional[str] = None) -> dict:
        from ..telemetry import progress as progress_mod

        qid = uuid.uuid4().hex[:16]
        q = _QueryState(qid, sql, user=user)
        self.queries[qid] = q
        if self._progress_capable:
            progress_mod.register(qid)
        if self._batching_enabled():
            # shape analysis is the memoized parse the execution reuses
            # — a burst of repeat texts pays it once, ever
            try:
                pq = self.runner.query_cache.parse(sql,
                                                   self.runner.session)
                if pq.is_query:
                    q.shape = pq.shape
            except Exception:
                q.shape = None  # unparseable: fails on the solo path
        if q.shape is not None:
            with self._backlog_lock:
                self._backlog.append(q)
            self.executor.submit(self._drain_batch)
        else:
            self.executor.submit(self._run_single, q)
        return {
            "id": qid,
            "nextUri": f"{self.uri}/v1/statement/executing/{qid}/0",
            "stats": {"state": q.state},
        }

    def _run_single(self, q: _QueryState):
        import time

        from ..telemetry import progress as progress_mod

        q.state = "RUNNING"
        t0 = time.perf_counter()
        prog = progress_mod.get(q.id) if self._progress_capable \
            else None
        try:
            # per-tenant admission routing needs the user-aware execute
            # (LocalQueryRunner); other runners keep their session user
            if q.user is not None and hasattr(self.runner,
                                              "execute_batch"):
                q.result = self.runner.execute(q.sql, user=q.user,
                                               progress=prog)
            elif prog is not None:
                q.result = self.runner.execute(q.sql, progress=prog)
            else:
                q.result = self.runner.execute(q.sql)
            q.state = "FINISHED"
            self._http_queries.inc(state="FINISHED")
        except Exception as e:
            self._fail(q, e)
        self._record_finished(q, (time.perf_counter() - t0) * 1e3)

    def _fail(self, q: _QueryState, e: Exception):
        q.error = {
            "message": str(e),
            "errorCode": getattr(e, "code", "GENERIC_INTERNAL_ERROR"),
            "errorType": type(e).__name__,
        }
        q.state = "FAILED"
        self._http_queries.inc(state="FAILED")

    def _take_batch(self) -> List[_QueryState]:
        """Pop the backlog head plus every same-(shape, user) statement
        queued behind it, up to admission_batch_max; statements whose
        shape diverges stay queued in order for their own drain (each
        submission scheduled one)."""
        from .. import session_properties as SP

        limit = SP.value(self.runner.session, "admission_batch_max")
        with self._backlog_lock:
            if not self._backlog:
                return []
            head = self._backlog.popleft()
            batch = [head]
            rest = []
            while self._backlog and len(batch) < limit:
                cand = self._backlog.popleft()
                if cand.shape == head.shape and cand.user == head.user:
                    batch.append(cand)
                else:
                    rest.append(cand)
            self._backlog.extendleft(reversed(rest))
            return batch

    def _drain_batch(self):
        import time

        batch = self._take_batch()
        if not batch:
            return  # a sibling drain absorbed this submission's work
        self._batches.inc(size=min(len(batch), 16))
        for q in batch:
            q.state = "RUNNING"
        t0 = time.perf_counter()
        try:
            results = self.runner.execute_batch(
                [q.sql for q in batch], user=batch[0].user)
        except Exception as e:
            # admission-level failure (queue full, rejected budget):
            # fails the whole burst — each statement reports it
            results = [e] * len(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        for q, res in zip(batch, results):
            if isinstance(res, Exception):
                self._fail(q, res)
            else:
                q.result = res
                q.state = "FINISHED"
                self._http_queries.inc(state="FINISHED")
            self._record_finished(q, wall_ms)

    def _record_finished(self, q: _QueryState, wall_ms: float):
        """Retain the finished query's stats tree for GET /v1/query/{id}
        (reference: QueryResource over the QueryTracker history). The
        ring is bounded: the oldest entry evicts, after which the id
        404s."""
        from ..exec.stats import QueryStatsTree

        stats = (q.result.stats if q.result is not None
                 and q.result.stats else {}) or {}
        tree = QueryStatsTree(
            wall_ms=wall_ms,
            memory=stats.get("memory"),
            cluster_memory=stats.get("cluster_memory"),
            recovery=stats.get("recovery"),
            trace=stats.get("trace"))
        info = {
            "queryId": q.id, "state": q.state, "query": q.sql,
            "rows": len(q.result.rows) if q.result is not None else 0,
            "error": q.error,
            "stats": tree.to_dict(),
        }
        with self._finished_lock:
            while len(self.finished) >= self.history_size:
                self.finished.pop(next(iter(self.finished)))
            self.finished[q.id] = info
        from ..telemetry import progress as progress_mod

        progress_mod.unregister(q.id)

    def query_info(self, qid: str) -> Optional[dict]:
        """GET /v1/query/{id}: full stats-tree JSON for a finished (or
        failed) query; for a QUEUED/RUNNING query, LIVE partial stats —
        state, elapsed wall, and (when the runner feeds a progress
        tracker) the rows-based completion estimate with queued/running
        task counts — instead of the old stats:null placeholder.  None
        (404) for unknown/evicted ids."""
        import time

        from ..telemetry import progress as progress_mod

        with self._finished_lock:
            done = self.finished.get(qid)
        if done is not None:
            return done
        q = self.queries.get(qid)
        if q is None:
            return None
        stats = {"state": q.state,
                 "elapsed_ms": round((time.time() - q.created) * 1e3, 1)}
        prog = progress_mod.get(qid)
        if prog is not None:
            stats["progress"] = prog.to_dict()
        return {"queryId": qid, "state": q.state, "query": q.sql,
                "error": q.error, "stats": stats}

    def evict_query(self, qid: str):
        """Drop a finished query from the /v1/query history (tests +
        admin surface); subsequent lookups 404."""
        with self._finished_lock:
            self.finished.pop(qid, None)

    def metrics_text(self) -> str:
        """GET /v1/metrics: Prometheus text exposition of the runner's
        families + this server's statement counters."""
        from ..telemetry.metrics import (merge_families,
                                         render_prometheus)

        fams = getattr(self.runner, "metrics_families", None)
        runner_fams = fams() if callable(fams) else []
        return render_prometheus(
            merge_families(runner_fams, self.registry.collect()))

    def poll(self, qid: str, token: int) -> dict:
        q = self.queries.get(qid)
        if q is None:
            return {"error": {"message": f"unknown query {qid}",
                              "errorCode": "NOT_FOUND"}}
        import time

        q.last_poll = time.time()
        doc: dict = {"id": qid, "stats": {"state": q.state}}
        if q.state in ("QUEUED", "RUNNING"):
            doc["nextUri"] = \
                f"{self.uri}/v1/statement/executing/{qid}/{token}"
            return doc
        if q.state == "FAILED":
            doc["error"] = q.error
            return doc
        res = q.result
        doc["columns"] = [{"name": n, "type": str(t)}
                          for n, t in zip(res.column_names, res.types)]
        start = token * self.page_size
        chunk = res.rows[start:start + self.page_size]
        doc["data"] = [[_json_value(v, t)
                        for v, t in zip(row, res.types)]
                       for row in chunk]
        if start + self.page_size < len(res.rows):
            doc["nextUri"] = \
                f"{self.uri}/v1/statement/executing/{qid}/{token + 1}"
        else:
            if res.stats:
                doc["stats"]["memory"] = res.stats.get("memory")
                # cluster memory governance + self-healing counters ride
                # the final page's stats (reference: QueryStats served
                # on /v1/query/{id} — here folded into the statement
                # protocol's stats block)
                if "cluster_memory" in res.stats:
                    doc["stats"]["clusterMemory"] = \
                        res.stats["cluster_memory"]
                if "recovery" in res.stats:
                    doc["stats"]["recovery"] = res.stats["recovery"]
                if "dynamic_filters" in res.stats:
                    doc["stats"]["dynamicFilters"] = \
                        res.stats["dynamic_filters"]
            self.queries.pop(qid, None)  # final page delivered
        return doc

    def cancel(self, qid: str):
        self.queries.pop(qid, None)
