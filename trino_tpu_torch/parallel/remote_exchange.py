"""Streaming cross-process exchange client + remote page sink.

Reference analog: ``operator/DirectExchangeClient.java:55`` — the
consumer-side client that concurrently long-polls every upstream task's
output buffer, acknowledges what it received so the producer can free
it, and exposes a non-blocking page stream to the ExchangeOperator. Here
the transport is the framed-RPC ``get_page_stream`` op (worker.py) and
the hand-off to the driver is the same poll/at_end/listen channel
contract the in-process streaming exchange uses (ops/output.py), so the
local planner cannot tell a remote stage boundary from a local one.

Backpressure is end-to-end: the producer's OutputBuffer is bounded (its
driver parks when full), this client drains it over the wire into a
bounded local queue, and the consuming driver parks on the channel's
listen token while the queue is empty.

A copy of the JAX engine's ``trino_tpu/parallel/remote_exchange.py``:
channels hand host ``Page``s to the exchange source operator, which
uploads each to the task's device.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..exec.serde import PageDeserializer, PageSerializer


class ExchangeConnectionLost(RuntimeError):
    """An upstream worker died or its task buffers vanished: the stream
    cannot be completed. Tagged so the coordinator can classify the
    failure as retry-the-query rather than a user error (reference:
    RetryPolicy.QUERY on DirectExchange failures).

    NOT raised for a merely-torn connection: the ack-based cursor
    protocol (worker ``get_page_stream`` + ``_RetainedStream``) lets
    the channel reconnect and replay the unacked frame range in place,
    so only a peer that stays unreachable (dead worker) or reports its
    buffers gone escalates to query retry."""


class _ChannelToken:
    __slots__ = ("_chan", "_version")

    def __init__(self, chan: "RemoteExchangeChannel", version: int):
        self._chan = chan
        self._version = version

    def on_ready(self, cb):
        with self._chan._lock:
            if self._chan._version == self._version:
                self._chan._listeners.append(cb)
                return
        cb()


class RemoteExchangeChannel:
    """One consumer's streaming view of an upstream fragment spread over
    remote tasks. A background fetcher round-robins the upstream tasks
    with short long-polls, deserializing into a bounded local queue."""

    #: reconnect budget per torn connection run: a worker that stays
    #: unreachable this many times in a row is declared lost
    RECONNECT_ATTEMPTS = 4

    def __init__(self, locations: List[Tuple[tuple, str]], partition: int,
                 consumer_id: int = 0, max_local: int = 16,
                 poll_wait: float = 0.5, rpc_timeout: float = 60.0,
                 recover=None):
        self.partition = partition
        self.consumer_id = consumer_id
        self.max_local = max_local
        self.poll_wait = poll_wait
        self.rpc_timeout = rpc_timeout
        #: partial-stage retry hook: ``recover(task_id, cursor,
        #: failed_addr) -> resolution dict | None``. When set, a lost
        #: producer is resolved in place (repoint to its replacement or
        #: adopt its durable spool output) before the channel escalates
        #: to ExchangeConnectionLost.
        self.recover = recover
        self.recoveries = 0
        self._lock = threading.Lock()
        self._queue: List = []
        self._version = 0
        self._listeners: List = []
        self._ended = False
        self._error: Optional[BaseException] = None
        self._stop = False
        self._drained = threading.Event()
        self._pending = [(tuple(addr), task_id)
                         for addr, task_id in locations]
        self._des: Dict[str, PageDeserializer] = {
            task_id: PageDeserializer() for _, task_id in self._pending}
        #: per-task frame cursor: complete frames deserialized so far —
        #: doubles as the ack shipped with every pull, and as the replay
        #: point after a reconnect
        self._cursors: Dict[str, int] = {
            task_id: 0 for _, task_id in self._pending}
        self._fail_counts: Dict[str, int] = {}
        #: per-task reconnect-backoff deadline (monotonic): a failing
        #: peer is SKIPPED in the round-robin until its deadline
        #: passes, so its backoff never stalls pulls from healthy
        #: upstream tasks
        self._retry_at: Dict[str, float] = {}
        # streaming observability (read via .stats)
        self.reconnects = 0
        self.replayed_frames = 0
        self.pages_received = 0
        self.rows_received = 0
        self._created = time.monotonic()
        self.first_page_ts: Optional[float] = None
        self._thread = threading.Thread(target=self._fetch_loop,
                                        daemon=True)
        self._thread.start()

    # -- fetcher ---------------------------------------------------------

    def _pull_once(self, addr, task_id: str):
        """One cursor-addressed pull. The request acks everything the
        deserializer consumed (the producer may free it) and asks for
        frames from that same index."""
        from .rpc import recv_frame, recv_msg, send_msg
        import socket

        cursor = self._cursors[task_id]
        # connect phase capped well below rpc_timeout: one blackholed
        # peer (SYN dropped, not refused) must not stall the shared
        # round-robin fetch loop for a full rpc_timeout per attempt —
        # escalation to ExchangeConnectionLost stays prompt and healthy
        # upstreams keep flowing. Established sockets get the full
        # timeout for the long-poll reads.
        with socket.create_connection(
                addr, timeout=min(self.rpc_timeout, 5.0)) as sock:
            sock.settimeout(self.rpc_timeout)
            send_msg(sock, {
                "op": "get_page_stream",
                "task_id": task_id,
                "partition": self.partition,
                "consumer_id": self.consumer_id,
                "wait": self.poll_wait,
                "cursor": cursor, "ack": cursor})
            head = recv_msg(sock)
            frames = [recv_frame(sock)
                      for _ in range(head.get("n_pages", 0))]
        return head, frames

    def _fetch_loop(self):
        try:
            while not self._stop and self._pending:
                progressed = False
                attempted = False
                for addr, task_id in list(self._pending):
                    if self._stop:
                        return
                    if time.monotonic() < self._retry_at.get(
                            task_id, 0.0):
                        continue   # backing off; healthy peers first
                    # local backpressure: don't outrun the consumer
                    while not self._stop and self._qsize() >= self.max_local:
                        self._drained.clear()
                        if self._qsize() >= self.max_local:
                            self._drained.wait(0.2)
                    if self._stop:
                        return
                    attempted = True
                    try:
                        head, frames = self._pull_once(addr, task_id)
                    except OSError as e:
                        # torn connection (incl. mid-frame): the cursor
                        # protocol makes the pull idempotent — reconnect
                        # and replay the unacked range instead of
                        # failing the query. Only a peer that stays
                        # unreachable escalates.
                        fails = self._fail_counts.get(task_id, 0) + 1
                        self._fail_counts[task_id] = fails
                        self.reconnects += 1
                        if fails > self.RECONNECT_ATTEMPTS:
                            if self._try_recover(addr, task_id):
                                progressed = True
                                break  # pending mutated: re-snapshot
                            raise ExchangeConnectionLost(
                                f"pull from {addr} task {task_id} "
                                f"failed {fails} times: {e!r}")
                        # deadline, not a sleep: sleeping here would
                        # stall the shared fetch loop for every other
                        # (healthy) upstream task
                        self._retry_at[task_id] = time.monotonic() + \
                            min(0.05 * (2 ** (fails - 1)), 1.0)
                        continue
                    self._fail_counts.pop(task_id, None)
                    self._retry_at.pop(task_id, None)
                    if head.get("error"):
                        msg = head["error"]
                        if head.get("connection_lost") or \
                                "[connection-lost]" in msg:
                            if self._try_recover(addr, task_id):
                                progressed = True
                                break  # pending mutated: re-snapshot
                            raise ExchangeConnectionLost(msg)
                        from .fault import RemoteTaskError

                        # typed upstream failure: carry the error type +
                        # remote traceback so the coordinator fails fast
                        # on USER errors instead of retrying the query
                        raise RemoteTaskError.from_response(
                            head, f"upstream task {task_id} failed")
                    if frames:
                        cursor = self._cursors[task_id]
                        start = int(head.get("start", cursor))
                        if start > cursor:
                            if self._try_recover(addr, task_id):
                                progressed = True
                                break  # pending mutated: re-snapshot
                            raise ExchangeConnectionLost(
                                f"stream hole from task {task_id}: "
                                f"have {cursor}, got start={start}")
                        # drop any prefix the deserializer already
                        # consumed; the producer also reports how many
                        # of these frames are re-sends of a torn reply
                        frames = frames[cursor - start:]
                        self.replayed_frames += int(
                            head.get("replayed", 0))
                    if frames:
                        de = self._des[task_id]
                        pages = [de.deserialize(f) for f in frames]
                        self._cursors[task_id] += len(frames)
                        self.pages_received += len(pages)
                        self.rows_received += sum(p.num_rows
                                                  for p in pages)
                        if self.first_page_ts is None:
                            self.first_page_ts = time.monotonic()
                        with self._lock:
                            self._queue.extend(pages)
                            fired = self._bump_locked()
                        for cb in fired:
                            cb()
                        progressed = True
                    if head.get("done"):
                        self._pending.remove((addr, task_id))
                        progressed = True
                if not progressed and not self._pending:
                    break
                if not attempted and self._pending:
                    # every pending task is backing off: wait for the
                    # earliest deadline instead of busy-spinning
                    now = time.monotonic()
                    wait = min(self._retry_at.get(t, now) - now
                               for _, t in self._pending)
                    if wait > 0:
                        time.sleep(min(wait, 1.0))
            with self._lock:
                self._ended = True
                fired = self._bump_locked()
            for cb in fired:
                cb()
        except BaseException as e:  # qlint: ignore[taxonomy] parked with type intact, re-raised in pages()
            # not a swallow: the error parks on the channel (with its
            # original type intact) and re-raises in the consumer's
            # pages() pull
            with self._lock:
                self._error = e
                self._ended = True
                fired = self._bump_locked()
            for cb in fired:
                cb()

    def _try_recover(self, addr, task_id: str) -> bool:
        """Resolve a lost producer in place via the coordinator-backed
        ``recover`` callback (fetch-loop thread only — ``_pending`` /
        ``_cursors`` are fetcher-private). Two resolutions succeed:

        - a replacement task address: repoint the pending entry and
          replay from our ack cursor — the producer re-executes
          deterministically, so its fresh serializer reproduces frames
          ``0..cursor-1`` byte-identically and the prefix-drop seam
          skips them;
        - the task's committed spool object: decode it from page 0
          (serde dictionary deltas are positional) and adopt only the
          pages past the cursor."""
        if self.recover is None:
            return False
        cursor = self._cursors.get(task_id, 0)
        try:
            resolution = self.recover(task_id, cursor, addr)
        except Exception:  # qlint: ignore[taxonomy] best-effort: declining here makes the caller raise ExchangeConnectionLost, which IS classified
            return False
        if not resolution:
            return False
        entry = (tuple(addr), task_id)
        if resolution.get("addr"):
            try:
                idx = self._pending.index(entry)
            except ValueError:
                return False
            self._pending[idx] = (tuple(resolution["addr"]), task_id)
            self._fail_counts.pop(task_id, None)
            self._retry_at[task_id] = time.monotonic() + 0.05
            self.reconnects += 1
            self.recoveries += 1
            return True
        sp = resolution.get("spool")
        if not sp:
            return False
        from .spool_backend import (BackendSpoolCursor, backend_for,
                                    partition_key)

        cur = BackendSpoolCursor(
            backend_for(sp["dir"]),
            partition_key(sp["query"], sp["stage"], sp["task"],
                          sp["attempt"], self.partition),
            start_page=cursor)
        try:
            pages = cur.pages()
        finally:
            cur.close()
        if entry in self._pending:
            self._pending.remove(entry)
        self._cursors[task_id] = cursor + len(pages)
        self._fail_counts.pop(task_id, None)
        self._retry_at.pop(task_id, None)
        self.recoveries += 1
        self.pages_received += len(pages)
        self.rows_received += sum(p.num_rows for p in pages)
        if pages and self.first_page_ts is None:
            self.first_page_ts = time.monotonic()
        with self._lock:
            self._queue.extend(pages)
            fired = self._bump_locked()
        for cb in fired:
            cb()
        return True

    def _qsize(self) -> int:
        with self._lock:
            return len(self._queue)

    def _bump_locked(self):
        self._version += 1
        fired = list(self._listeners)
        self._listeners.clear()
        return fired

    # -- channel contract (ops/output.ExchangeChannel) -------------------

    def poll(self):
        with self._lock:
            if self._queue:
                page = self._queue.pop(0)
                self._drained.set()
                return page
            if self._error is not None:
                raise self._error
        return None

    def at_end(self) -> bool:
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._ended and not self._queue

    def has_page(self) -> bool:
        with self._lock:
            return bool(self._queue) or self._error is not None

    def listen(self):
        with self._lock:
            return _ChannelToken(self, self._version)

    def close(self):
        self._stop = True
        self._drained.set()
        self._thread.join(timeout=5)

    @property
    def stats(self) -> dict:
        """Streaming-pull observability, surfaced through
        ExchangeSourceOperator.metrics into operator stats/spans: how
        much flowed, and whether the ack/replay machinery engaged."""
        out = {"kind": "stream",
               "rows": self.rows_received,
               "pages": self.pages_received}
        if self.first_page_ts is not None:
            # pipelining witness: how soon after the channel opened the
            # first upstream page landed (a barrier would pay the whole
            # producer wall here)
            out["first_page_ms"] = round(
                (self.first_page_ts - self._created) * 1e3, 1)
        if self.reconnects:
            out["reconnects"] = self.reconnects
            out["replayed_frames"] = self.replayed_frames
        if self.recoveries:
            out["recoveries"] = self.recoveries
        return out


class RemotePageSink:
    """Worker-side write sink that ships written pages to the
    coordinator's catalog over RPC (reference: the page-sink half of
    ``operator/TableWriterOperator.java`` against a remote metastore —
    the memory catalog's single source of truth lives with the
    coordinator, which then replicates to workers)."""

    def __init__(self, coordinator: tuple, catalog: str, schema: str,
                 table: str, task_id: str = "", batch_pages: int = 8):
        self.coordinator = tuple(coordinator)
        self.catalog, self.schema, self.table = catalog, schema, table
        #: the writing task attempt: the coordinator STAGES pages under
        #: it and commits only the successful attempt's stage when the
        #: query completes — retries cannot double-write
        self.task_id = task_id
        self.batch_pages = batch_pages
        self._ser = PageSerializer()
        self._frames: List[bytes] = []
        self.rows = 0

    def append_page(self, page):
        self._frames.append(self._ser.serialize(page))
        self.rows += page.num_rows
        if len(self._frames) >= self.batch_pages:
            self._flush()

    def _flush(self):
        from .rpc import call

        if not self._frames:
            return
        resp = call(self.coordinator, {
            "op": "sink_pages", "catalog": self.catalog,
            "schema": self.schema, "table": self.table,
            "task": self.task_id, "frames": self._frames})
        if not resp.get("ok"):
            from .fault import INTERNAL, RemoteTaskError

            raise RemoteTaskError(f"coordinator sink rejected pages: "
                                  f"{resp.get('error')}", INTERNAL,
                                  "PAGE_TRANSPORT_ERROR")
        self._frames = []

    def finish(self) -> dict:
        self._flush()
        return {"rows": self.rows}


def wait_tokens(tokens, timeout: float = 0.25):
    """Block the calling thread until any listen token fires (or the
    timeout passes) — the thread-world adapter for the cooperative
    Blocked protocol the in-process TaskExecutor uses."""
    ev = threading.Event()
    for t in tokens:
        t.on_ready(ev.set)
    ev.wait(timeout)


def run_barrier_driver(driver, abort: threading.Event,
                       max_quanta: int = 1_000_000):
    """Barrier (non-streaming) twin of ``run_driver_blocking``: observe
    the task's abort flag at every page-move quantum.  Before this seam
    a barrier task ran its whole fragment with ``run_to_completion`` —
    the coordinator's low-memory killer could pick the query as victim
    but the worker-side task kept computing (and kept its reservations
    pinned) until it finished on its own; now the kill lands at the
    next page boundary."""
    from .fault import INTERNAL, RemoteTaskError

    for _ in range(max_quanta):
        if abort.is_set():
            raise RemoteTaskError("task aborted", INTERNAL)
        if driver.process():
            return
    raise RemoteTaskError(
        f"driver did not finish within {max_quanta} quanta "
        "(stuck pipeline?)", INTERNAL)


def run_driver_blocking(driver, abort: threading.Event,
                        max_idle_s: float = 600.0):
    """Drive one pipeline to completion in a dedicated thread, parking
    on listen tokens after no-progress quanta (the process-world twin of
    DistributedQueryRunner._task_gen's streaming loop)."""
    from .fault import INTERNAL, RemoteTaskError

    idle_since = None
    while True:
        if abort.is_set():
            raise RemoteTaskError("task aborted", INTERNAL)
        if driver.process():
            return
        if driver.last_moved:
            idle_since = None
            continue
        toks = driver.blocked_tokens()
        if toks:
            wait_tokens(toks, timeout=0.25)
            idle_since = None
        else:
            # runnable but idle quantum (e.g. operator waiting on an
            # internal condition): spin gently, bounded
            now = time.monotonic()
            if idle_since is None:
                idle_since = now
            elif now - idle_since > max_idle_s:
                raise RemoteTaskError("driver made no progress for "
                                      f"{max_idle_s}s (stuck "
                                      f"pipeline?)", INTERNAL)
            time.sleep(0.002)
