"""Spooled (external) exchange: durable stage outputs for task retry.

Reference analog: the exchange SPI ``spi/exchange/ExchangeManager.java:
42-75`` (createExchange / sink / source instance handles) and its
filesystem implementation ``plugin/trino-exchange-filesystem/.../
FileSystemExchangeManager.java`` — the substrate of fault-tolerant
execution (RetryPolicy.TASK): a stage writes its partitioned output to
durable storage, so a downstream task failure (or the producing worker
dying) replays from the spool instead of re-running the producer stage.

The JAX engine's ``trino_tpu/parallel/spool.py``, copied. The spooled
payload is the engine's wire serde frames
(exec/serde.py) — the same dtype-tagged columnar buffers the streaming
exchange ships, so spooling adds no extra encode step beyond framing.
Layout: ``{base}/{exchange_id}/p{partition}.t{task}.bin`` — one file per
(producing task, partition), length-prefixed frames, fsync'd before the
task reports success (write-then-rename for atomicity).
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
from typing import List, Optional

from ..exec.serde import PageDeserializer, PageSerializer


class ExchangeSink:
    """One producing task's durable writer (reference:
    spi/exchange/ExchangeSink.java): add pages per partition, finish()
    atomically publishes every partition file."""

    def __init__(self, directory: str, task: int, n_partitions: int):
        self.directory = directory
        self.task = task
        self._sers = [PageSerializer() for _ in range(n_partitions)]
        self._tmp: List[Optional[object]] = []
        os.makedirs(directory, exist_ok=True)
        for p in range(n_partitions):
            f = tempfile.NamedTemporaryFile(
                dir=directory, prefix=f".p{p}.t{task}.", delete=False)
            self._tmp.append(f)

    def add(self, partition: int, page):
        frame = self._sers[partition].serialize(page)
        f = self._tmp[partition]
        f.write(struct.pack("<I", len(frame)))
        f.write(frame)

    def finish(self):
        """Publish atomically, first-publish-wins: fsync, then link the
        temp file under the final name — a half-written spool must never
        be readable, and when two attempts of the same task race (a
        speculative re-dispatch plus its straggling original), the first
        published output stays and the duplicate is discarded, so
        consumers can never observe a file swap mid-read."""
        for p, f in enumerate(self._tmp):
            f.flush()
            os.fsync(f.fileno())
            f.close()
            target = os.path.join(self.directory,
                                  f"p{p}.t{self.task}.bin")
            try:
                os.link(f.name, target)  # atomic, fails if published
            except FileExistsError:
                pass  # a sibling attempt won the publish race
            os.unlink(f.name)

    def abort(self):
        for f in self._tmp:
            try:
                f.close()
                os.unlink(f.name)
            except OSError:
                pass


class _ImmediateToken:
    """Listen token for file-backed streams: the state is always
    'changed' (a published spool never blocks), so the callback fires
    immediately — keeps cursors honest members of the poll/at_end/
    listen channel contract without inventing fake waits."""

    __slots__ = ()

    def on_ready(self, cb):
        cb()


_IMMEDIATE = _ImmediateToken()


class SpoolCursor:
    """Frame-per-page reader over ONE producing task's published spool
    file with an explicit page-range cursor — the poll/at_end/listen
    streaming channel contract over durable bytes, so consumers stream
    a spooled stage output page-at-a-time instead of materializing the
    whole file (the ack-cursor shape of the streaming exchange applied
    to the spool; reference: ExchangeSource.read()'s incremental
    slices).

    ``start_page`` replays from mid-stream: earlier frames are still
    DECODED (the serde stream's dictionary-pool deltas are positional)
    but not yielded — the page-range cursor a partially-consumed
    consumer retry resumes from."""

    def __init__(self, path: str, start_page: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(f"spool file missing: {path}")
        self.path = path
        self.start_page = start_page
        self._f = None
        self._de = PageDeserializer()  # one serde stream per task file
        self._index = 0       # frames decoded so far
        self._ended = False
        self._closed = False
        #: serializes poll() (driver thread) against close() (task
        #: abort runs the channels teardown from the RPC handler
        #: thread) — without it a racing close could null the file
        #: mid-read or a late poll could reopen at offset 0 against
        #: the already-advanced serde stream
        self._lock = threading.Lock()

    def _next_frame(self):
        if self._closed:
            self._ended = True
            return None
        if self._f is None:
            self._f = open(self.path, "rb")
        head = self._f.read(4)
        if not head:
            self._f.close()
            self._f = None
            self._ended = True
            return None
        if len(head) < 4:
            raise SpoolCorruption(
                f"torn frame header in {self.path}")
        (n,) = struct.unpack("<I", head)
        blob = self._f.read(n)
        if len(blob) < n:
            # a published file must hold complete frames; a short
            # read means on-disk corruption (e.g. torn by a crashed
            # host) — losing rows silently is never acceptable
            raise SpoolCorruption(
                f"torn frame in {self.path}: expected {n} bytes, "
                f"read {len(blob)}")
        return blob

    # -- streaming channel contract --------------------------------------

    def poll(self):
        with self._lock:
            while not self._ended:
                blob = self._next_frame()
                if blob is None:
                    return None
                page = self._de.deserialize(blob)
                self._index += 1
                if self._index > self.start_page:
                    return page
            return None

    def at_end(self) -> bool:
        return self._ended

    def has_page(self) -> bool:
        return not self._ended

    def listen(self):
        return _IMMEDIATE

    def close(self):
        with self._lock:
            self._closed = True
            self._ended = True
            if self._f is not None:
                self._f.close()
                self._f = None


class _ChainedSpoolCursor:
    """One partition's producing-task files as a single page stream:
    cursors chain in sorted task order, each with its own serde stream
    (the per-task-file framing contract)."""

    def __init__(self, paths: List[str]):
        self._paths = list(paths)
        self._cur: Optional[SpoolCursor] = None
        self._closed = False
        # same poll-vs-abort-close serialization as SpoolCursor (and
        # it also guards a racing poll from opening a NEW cursor after
        # close already tore the chain down)
        self._lock = threading.Lock()

    def poll(self):
        with self._lock:
            while True:
                if self._closed:
                    return None
                if self._cur is None:
                    if not self._paths:
                        return None
                    self._cur = SpoolCursor(self._paths.pop(0))
                page = self._cur.poll()
                if page is not None:
                    return page
                # a SpoolCursor poll returns None only at end of its
                # file (durable bytes never block): advance the chain
                self._cur.close()
                self._cur = None

    def at_end(self) -> bool:
        return self._cur is None and not self._paths

    def has_page(self) -> bool:
        return not self.at_end()

    def listen(self):
        return _IMMEDIATE

    def close(self):
        with self._lock:
            self._closed = True
            if self._cur is not None:
                self._cur.close()
                self._cur = None
            self._paths = []


class SpoolCorruption(RuntimeError):
    """A published spool file is torn/corrupt. Classified EXTERNAL (the
    durable store failed the engine): retryable, but a task retry will
    re-read the same bytes — recovery needs the QUERY-level retry that
    rebuilds the exchange under a fresh attempt id."""


def spool_task_cursor(directory: str, partition: int, task: int,
                      start_page: int = 0) -> SpoolCursor:
    """Streaming cursor over one producing task's pages for one
    partition (the merge exchange consumes per-task cursors to
    preserve sort runs). A missing file means the producer never
    PUBLISHED — raise and let retry policy decide."""
    return SpoolCursor(
        os.path.join(directory, f"p{partition}.t{task}.bin"),
        start_page=start_page)


def spool_channel(directory: str, partition: int) -> _ChainedSpoolCursor:
    """Exchange source channel: all producing tasks' pages for one
    partition, streamed frame-per-page (reference:
    spi/exchange/ExchangeSource.java)."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"spool directory missing: {directory}")
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith(f"p{partition}.t")
                   and n.endswith(".bin"))
    return _ChainedSpoolCursor([os.path.join(directory, n)
                                for n in names])


def read_spool(directory: str, partition: int) -> List:
    """Materializing exchange source: all producing tasks' pages for
    one partition (the whole-list convenience over spool_channel)."""
    chan = spool_channel(directory, partition)
    pages: List = []
    try:
        while True:
            page = chan.poll()
            if page is None:
                break
            pages.append(page)
    finally:
        chan.close()
    return pages


class FileSystemExchangeManager:
    """Creates/locates spooled exchanges under one base directory
    (reference: FileSystemExchangeManager — base URI + per-exchange
    subdirectories). The coordinator owns the lifecycle: one exchange
    per (query, fragment), removed when the query releases."""

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir or tempfile.mkdtemp(
            prefix="trino_tpu_torch_spool_")

    def exchange_dir(self, query_id: str, fragment_id: int) -> str:
        return os.path.join(self.base_dir, f"{query_id}.f{fragment_id}")

    def create_sink(self, query_id: str, fragment_id: int, task: int,
                    n_partitions: int) -> ExchangeSink:
        return ExchangeSink(self.exchange_dir(query_id, fragment_id),
                            task, n_partitions)

    def remove_exchange(self, query_id: str, fragment_id: int):
        import shutil

        shutil.rmtree(self.exchange_dir(query_id, fragment_id),
                      ignore_errors=True)

    def remove_all(self):
        import shutil

        shutil.rmtree(self.base_dir, ignore_errors=True)
