"""Spool backend: object-store-shaped durable storage for stage output.

Reference analog: the exchange SPI's storage half —
``plugin/trino-exchange-filesystem/.../FileSystemExchangeStorage.java``
(createFile / listFiles / deleteRecursively against S3/GCS/ABFS or a
local directory). The engine-facing spool machinery (spool.py) talks to
THIS abstraction instead of the filesystem directly, so a task's
published output outlives its worker process and the storage substrate
can be swapped without touching the exchange code.

Object model: immutable blobs of serde frames keyed by
``{query}/f{stage}/t{task}/a{attempt}/p{partition}.bin`` plus one
``COMMIT`` marker object per attempt — the unit of atomic publish. A
reader first resolves the committed attempt for a task (the marker is
written only after every partition object is durable), then streams the
partition object's frames. Framing extends the streaming-spill layout
with a trailing CRC per frame::

    <u32 len> <len payload bytes> <u32 crc32(payload)>

so a torn or bit-flipped object fails loudly (``SpoolCorruption``,
classified EXTERNAL) instead of yielding partial rows.

A copy of the JAX engine's ``trino_tpu/parallel/spool_backend.py`` (host
code over serde frames).
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
import zlib
from typing import Dict, List, Optional

from ..exec.serde import PageDeserializer, PageSerializer
from .spool import SpoolCorruption

#: object name of the per-attempt atomic-publish marker
COMMIT_MARKER = "COMMIT"


def attempt_key(query: str, stage: int, task: int, attempt: int) -> str:
    """Key prefix of one task attempt's published objects."""
    return f"{query}/f{stage}/t{task}/a{attempt}"


def task_key(query: str, stage: int, task: int) -> str:
    """Key prefix under which every attempt of a task publishes."""
    return f"{query}/f{stage}/t{task}"


def partition_key(query: str, stage: int, task: int, attempt: int,
                  partition: int) -> str:
    return f"{attempt_key(query, stage, task, attempt)}/p{partition}.bin"


def frame_blob(frames: List[bytes]) -> bytes:
    """CRC-framed object payload from raw serde frames."""
    out = []
    for f in frames:
        out.append(struct.pack("<I", len(f)))
        out.append(f)
        out.append(struct.pack("<I", zlib.crc32(f) & 0xFFFFFFFF))
    return b"".join(out)


def unframe_blob(blob: bytes, key: str = "?") -> List[bytes]:
    """Decode + CRC-verify a spool object back to its serde frames.
    Torn length prefixes, short payloads, and checksum mismatches all
    raise SpoolCorruption — the durable store failed the engine, and
    losing rows silently is never acceptable."""
    frames: List[bytes] = []
    off, n = 0, len(blob)
    while off < n:
        if n - off < 4:
            raise SpoolCorruption(
                f"torn frame header in spool object {key}")
        (ln,) = struct.unpack_from("<I", blob, off)
        off += 4
        if n - off < ln + 4:
            raise SpoolCorruption(
                f"torn frame in spool object {key}: expected {ln}+4 "
                f"bytes, have {n - off}")
        payload = blob[off:off + ln]
        off += ln
        (crc,) = struct.unpack_from("<I", blob, off)
        off += 4
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise SpoolCorruption(
                f"CRC mismatch in spool object {key}")
        frames.append(payload)
    return frames


class SpoolBackend:
    """Object-store-shaped contract: immutable objects, atomic
    first-publish-wins put, prefix listing. Implementations add only
    storage plumbing — key semantics live in this module's helpers."""

    def put(self, key: str, blob: bytes) -> bool:
        """Durably publish ``blob`` under ``key`` atomically. Returns
        False when an object already exists there (first publish wins
        and the duplicate is discarded — the speculative-attempt race
        contract of the exchange)."""
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """The object's full payload; KeyError when absent."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        """Keys under ``prefix`` (sorted, deterministic)."""
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError

    def delete_prefix(self, prefix: str):
        raise NotImplementedError

    # -- framed-object conveniences ------------------------------------

    def put_frames(self, key: str, frames: List[bytes]) -> bool:
        return self.put(key, frame_blob(frames))

    def get_frames(self, key: str) -> List[bytes]:
        return unframe_blob(self.get(key), key=key)


class LocalFileSpoolBackend(SpoolBackend):
    """Local-FS object store: keys map to files under one base
    directory; atomic publish is temp-write + fsync + ``os.link`` (the
    same first-publish-wins idiom as spool.ExchangeSink, so a
    half-written object is never visible under its key)."""

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir or tempfile.mkdtemp(
            prefix="trino_tpu_torch_spool_backend_")
        os.makedirs(self.base_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys are engine-generated ({query}/f{stage}/...), never user
        # input, but normalize anyway so a stray ".." cannot escape
        norm = os.path.normpath(key)
        if norm.startswith("..") or os.path.isabs(norm):
            raise ValueError(f"bad spool key {key!r}")
        return os.path.join(self.base_dir, norm)

    def put(self, key: str, blob: bytes) -> bool:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        f = tempfile.NamedTemporaryFile(
            dir=os.path.dirname(path), prefix=".stage.", delete=False)
        try:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
            f.close()
            try:
                os.link(f.name, path)  # atomic, fails if published
                return True
            except FileExistsError:
                return False
        finally:
            try:
                os.unlink(f.name)
            except OSError:
                pass

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str) -> List[str]:
        root = self._path(prefix)
        if not os.path.isdir(root):
            return [prefix] if os.path.exists(root) else []
        out = []
        for dirpath, _dirs, files in os.walk(root):
            rel = os.path.relpath(dirpath, self.base_dir)
            for name in files:
                if name.startswith("."):
                    continue  # staged temp objects are not published
                out.append(f"{rel}/{name}" if rel != "." else name)
        return sorted(out)

    def delete(self, key: str):
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str):
        import shutil

        root = self._path(prefix)
        if os.path.isdir(root):
            shutil.rmtree(root, ignore_errors=True)
        else:
            self.delete(prefix)

    def remove_all(self):
        import shutil

        shutil.rmtree(self.base_dir, ignore_errors=True)


# ---------------------------------------------------------------------
# task-attempt publish / resolve, built on the object contract


class SpooledTaskWriter:
    """Write-through tee target for ONE streaming task attempt: pages
    accumulate as CRC-framed serde frames per partition; ``commit``
    publishes every partition object then the COMMIT marker — so the
    attempt's output becomes visible atomically and survives the
    producing worker's death. Thread-safe: the producing driver thread
    adds while the task teardown may abort."""

    def __init__(self, backend: SpoolBackend, query: str, stage: int,
                 task: int, attempt: int, n_partitions: int):
        self.backend = backend
        self.query, self.stage = query, stage
        self.task, self.attempt = task, attempt
        self.n_partitions = n_partitions
        self._sers = [PageSerializer() for _ in range(n_partitions)]
        self._frames: List[List[bytes]] = [[] for _ in
                                           range(n_partitions)]
        self._lock = threading.Lock()
        self._done = False

    def add(self, partition: int, page):
        with self._lock:
            if self._done:
                return
            self._frames[partition].append(
                self._sers[partition].serialize(page))

    def commit(self) -> bool:
        """Publish partitions then the marker. Returns False when a
        sibling attempt already committed (its marker stands; this
        attempt's objects are harmless orphans reaped with the query
        prefix)."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            frames = self._frames
            self._frames = [[] for _ in range(self.n_partitions)]
        for p in range(self.n_partitions):
            self.backend.put_frames(
                partition_key(self.query, self.stage, self.task,
                              self.attempt, p), frames[p])
        return self.backend.put(
            f"{attempt_key(self.query, self.stage, self.task, self.attempt)}"
            f"/{COMMIT_MARKER}", b"")

    def abort(self):
        with self._lock:
            self._done = True
            self._frames = [[] for _ in range(self.n_partitions)]


def committed_attempt(backend: SpoolBackend, query: str, stage: int,
                      task: int) -> Optional[int]:
    """The lowest attempt of this task with a published COMMIT marker,
    or None when no attempt finished durably. Lowest (not latest) keeps
    resolution deterministic under attempt races — every consumer
    adopts the same bytes."""
    prefix = task_key(query, stage, task)
    attempts = []
    for key in backend.list(prefix):
        parts = key.split("/")
        if parts[-1] == COMMIT_MARKER and len(parts) >= 2 \
                and parts[-2].startswith("a"):
            try:
                attempts.append(int(parts[-2][1:]))
            except ValueError:
                continue
    return min(attempts) if attempts else None


class BackendSpoolCursor:
    """Page cursor over one committed partition object, honoring the
    ``start_page`` replay contract of spool.SpoolCursor: every frame is
    decoded (serde dictionary deltas are positional) but only pages past
    the cursor are yielded — the resume point of a mid-stream consumer
    adopting a dead producer's durable output."""

    def __init__(self, backend: SpoolBackend, key: str,
                 start_page: int = 0):
        self._frames = backend.get_frames(key)
        self._de = PageDeserializer()
        self._index = 0
        self.start_page = start_page

    def pages(self) -> List:
        out = []
        while True:
            p = self.poll()
            if p is None:
                break
            out.append(p)
        return out

    def poll(self):
        while self._index < len(self._frames):
            page = self._de.deserialize(self._frames[self._index])
            self._index += 1
            if self._index > self.start_page:
                return page
        return None

    def at_end(self) -> bool:
        return self._index >= len(self._frames)

    def has_page(self) -> bool:
        return not self.at_end()

    def listen(self):
        from .spool import _IMMEDIATE

        return _IMMEDIATE

    def close(self):
        self._frames = []
        self._index = len(self._frames)


def open_committed_partition(backend: SpoolBackend, query: str,
                             stage: int, task: int, partition: int,
                             start_page: int = 0
                             ) -> Optional[BackendSpoolCursor]:
    """Cursor over the committed attempt's partition object, or None
    when no attempt of this task has committed yet."""
    attempt = committed_attempt(backend, query, stage, task)
    if attempt is None:
        return None
    return BackendSpoolCursor(
        backend, partition_key(query, stage, task, attempt, partition),
        start_page=start_page)


#: process-wide backend registry: workers and the coordinator address
#: the same logical store through a base-dir handle shipped in the RPC
#: envelope (a real object store would carry credentials/URI instead)
_BACKENDS: Dict[str, LocalFileSpoolBackend] = {}
_BACKENDS_LOCK = threading.Lock()


def backend_for(base_dir: str) -> LocalFileSpoolBackend:
    with _BACKENDS_LOCK:
        be = _BACKENDS.get(base_dir)
        if be is None:
            be = _BACKENDS[base_dir] = LocalFileSpoolBackend(base_dir)
        return be
