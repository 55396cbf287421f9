"""Tiny framed RPC for the multi-process runtime.

Reference analog: the airlift HTTP client/server carrying JSON task
requests (``server/remotetask/HttpRemoteTask.java:599-623``) and
octet-stream page results (``server/TaskResource.java:308``).  Here the
control plane is length-prefixed pickled dicts over localhost TCP and
the data plane is the serde page frames — same pull-based shape, minimal
transport.  Pickle is acceptable because workers are processes WE spawn
on this host (the reference's intra-cluster trust model); the external
client protocol (HTTP + JSON) is a separate layer.

A copy of the JAX engine's ``trino_tpu/parallel/rpc.py``. Bodies are
pickled dicts of Python values; pages travel only as serde frames, never
as tensors.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any


def send_msg(sock: socket.socket, obj: Any):
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<I", len(blob)) + blob)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, 4)
    (n,) = struct.unpack("<I", header)
    return pickle.loads(_recv_exact(sock, n))


def send_frame(sock: socket.socket, blob: bytes):
    sock.sendall(struct.pack("<I", len(blob)) + blob)


def recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def with_trace(request: dict, span, **extra) -> dict:
    """Attach a span's propagation context to a task-RPC request
    envelope (W3C-traceparent-style dict; see telemetry.tracing).  The
    null span contributes nothing, so an untraced request carries zero
    extra bytes — the zero-cost-when-off contract."""
    ctx = span.context(**extra) if span is not None else None
    if ctx:
        request["trace"] = ctx
    return request


def call(addr, request: dict, timeout: float = 600.0) -> dict:
    """One request/response round trip on a fresh connection."""
    with socket.create_connection(addr, timeout=timeout) as sock:
        send_msg(sock, request)
        return recv_msg(sock)


def fetch_pages(addr, task_id: str, partition: int,
                deserializer=None, timeout: float = 600.0,
                retries: int = 2, retry_backoff: float = 0.05,
                on_retry=None):
    """Pull one task's partition snapshot: returns a list of Pages.

    Failure semantics (the FT seam):
    - a worker-side failure propagates as RemoteTaskError carrying the
      remote error TYPE and traceback, so the coordinator can decide
      fail-fast (USER) vs retry (everything else) — not a bare string;
    - a connection dropped mid-frame is retried here with backoff: each
      ``get_results`` response is a complete, independently-serialized
      snapshot (the worker keeps the buffer and builds a fresh serde
      stream per request), so a re-pull cannot lose or duplicate pages.
      Streaming pulls (``get_page_stream``) reconnect through their own
      channel's ack-based cursor (RemoteExchangeChannel): the producer
      retains unacked frames and replays them byte-identically.
    """
    import time

    from .fault import EXTERNAL, RemoteTaskError

    last: Exception = None
    for attempt in range(retries + 1):
        try:
            with socket.create_connection(addr, timeout=timeout) as sock:
                send_msg(sock, {"op": "get_results", "task_id": task_id,
                                "partition": partition})
                head = recv_msg(sock)
                if head.get("error"):
                    raise RemoteTaskError.from_response(
                        head, f"worker get_results({task_id}) failed")
                de = deserializer if deserializer is not None \
                    and attempt == 0 else _fresh_deserializer()
                pages = []
                for _ in range(head["n_pages"]):
                    pages.append(de.deserialize(recv_frame(sock)))
                return pages
        except RemoteTaskError:
            raise  # typed worker failure: the taxonomy decides upstream
        except OSError as e:  # includes ConnectionError mid-frame
            last = e
            if attempt < retries:
                if on_retry is not None:
                    on_retry(e)
                time.sleep(retry_backoff * (2 ** attempt))
    raise RemoteTaskError(
        f"pull from {addr} task {task_id} failed after "
        f"{retries + 1} attempts: {last!r}", EXTERNAL,
        "PAGE_TRANSPORT_ERROR", connection_lost=True)


def _fresh_deserializer():
    from ..exec.serde import PageDeserializer

    return PageDeserializer()
