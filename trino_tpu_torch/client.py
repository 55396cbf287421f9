"""Python client for the HTTP statement protocol.

Reference analog: ``client/trino-client/.../StatementClientV1.java:65,
334-346`` — POST the statement, follow ``nextUri`` until it disappears,
accumulating typed rows; surface server errors as exceptions.

The JAX engine's ``trino_tpu/client.py``, copied.
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass, field
from typing import List, Optional

from .types import TrinoError


@dataclass
class ClientResult:
    columns: List[dict] = field(default_factory=list)
    rows: List[list] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    @property
    def column_names(self) -> List[str]:
        return [c["name"] for c in self.columns]


class Client:
    """``Client("http://host:port").execute("select 1")``"""

    def __init__(self, server: str, poll_interval: float = 0.05,
                 timeout: float = 600.0, user: Optional[str] = None):
        self.server = server.rstrip("/")
        self.poll_interval = poll_interval
        self.timeout = timeout
        #: tenant identity for resource-group routing + admission
        #: batching (reference: the X-Trino-User request header)
        self.user = user

    def _http(self, method: str, url: str, body: Optional[bytes] = None):
        headers = {"X-Trino-User": self.user} if self.user else {}
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    def execute(self, sql: str) -> ClientResult:
        doc = self._http("POST", f"{self.server}/v1/statement",
                         sql.encode())
        out = ClientResult()
        deadline = time.time() + self.timeout
        while True:
            if doc.get("error"):
                e = doc["error"]
                raise TrinoError(e.get("message", "query failed"),
                                 e.get("errorCode",
                                       "GENERIC_INTERNAL_ERROR"))
            if doc.get("columns") and not out.columns:
                out.columns = doc["columns"]
            out.rows.extend(doc.get("data", []))
            if doc.get("stats"):
                out.stats = doc["stats"]
            nxt = doc.get("nextUri")
            if not nxt:
                return out
            if time.time() > deadline:
                raise TrinoError("client poll timeout",
                                 "CLIENT_TIMEOUT")
            state = doc.get("stats", {}).get("state")
            if state in ("QUEUED", "RUNNING"):
                time.sleep(self.poll_interval)
            doc = self._http("GET", nxt)
