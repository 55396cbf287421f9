"""The query streams: one child process of a run, one thread per stream.

Each stream is a client session of its own user that sends its next
statement when the previous one has returned (a closed loop, TPC-H's
throughput test), over the statement protocol: ``POST /v1/statement``,
then ``nextUri`` until it is gone, sleeping the traffic's poll interval
while the statement is queued or running. A statement's latency runs
from its POST to its last page.

The warm-up sends each template's draws in turn until its plan has
stopped changing: after at least the plan's ``warmup_least`` of them,
until ``EXPLAIN`` of the statement just sent reads as it did after the
one before (literals, numbers and estimates left out), or its draws run
out.

Protocol with the parent, one JSON document per line: the parent writes
the plan (``workload.plan``) on stdin; the child runs every stream's
warm-up, one stream after another, and writes ``{"ready": true,
"warmup": [...]}``; the parent writes ``{"go": seconds}``; the child
runs the window, the streams at once, and writes
``{"records": [...]}``. Statements started before the window closed are
waited for. Standard library only, so the client's Python never shares
the engine's lock.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time
import urllib.request

#: seconds a statement may take before the client gives up on it
STATEMENT_TIMEOUT_S = 300.0


class Client:
    """The statement protocol's client (the port's ``client.py``, with
    the poll interval a parameter of the traffic)."""

    def __init__(self, server: str, user: str, poll_s: float):
        self.server = server.rstrip("/")
        self.user = user
        self.poll_s = poll_s

    def _http(self, method: str, url: str, body: bytes = None) -> dict:
        req = urllib.request.Request(url, data=body, method=method,
                                     headers={"X-Trino-User": self.user})
        with urllib.request.urlopen(req, timeout=STATEMENT_TIMEOUT_S) as r:
            return json.loads(r.read().decode())

    def execute(self, sql: str) -> dict:
        """Runs one statement; returns its columns and rows, or its
        error."""
        doc = self._http("POST", f"{self.server}/v1/statement",
                         sql.encode())
        columns, rows = None, []
        deadline = time.monotonic() + STATEMENT_TIMEOUT_S
        while True:
            if doc.get("error"):
                return {"error": doc["error"].get("message", "failed")}
            if doc.get("columns") and columns is None:
                columns = doc["columns"]
            rows.extend(doc.get("data", ()))
            nxt = doc.get("nextUri")
            if not nxt:
                return {"columns": columns, "rows": rows}
            if time.monotonic() > deadline:
                return {"error": "client timeout"}
            if doc.get("stats", {}).get("state") in ("QUEUED", "RUNNING"):
                time.sleep(self.poll_s)
            doc = self._http("GET", nxt)


def _run(client: Client, stmt: dict) -> dict:
    rec = dict(stmt)
    rec["t_post"] = time.time()
    t0 = time.perf_counter()
    try:
        out = client.execute(stmt["sql"])
    except OSError as e:  # connection refused, reset, timed out
        out = {"error": f"{type(e).__name__}: {e}"}
    rec["latency_ms"] = (time.perf_counter() - t0) * 1e3
    rec["t_done"] = time.time()
    rec.update(out)
    return rec


#: what ``plan_shape`` leaves out of a plan: estimates, quoted literals,
#: numbers
_UNSHAPED = [(re.compile(r"est~\S+ rows( \[[^\]]*\])?"), ""),
             (re.compile(r"'[^']*'"), "''"),
             (re.compile(r"\d+(\.\d+)?"), "#")]


def plan_shape(client: Client, sql: str) -> str:
    """The plan the server would now run for ``sql``, as ``EXPLAIN``
    prints it, with estimates, literals and numbers left out."""
    out = client.execute("EXPLAIN " + sql)
    if "error" in out:
        return "error: " + out["error"]
    text = "\n".join(str(r[0]) for r in out["rows"])
    for pattern, by in _UNSHAPED:
        text = pattern.sub(by, text)
    return text


def warm_template(client: Client, stmts: list, least: int) -> list:
    """Sends ``stmts`` in turn until the template's plan is settled:
    at least ``least`` of them, then until one leaves the plan as the
    one before it did. The last record holds ``plan_changes``."""
    recs, shape, changes = [], None, 0
    for k, stmt in enumerate(stmts):
        recs.append(_run(client, stmt))
        if "error" in recs[-1]:
            break
        now = plan_shape(client, stmt["sql"])
        settled = now == shape
        changes += shape is not None and not settled
        shape = now
        if settled and k + 1 >= least:
            break
    recs[-1]["plan_changes"] = changes
    return recs


def run_streams(url: str, plan: dict, phase: str, until: float = None):
    """Each stream's statements of ``phase``. "warmup": each template's
    until its plan settles, one stream after another, so that no
    statement of the warm-up runs beside another. "window": in order
    while ``time.time() < until``, the streams in threads started
    together. Returns every statement's record."""
    if phase == "warmup":
        return [r for s in plan["streams"] for stmts in s[phase]
                for r in warm_template(Client(url, s["user"],
                                              plan["poll_s"]),
                                       stmts, plan["warmup_least"])]
    out = [[] for _ in plan["streams"]]
    start = threading.Barrier(len(plan["streams"]))

    def stream(i, s):
        client = Client(url, s["user"], plan["poll_s"])
        start.wait()
        for stmt in s[phase]:
            if until is not None and time.time() >= until:
                break
            out[i].append(_run(client, stmt))

    threads = [threading.Thread(target=stream, args=(i, s), daemon=True)
               for i, s in enumerate(plan["streams"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for recs in out for r in recs]


def _send(doc: dict) -> None:
    sys.stdout.write(json.dumps(doc) + "\n")
    sys.stdout.flush()


def main() -> int:
    url = sys.argv[1]
    plan = json.loads(sys.stdin.readline())
    warm = run_streams(url, plan, "warmup")
    _send({"ready": True, "warmup": warm})
    go = json.loads(sys.stdin.readline())
    t0 = time.time()
    records = run_streams(url, plan, "window", until=t0 + go["go"])
    _send({"window": [t0, t0 + go["go"]], "records": records})
    return 0


if __name__ == "__main__":
    sys.exit(main())
