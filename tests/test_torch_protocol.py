"""The HTTP statement protocol and the CLI over the torch engine, against
the JAX engine's.

The nine cases of tests/test_protocol.py: each statement goes to two
servers on 127.0.0.1 (port 0), one over each engine's LocalQueryRunner
(the port's with ``device="cpu"``), through each package's own Client,
and the documents must agree: columns, typed JSON rows, paging, error
codes, final stats. The CLI runs embedded (``--device cpu``) and against
the port's server. Beyond them: GET /v1/query/{id}, GET /v1/metrics and
admission batching over HTTP, and an import check over the serving
modules.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from trino_tpu.client import Client as JClient
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.server.protocol import ProtocolServer as JServer
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch.client import Client
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.server.protocol import ProtocolServer
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.types import TrinoError


@pytest.fixture(scope="module")
def servers():
    jr = JRunner({"tpch": JTpch(page_rows=4096)},
                 JSession(catalog="tpch", schema="micro",
                          properties={"hbo_enabled": False}))
    pr = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                          Session(catalog="tpch", schema="micro"),
                          device="cpu")
    js = JServer(jr, page_size=10).start()
    ps = ProtocolServer(pr, page_size=10).start()
    yield js, ps
    js.stop()
    ps.stop()


@pytest.fixture(scope="module")
def server(servers):
    return servers[1]


def both(servers, sql):
    """(JAX document, port document) of one statement, each through its
    own package's client; the columns and rows must agree."""
    js, ps = servers
    want = JClient(js.uri).execute(sql)
    got = Client(ps.uri).execute(sql)
    assert got.columns == want.columns
    assert got.rows == want.rows
    return want, got


def test_simple_query(servers):
    _, res = both(servers, "select count(*) c from orders")
    assert res.column_names == ["c"]
    assert res.rows == [[1500]]
    assert res.stats["state"] == "FINISHED"


def test_typed_values(servers):
    _, res = both(servers, "select o_orderdate, o_totalprice from orders "
                           "where o_orderkey = 1")
    [[date, price]] = res.rows
    assert isinstance(date, str) and date.count("-") == 2  # ISO date
    assert isinstance(price, str)  # decimals travel as strings
    assert res.columns[0]["type"] == "date"


def test_next_uri_paging(servers):
    # page_size=10 forces multiple nextUri hops for 25 nations
    _, res = both(servers, "select n_name from nation order by n_name")
    assert len(res.rows) == 25
    assert res.rows == sorted(res.rows)


def test_error_propagates(servers):
    js, ps = servers
    with pytest.raises(Exception) as want:
        JClient(js.uri).execute("select no_such_column from orders")
    with pytest.raises(TrinoError) as got:
        Client(ps.uri).execute("select no_such_column from orders")
    assert "no_such_column" in str(got.value)
    assert got.value.code == want.value.code


def test_final_stats_exposed(servers):
    want, res = both(servers, "select l_returnflag, count(*) from lineitem "
                              "group by 1 order by 1")
    assert "memory" in res.stats and "memory" in want.stats
    assert res.stats["memory"]["peak_bytes"] > 0


def test_session_statements(servers):
    js, ps = servers
    res = Client(ps.uri).execute("show session")
    names = [r[0] for r in res.rows]
    assert "enable_dynamic_filtering" in names
    assert names == [r[0] for r in JClient(js.uri).execute(
        "show session").rows]


def test_cli_embedded(capsys):
    from trino_tpu_torch.cli import main

    rc = main(["--embedded", "--catalog", "tpch", "--schema", "micro",
               "--device", "cpu", "-e", "select count(*) c from region"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "c" in out and "5" in out and "(1 row)" in out


def test_cli_embedded_cuda_without_a_card_raises():
    """The CLI's default device is the card; without one the embedded
    runner raises instead of running on the CPU."""
    import torch

    from trino_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        main(["--embedded", "-e", "select 1"])


def test_cli_against_server(server, capsys):
    from trino_tpu_torch.cli import main

    rc = main(["--server", server.uri, "-e", "select 1 one, 'x' tag"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "one" in out and "tag" in out


def test_info_endpoints(server):
    with urllib.request.urlopen(server.uri + "/v1/info") as r:
        info = json.loads(r.read())
    assert info["coordinator"] is True
    with urllib.request.urlopen(server.uri + "/v1/status") as r:
        assert json.loads(r.read())["state"] == "ACTIVE"


def test_query_info_and_metrics(server):
    """GET /v1/query/{id} serves a finished statement's stats tree, an
    unknown id 404s; GET /v1/metrics renders the runner's families and
    the server's statement counters."""
    body = json.loads(urllib.request.urlopen(urllib.request.Request(
        server.uri + "/v1/statement", data=b"select count(*) from region",
        method="POST")).read())
    qid = body["id"]
    nxt = body["nextUri"]
    while nxt:
        doc = json.loads(urllib.request.urlopen(nxt).read())
        nxt = doc.get("nextUri")
    with urllib.request.urlopen(f"{server.uri}/v1/query/{qid}") as r:
        info = json.loads(r.read())
    assert info["state"] == "FINISHED" and info["rows"] == 1
    assert info["stats"]["memory"]["peak_bytes"] >= 0
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server.uri}/v1/query/nope")
    assert e.value.code == 404
    text = urllib.request.urlopen(server.uri + "/v1/metrics").read() \
        .decode()
    for family in ("trino_http_statements_total", "trino_plan_cache_total",
                   "trino_queries_total", "trino_plan_template_total"):
        assert f"# TYPE {family}" in text


def test_admission_batch_over_http():
    """A burst of same-shape statements that arrives while the
    executor is busy drains as ONE admission batch and rides the
    batched path; each client gets its own rows."""
    from trino_tpu_torch.telemetry.metrics import parse_prometheus

    pr = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                          Session(catalog="tpch", schema="micro"),
                          device="cpu")
    srv = ProtocolServer(pr).start()
    gate = threading.Event()
    try:
        for _ in range(4):   # hold every executor thread
            srv.executor.submit(gate.wait)
        sqls = ["select count(*) from lineitem where l_quantity < %d" % q
                for q in (10, 20, 30, 40)]
        out = [None] * 4

        def go(i):
            out[i] = Client(srv.uri).execute(sqls[i]).rows

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while len(srv._backlog) < 4 and time.time() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert out == [[list(r) for r in pr.execute(s).rows] for s in sqls]
        fams = parse_prometheus(srv.metrics_text())
        assert fams["trino_http_admission_batches_total"] == \
            {'{size="4"}': 1.0}
        assert pr.query_cache.batched_launches == 4
        assert pr.query_cache.templates.dispositions == \
            {"agg_stage_vmapped": 1}
    finally:
        gate.set()
        srv.stop()


def test_serving_modules_import_neither_jax_nor_trino_tpu():
    """Importing every serving module of the port loads neither jax nor
    the JAX package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["cache", "security", "events", "resource_groups",
            "telemetry.progress", "telemetry.metrics", "exec.stats",
            "exec.batched", "connectors.system", "server.protocol",
            "client", "config", "cli", "ops.kernel_sizing", "runner"]
    code = ("import sys\n"
            + "".join(f"import trino_tpu_torch.{m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'trino_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
