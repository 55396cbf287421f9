"""Access control, event listeners, resource groups and config scopes:
the torch engine against the JAX engine.

The cases of tests/test_security_events.py, each run through both
engines' runners (the port's on the CPU) with the same rules, listeners,
groups and etc/ directory: the same rows, the same error codes (a
denial is PERMISSION_DENIED in both), the same events and the same
admission counters.
"""

import json
import threading
import time

import pytest

from test_torch_tpch_q1 import _same_rows
from trino_tpu.config import load_etc as j_load_etc
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.events import EventListener as JEventListener
from trino_tpu.resource_groups import ResourceGroupManager as JGroups
from trino_tpu.resource_groups import ResourceGroupSpec as JGroupSpec
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.security import RuleBasedAccessControl as JAcl
from trino_tpu.security import TableRule as JRule
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch.config import load_etc
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.events import EventListener
from trino_tpu_torch.resource_groups import (QueryQueueFullError,
                                             ResourceGroupManager,
                                             ResourceGroupSpec)
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.security import (AccessDeniedError,
                                      RuleBasedAccessControl, TableRule)
from trino_tpu_torch.sql.analyzer import Session


def runners(user="alice", acl=None, listeners=None, groups=None):
    """(JAX runner, port runner) over tpch micro and a memory catalog;
    ``acl``/``listeners``/``groups`` are (jax, torch) pairs."""
    jr = JRunner({"tpch": JTpch(page_rows=2048), "mem": JMemory()},
                 JSession(catalog="tpch", schema="micro", user=user,
                          properties={"hbo_enabled": False}),
                 access_control=acl[0] if acl else None,
                 event_listeners=listeners[0] if listeners else None,
                 resource_groups=groups[0] if groups else None)
    pr = LocalQueryRunner(
        {"tpch": TpchConnector(page_rows=2048), "mem": MemoryConnector()},
        Session(catalog="tpch", schema="micro", user=user,
                properties={"hbo_enabled": False}),
        device="cpu",
        access_control=acl[1] if acl else None,
        event_listeners=listeners[1] if listeners else None,
        resource_groups=groups[1] if groups else None)
    return jr, pr


def both(jr, pr, sql):
    """Run ``sql`` in both engines: equal rows, or the same error code
    (returned, None when the statement succeeded)."""
    outs = []
    for r in (jr, pr):
        try:
            outs.append(r.execute(sql))
        except Exception as e:  # compared below
            outs.append(e)
    want, got = outs
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (want, got)
        assert got.code == want.code, (want, got)
        return got.code
    _same_rows(got.rows, want.rows)
    return None


def analyst_rules():
    def rules(acl, rule):
        return acl([
            rule(user="alice", catalog="tpch", privileges=["SELECT"]),
            rule(user="alice", catalog="mem",
                 privileges=["OWNERSHIP", "SELECT", "INSERT"]),
            rule(user="bob", catalog="tpch", table="nation",
                 privileges=["SELECT"], columns=["n_name", "n_regionkey"]),
        ])
    return rules(JAcl, JRule), rules(RuleBasedAccessControl, TableRule)


# -- access control ----------------------------------------------------


def test_select_allowed_and_denied():
    jr, pr = runners(acl=analyst_rules())
    assert both(jr, pr, "select count(*) from nation") is None
    assert pr.execute("select count(*) from nation").rows == [(25,)]
    jr, pr = runners(acl=analyst_rules(), user="carol")
    assert both(jr, pr, "select count(*) from nation") == "PERMISSION_DENIED"
    with pytest.raises(AccessDeniedError):
        pr.execute("select count(*) from nation")


def test_column_level_rules():
    jr, pr = runners(acl=analyst_rules(), user="bob")
    assert both(jr, pr, "select n_name from nation limit 1") is None
    assert both(jr, pr, "select n_comment from nation limit 1") == \
        "PERMISSION_DENIED"
    assert both(jr, pr, "select count(*) from region") == "PERMISSION_DENIED"


def test_write_privileges():
    jr, pr = runners(acl=analyst_rules())
    assert both(jr, pr, "create table mem.default.t1 (x bigint)") is None
    assert both(jr, pr, "insert into mem.default.t1 values (1)") is None
    assert both(jr, pr, "select x from mem.default.t1") is None
    assert both(jr, pr, "create table tpch.micro.nope (x bigint)") == \
        "PERMISSION_DENIED"
    assert both(jr, pr, "drop table mem.default.t1") is None


def test_query_user_gate():
    jr, pr = runners(acl=(
        JAcl([JRule(privileges=["SELECT"])], query_users="alice|bob"),
        RuleBasedAccessControl([TableRule(privileges=["SELECT"])],
                               query_users="alice|bob")), user="mallory")
    assert both(jr, pr, "select 1") == "PERMISSION_DENIED"
    with pytest.raises(AccessDeniedError):
        pr.execute_batch(["select 1"])


# -- event listeners ---------------------------------------------------


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.created = []
            self.completed = []

        def query_created(self, e):
            self.created.append(e)

        def query_completed(self, e):
            self.completed.append(e)

    return Recorder()


def test_events_success_and_failure():
    jrec, prec = _recorder(JEventListener), _recorder(EventListener)
    jr, pr = runners(listeners=([jrec], [prec]))
    both(jr, pr, "select count(*) from nation")
    both(jr, pr, "select * from no_such_table")
    for rec in (jrec, prec):
        assert len(rec.created) == 2 and len(rec.completed) == 2
    for j, p in zip(jrec.completed, prec.completed):
        assert (p.state, p.user, p.sql, p.output_rows, p.error_code) == \
            (j.state, j.user, j.sql, j.output_rows, j.error_code)
    done, failed = prec.completed
    assert done.state == "FINISHED" and done.output_rows == 1
    assert done.user == "alice" and done.wall_ms >= 0
    assert failed.state == "FAILED" and failed.error_message


def test_batched_members_fire_events():
    """A batched burst fires each member's created/completed pair, as
    the JAX engine does, so system.runtime.queries sees every
    statement."""
    jrec, prec = _recorder(JEventListener), _recorder(EventListener)
    jr, pr = runners(listeners=([jrec], [prec]))
    sqls = ["select count(*) from nation where n_regionkey = %d" % i
            for i in range(4)]
    for r in (jr, pr):
        r.execute_batch(sqls)
    assert [(e.state, e.sql, e.output_rows) for e in prec.completed] == \
        [(e.state, e.sql, e.output_rows) for e in jrec.completed]
    assert len(prec.completed) == 4
    rows = pr.execute("select query, state from system.runtime.queries "
                      "where query like 'select count(*) from nation%'").rows
    assert sorted(rows) == sorted((s, "FINISHED") for s in sqls)


# -- resource groups ---------------------------------------------------


@pytest.mark.parametrize("engine", ["jax", "torch"])
def test_resource_group_concurrency_and_queue(engine):
    Groups, Spec = (JGroups, JGroupSpec) if engine == "jax" \
        else (ResourceGroupManager, ResourceGroupSpec)
    mgr = Groups([Spec("global", max_concurrency=1, max_queued=1)])
    g = mgr.select("alice")
    g.acquire()
    t0 = time.time()
    with pytest.raises(Exception) as exc:
        g.acquire(timeout=0.1)
    assert exc.value.code == "QUERY_QUEUE_FULL"
    assert time.time() - t0 >= 0.1
    results = []

    def waiter():
        with g.run(timeout=5):
            results.append("ran")

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    g.release()
    th.join(timeout=5)
    assert results == ["ran"]


def test_resource_group_selectors_and_hierarchy():
    config = {"groups": [
        {"name": "admin", "user": "admin", "max_concurrency": 5},
        {"name": "global", "max_concurrency": 2, "subgroups": [
            {"name": "etl", "user": "etl_.*", "max_concurrency": 1},
        ]},
    ]}
    jm = JGroups.from_config(config)
    mgr = ResourceGroupManager.from_config(config)
    for user in ("admin", "etl_nightly", "alice"):
        assert mgr.select(user).name == jm.select(user).name
    assert mgr.select("etl_nightly").name == "global.etl"
    mgr.select("etl_nightly").acquire()
    mgr.select("alice").acquire()
    with pytest.raises(QueryQueueFullError):
        mgr.select("etl_other").acquire(timeout=0.05)


def test_runner_admission():
    groups = tuple(G([S("global", max_concurrency=1, max_queued=0)])
                   for G, S in ((JGroups, JGroupSpec),
                                (ResourceGroupManager, ResourceGroupSpec)))
    jr, pr = runners(groups=groups)
    for _ in range(2):
        assert both(jr, pr, "select 1") is None  # released after each
    for r in (jr, pr):
        assert r.execute_batch(["select 1", "select 2"])[1].rows == [(2,)]
    # one slot per statement, one for the whole batch
    assert list(groups[1].counter_stats()) == \
        list(groups[0].counter_stats())
    assert [row[1] for row in groups[1].counter_stats()] == [3]


# -- config scopes -----------------------------------------------------


def test_load_etc(tmp_path):
    (tmp_path / "catalog").mkdir()
    (tmp_path / "config.properties").write_text(
        "default-catalog=tiny_tpch\n")
    (tmp_path / "catalog" / "tiny_tpch.properties").write_text(
        "connector.name=tpch\npage_rows=1024\n")
    (tmp_path / "catalog" / "scratch.properties").write_text(
        "connector.name=memory\n")
    (tmp_path / "access-control.json").write_text(json.dumps({
        "tables": [{"user": ".*", "privileges": ["SELECT"]}]}))
    (tmp_path / "resource-groups.json").write_text(json.dumps({
        "groups": [{"name": "global", "max_concurrency": 4}]}))

    cfg, jcfg = load_etc(str(tmp_path)), j_load_etc(str(tmp_path))
    assert set(cfg.connectors) == set(jcfg.connectors) == \
        {"tiny_tpch", "scratch"}
    assert cfg.default_catalog == jcfg.default_catalog == "tiny_tpch"
    assert cfg.connectors["tiny_tpch"].page_rows == 1024
    assert cfg.resource_groups is not None

    jr = JRunner(jcfg.connectors,
                 JSession(catalog="tiny_tpch", schema="micro",
                          properties={"hbo_enabled": False}),
                 access_control=jcfg.access_control,
                 resource_groups=jcfg.resource_groups)
    pr = LocalQueryRunner(cfg.connectors,
                          Session(catalog="tiny_tpch", schema="micro"),
                          device="cpu", access_control=cfg.access_control,
                          resource_groups=cfg.resource_groups)
    assert both(jr, pr, "select count(*) from region") is None
    assert pr.execute("select count(*) from region").rows == [(5,)]
    assert both(jr, pr, "create table scratch.default.x (a bigint)") == \
        "PERMISSION_DENIED"
