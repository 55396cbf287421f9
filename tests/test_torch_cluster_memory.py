"""Cluster memory, membership and spool units of the torch engine against
the JAX engine's.

Each case runs the body of a case of the JAX engine's own tests through
both engines' classes and asserts the JAX case's assertions on each, and
that the port makes the same decisions (the same victims, placements,
scaling decisions, revocation order, counters and decoded rows):

- the ``NodeMemoryPool`` and killer cases of tests/test_memory_governance.py
  (the node pool's cross-query revocation, its blocked-node failure and
  snapshot, and every killer policy);
- the ten cases of tests/test_cluster_elastic.py (ledger, placement,
  autoscaler);
- the unit cases of tests/test_spool.py and the nine of
  tests/test_spool_backend.py (pages made with each engine's ``Page``,
  spooled through each engine's serde).

No process is spawned here; the process-level cases are in
test_torch_process_runner.py and test_torch_chaos*.py.
"""

import os
from types import SimpleNamespace

import pytest

import trino_tpu.exec.memory as jmem
import trino_tpu.parallel.autoscaler as jauto
import trino_tpu.parallel.cluster as jcluster
import trino_tpu.parallel.cluster_memory as jcm
import trino_tpu.parallel.fault as jfault
import trino_tpu.parallel.spool as jspool
import trino_tpu.parallel.spool_backend as jsb
import trino_tpu_torch.exec.memory as pmem
import trino_tpu_torch.parallel.autoscaler as pauto
import trino_tpu_torch.parallel.cluster as pcluster
import trino_tpu_torch.parallel.cluster_memory as pcm
import trino_tpu_torch.parallel.fault as pfault
import trino_tpu_torch.parallel.spool as pspool
import trino_tpu_torch.parallel.spool_backend as psb
from trino_tpu import types as JT
from trino_tpu.block import Page as JPage
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu.types import TrinoError as JTrinoError
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import Page as PPage
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss
from trino_tpu_torch.types import TrinoError as PTrinoError


def _clear_stores():
    for st in (jss.store(), pss.store()):
        st.clear()
    for prof in (jprof, pprof):
        prof.reset()
    for h in (jde.SIZING_HISTORY, pde.SIZING_HISTORY):
        h.reset()


@pytest.fixture(autouse=True)
def _fresh_stores():
    """Both engines' history stores, profilers and exchange sizing
    histories start and end every case empty."""
    _clear_stores()
    yield
    _clear_stores()


def _ns(mem, auto, cluster, cm, fault, spool, sb, T, Page, TrinoError):
    return SimpleNamespace(mem=mem, auto=auto, cluster=cluster, cm=cm,
                           fault=fault, spool=spool, sb=sb, T=T,
                           Page=Page, TrinoError=TrinoError)


JAX = _ns(jmem, jauto, jcluster, jcm, jfault, jspool, jsb, JT, JPage,
          JTrinoError)
PORT = _ns(pmem, pauto, pcluster, pcm, pfault, pspool, psb, PT, PPage,
           PTrinoError)


def both(case, *args):
    """Run ``case(engine, *args)`` through the JAX engine and the port;
    the port's decisions must equal the JAX engine's."""
    want = case(JAX, *args)
    got = case(PORT, *args)
    assert got == want, f"port {got!r} != JAX {want!r}"
    return got


# ------------------------------------------- node pool (cross-query) ----


def test_default_node_memory_bytes_falls_back_on_cpu():
    # the JAX engine's CPU backend reports no stats -> fallback; the
    # port's CPU device reports none either
    assert jmem.default_node_memory_bytes(fallback=123) in (123,) or \
        jmem.default_node_memory_bytes(fallback=123) > 1 << 28
    assert pmem.default_node_memory_bytes("cpu", fallback=123) == 123


def _cross_query_revoke(E):
    node = E.mem.NodeMemoryPool(1000)
    a = node.create_query_pool("qa", 1000, spill_enabled=True)
    b = node.create_query_pool("qb", 1000, spill_enabled=True)
    order = []
    ca = a.create_context("a-op")
    cb = b.create_context("b-op")
    ca.set_revoke_callback(lambda: order.append("qa") or 600)
    cb.set_revoke_callback(lambda: order.append("qb") or 300)
    ca.reserve(600)
    cb.reserve(300)
    assert node.reserved == 900
    # qc needs 500: node over budget -> revoke qa (largest) only
    c = node.create_query_pool("qc", 1000, spill_enabled=True)
    cc = c.create_context("c-op")
    cc.reserve(500)
    assert order == ["qa"]
    assert node.reserved == 300 + 500
    assert node.cross_query_revokes == 1
    return order, node.reserved, node.peak_bytes, node.cross_query_revokes


def test_node_pool_cross_query_revoke_largest_first():
    both(_cross_query_revoke)


def _blocked(E):
    node = E.mem.NodeMemoryPool(1000)
    a = node.create_query_pool("qa", 1000, spill_enabled=False)
    a.create_context("x").reserve(900)
    b = node.create_query_pool("qb", 1000, spill_enabled=False)
    with pytest.raises(E.mem.NodeMemoryExceededError) as exc:
        b.create_context("y").reserve(500)
    assert E.fault.classify_error_code(exc.value.code) == \
        E.fault.INSUFFICIENT_RESOURCES
    assert node.blocked_events == 1
    snap = node.snapshot()
    assert snap["blocked_events"] == 1
    # the failed reservation must not leak into either pool
    assert b.reserved == 0
    assert node.reserved == 900
    return (exc.value.code, str(exc.value), snap)


def test_node_pool_blocked_raises_insufficient_resources():
    both(_blocked)


def _snapshot_release(E):
    node = E.mem.NodeMemoryPool(1 << 20)
    a = node.create_query_pool("qa", 1 << 20)
    a.create_context("x").reserve(1234)
    snap = node.snapshot()
    assert snap["queries"]["qa"]["reserved"] == 1234
    node.release_query("qa")
    assert node.reserved == 0
    # released peaks survive for the retry estimator
    after = node.snapshot()
    assert after["queries"]["qa"]["peak"] == 1234
    return snap, after


def test_node_pool_snapshot_tracks_per_query_and_release():
    both(_snapshot_release)


# ------------------------------------------------- killer policies ------


def _snap(worker_id, blocked, queries, max_bytes=1000):
    return {"max_bytes": max_bytes,
            "reserved_bytes": sum(q["reserved"] for q in queries.values()),
            "blocked_events": 1 if blocked else 0,
            "queries": queries}


def _blocked_nodes_policy(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    mgr.update(0, _snap(0, True, {"qa": {"reserved": 70, "peak": 70},
                                  "qb": {"reserved": 30, "peak": 30}}))
    mgr.update(1, _snap(1, False, {"qb": {"reserved": 900, "peak": 900}}))
    victim = mgr.maybe_kill()
    assert victim == "qa"
    with pytest.raises(E.cm.QueryKilledError) as exc:
        mgr.check_killed("qa")
    assert exc.value.code == "EXCEEDED_CLUSTER_MEMORY"
    assert E.fault.classify_error_code(exc.value.code) == \
        E.fault.INSUFFICIENT_RESOURCES
    mgr.check_killed("qa")  # the flag was consumed
    return victim, exc.value.code, mgr.last_kill_source, mgr.kill_count


def test_killer_blocked_nodes_policy_is_deterministic():
    both(_blocked_nodes_policy)


def _total_reservation(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation")
    mgr.update(0, _snap(0, True, {"qa": {"reserved": 70, "peak": 0},
                                  "qb": {"reserved": 30, "peak": 0}}))
    mgr.update(1, _snap(1, False, {"qb": {"reserved": 900, "peak": 0}}))
    victim = mgr.maybe_kill()
    assert victim == "qb"  # cluster-wide largest
    return victim


def test_killer_total_reservation_policy():
    both(_total_reservation)


def _tie_break(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    mgr.update(0, _snap(0, True, {"qz": {"reserved": 50, "peak": 0},
                                  "qa": {"reserved": 50, "peak": 0}}))
    victim = mgr.maybe_kill()
    assert victim == "qa"
    return victim


def test_killer_tie_breaks_lexicographically():
    both(_tie_break)


def _none_policy(E):
    mgr = E.cm.ClusterMemoryManager("none")
    mgr.update(0, _snap(0, True, {"qa": {"reserved": 50, "peak": 0}}))
    assert mgr.maybe_kill() is None
    mgr2 = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    mgr2.update(0, _snap(0, False, {"qa": {"reserved": 50, "peak": 0}}))
    assert mgr2.maybe_kill() is None
    with pytest.raises(E.TrinoError) as exc:
        E.cm.killer_for("bogus")
    return exc.value.code


def test_killer_none_policy_and_no_blocked_nodes():
    both(_none_policy)


def _fires_once(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    snap = _snap(0, True, {"qa": {"reserved": 70, "peak": 70}})
    mgr.update(0, snap)
    assert mgr.maybe_kill() == "qa"
    with pytest.raises(E.cm.QueryKilledError):
        mgr.check_killed("qa")           # flag consumed
    mgr.update(0, snap)                  # stale heartbeat, still blocked
    assert mgr.maybe_kill() is None      # no duplicate kill
    assert mgr.kill_count == 1
    return mgr.kill_count


def test_killer_fires_once_per_victim():
    both(_fires_once)


def _interleaved(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    mgr.update(0, _snap(0, True, {"qa": {"reserved": 70, "peak": 0}}))
    mgr.update(0, _snap(0, False, {"qa": {"reserved": 70, "peak": 0}}))
    victim = mgr.maybe_kill()
    assert victim == "qa"
    return victim


def test_blocked_delta_survives_interleaved_heartbeats():
    both(_interleaved)


def _not_latched(E):
    mgr = E.cm.ClusterMemoryManager("total-reservation-on-blocked-nodes")
    mgr.update(0, _snap(0, True, {}))     # blocked, nothing killable
    assert mgr.maybe_kill() is None
    mgr.update(0, _snap(0, False, {"qb": {"reserved": 50, "peak": 0}}))
    assert mgr.maybe_kill() is None
    assert mgr.kill_count == 0
    return mgr.kill_count


def test_blocked_signal_not_latched_past_a_no_victim_tick():
    both(_not_latched)


def _total_cap(E):
    mgr = E.cm.ClusterMemoryManager("none", query_max_total_bytes=100)
    mgr.update(0, _snap(0, False, {"qa": {"reserved": 80, "peak": 0}}))
    mgr.update(1, _snap(1, False, {"qa": {"reserved": 60, "peak": 0}}))
    assert mgr.maybe_kill() == "qa"  # 140 > 100 across nodes
    stats = mgr.cluster_stats()
    assert stats["kills"] == 1 and stats["workers"] == 2
    return stats


def test_query_max_total_memory_cap_kills():
    both(_total_cap)


# ------------------------------------------------ elastic membership ----


class _W:
    def __init__(self, port):
        self.addr = ("127.0.0.1", port)


def _ledger(E):
    C = E.cluster
    led = C.ClusterLedger()
    n1 = led.record_join(("127.0.0.1", 1), pid=11, reason="initial")
    n2 = led.record_join(("127.0.0.1", 2), pid=12, reason="initial")
    assert (n1.generation, n2.generation) == (1, 2)
    assert led.generation == 2
    led.mark_draining(n1.node_id)
    assert led.snapshot()[0].state == C.NODE_DRAINING
    assert led.record_retire(n1.node_id, "scale-down") is not None
    assert led.generation == 3
    assert led.record_retire(n1.node_id) is None
    assert led.generation == 3
    n3 = led.record_join(("127.0.0.1", 3), pid=13, reason="heal")
    assert n3.generation == 4
    states = [n.state for n in led.snapshot()]
    assert states == [C.NODE_RETIRED, C.NODE_ACTIVE, C.NODE_ACTIVE]
    assert led.counts() == (3, 1)
    return ([(n.node_id, n.state, n.generation, n.reason,
              n.retired_reason) for n in led.snapshot()], led.counts())


def test_ledger_generation_monotonic_over_churn():
    both(_ledger)


def _round_robin(E):
    ws = [_W(1), _W(2), _W(3)]
    picks = []
    for t in range(7):
        for up in (None, [], [("10.0.0.9", 5)]):
            w = E.cluster.place_task(t, 0, ws, upstream_addrs=up) \
                if up is not None else E.cluster.place_task(t, 0, ws)
            assert w is ws[t % 3]
            picks.append(ws.index(w))
    return picks


def test_place_task_degenerates_to_round_robin_without_topology():
    both(_round_robin)


def _upstream_holder(E):
    ws = [_W(1), _W(2), _W(3)]
    up = [("127.0.0.1", 2), ("127.0.0.1", 2), ("127.0.0.1", 3)]
    picks = [ws.index(E.cluster.place_task(t, 0, ws, upstream_addrs=up))
             for t in range(5)]
    assert picks == [1] * 5
    return picks


def test_place_task_prefers_upstream_holder():
    both(_upstream_holder)


def _ties(E):
    ws = [_W(1), _W(2), _W(3)]
    up = [("127.0.0.1", 1), ("127.0.0.1", 3)]
    picks = [ws.index(E.cluster.place_task(t, 0, ws, upstream_addrs=up))
             for t in range(3)]
    assert picks == [0, 2, 0]
    return picks


def test_place_task_breaks_score_ties_round_robin():
    both(_ties)


def _retry_rotates(E):
    ws = [_W(1), _W(2), _W(3)]
    up = [("127.0.0.1", 2)]
    picks = [ws.index(E.cluster.place_task(0, r, ws, upstream_addrs=up))
             for r in (1, 2)]
    assert picks == [1, 2]
    return picks


def test_place_task_retry_rotates_full_candidate_list():
    both(_retry_rotates)


def _mk(E, clock):
    return E.auto.Autoscaler(clock=lambda: clock[0])


def _hysteresis(E):
    clock = [0.0]
    a = _mk(E, clock)
    kw = dict(min_workers=2, max_workers=8, cooldown_s=10.0,
              up_queue_depth=1, down_idle_ticks=4)
    out = [a.tick(size=2, queued=3, running=2, **kw)]
    assert out[-1] is None  # one pressure tick is not enough
    out.append(a.tick(size=2, queued=3, running=2, **kw))
    assert out[-1] == {"direction": "up", "from": 2, "to": 4,
                       "reason": "queued=3"}
    out.append(a.tick(size=4, queued=3, running=4, **kw))
    out.append(a.tick(size=4, queued=3, running=4, **kw))
    assert out[-2:] == [None, None]  # cooldown
    clock[0] = 11.0
    out.append(a.tick(size=4, queued=3, running=4, **kw))
    assert out[-1]["to"] == 8  # doubles, capped at max
    clock[0] = 22.0
    out.append(a.tick(size=8, queued=9, running=8, **kw))
    out.append(a.tick(size=8, queued=9, running=8, **kw))
    assert out[-1] is None  # at max
    assert a.scale_ups == 2
    return out, a.snapshot()


def test_autoscaler_hysteresis_and_doubling():
    both(_hysteresis)


def _idle_down(E):
    clock = [0.0]
    a = _mk(E, clock)
    kw = dict(min_workers=2, max_workers=8, cooldown_s=5.0,
              up_queue_depth=1, down_idle_ticks=3)
    out = [a.tick(size=4, queued=0, running=0, **kw) for _ in range(2)]
    assert out == [None, None]
    out.append(a.tick(size=4, queued=0, running=0, **kw))
    assert out[-1] == {"direction": "down", "from": 4, "to": 3,
                       "reason": "idle 3 ticks"}
    clock[0] = 10.0
    out.append(a.tick(size=3, queued=0, running=0, **kw))
    out.append(a.tick(size=3, queued=0, running=1, **kw))  # reset
    out.append(a.tick(size=3, queued=0, running=0, **kw))
    out.append(a.tick(size=3, queued=0, running=0, **kw))
    out.append(a.tick(size=3, queued=0, running=0, **kw))
    assert out[-1]["to"] == 2
    clock[0] = 20.0
    for _ in range(10):
        out.append(a.tick(size=2, queued=0, running=0, **kw))
        assert out[-1] is None  # never below min
    assert a.scale_downs == 2
    return out, a.snapshot()


def test_autoscaler_idle_scale_down_one_at_a_time():
    both(_idle_down)


def _below_min(E):
    a = _mk(E, [0.0])
    d = a.tick(size=1, queued=0, running=0, min_workers=2,
               max_workers=8, cooldown_s=100.0, up_queue_depth=1,
               down_idle_ticks=4)
    assert d == {"direction": "up", "from": 1, "to": 2,
                 "reason": "below min_workers"}
    return d


def test_autoscaler_below_min_restores_immediately():
    both(_below_min)


def _blocked_pressure(E):
    a = _mk(E, [0.0])
    kw = dict(min_workers=1, max_workers=4, cooldown_s=0.0,
              up_queue_depth=5, down_idle_ticks=4)
    a.tick(size=2, queued=0, running=1, blocked_nodes=1, **kw)
    d = a.tick(size=2, queued=0, running=1, blocked_nodes=1, **kw)
    assert d["direction"] == "up" and "blocked_nodes" in d["reason"]
    return d


def test_autoscaler_blocked_nodes_count_as_pressure():
    both(_blocked_pressure)


def _replay(E):
    ticks = [dict(size=2, queued=q, running=r)
             for q, r in [(0, 0), (2, 1), (3, 2), (0, 1), (0, 0),
                          (0, 0), (0, 0), (0, 0)]]
    kw = dict(min_workers=1, max_workers=8, cooldown_s=0.0,
              up_queue_depth=1, down_idle_ticks=2)

    def run():
        clock = [0.0]
        a = _mk(E, clock)
        out = []
        for t in ticks:
            clock[0] += 1.0
            out.append(a.tick(**t, **kw))
        return out

    first = run()
    assert first == run()
    return first


def test_autoscaler_deterministic_replay():
    both(_replay)


# ------------------------------------------------------------- spool ----


def _rows(pages):
    return [r for p in pages for r in p.to_rows()]


def _spool_roundtrip(E, base):
    mgr = E.spool.FileSystemExchangeManager(base)
    sink0 = mgr.create_sink("q1", 0, task=0, n_partitions=2)
    sink1 = mgr.create_sink("q1", 0, task=1, n_partitions=2)
    p = E.Page.from_pylists([E.T.BIGINT, E.T.VARCHAR],
                            [[1, 2], ["a", "b"]])
    sink0.add(0, p)
    sink0.add(1, p)
    sink1.add(1, p)
    sink0.finish()
    sink1.finish()
    d = mgr.exchange_dir("q1", 0)
    part0 = [pg.to_rows() for pg in E.spool.read_spool(d, 0)]
    assert part0 == [p.to_rows()]
    part1 = E.spool.read_spool(d, 1)
    assert len(part1) == 2  # both tasks contributed
    files = sorted(os.listdir(d))
    blobs = [open(os.path.join(d, f), "rb").read() for f in files]
    mgr.remove_exchange("q1", 0)
    with pytest.raises(FileNotFoundError):
        E.spool.read_spool(d, 0)
    return part0, _rows(part1), files, blobs


def test_spool_roundtrip(tmp_path):
    # the spool files hold byte-equal serde frames in both engines
    both(lambda E: _spool_roundtrip(E, str(tmp_path / str(id(E)))))


def _cursor_resume(E, base):
    mgr = E.spool.FileSystemExchangeManager(base)
    sink = mgr.create_sink("q3", 0, task=0, n_partitions=1)
    pages = [E.Page.from_pylists([E.T.BIGINT, E.T.VARCHAR],
                                 [[i, i + 10], [f"s{i}", f"s{i + 10}"]])
             for i in range(3)]
    for p in pages:
        sink.add(0, p)
    sink.finish()
    d = mgr.exchange_dir("q3", 0)
    cur = E.spool.spool_task_cursor(d, 0, 0, start_page=2)
    got = []
    while True:
        p = cur.poll()
        if p is None and cur.at_end():
            break
        got.extend(p.to_rows())
    cur.close()
    assert got == pages[2].to_rows()
    return got


def test_spool_cursor_start_page_resumes_mid_stream(tmp_path):
    both(lambda E: _cursor_resume(E, str(tmp_path / str(id(E)))))


def _unfinished(E, base):
    mgr = E.spool.FileSystemExchangeManager(base)
    sink = mgr.create_sink("q2", 0, task=0, n_partitions=1)
    sink.add(0, E.Page.from_pylists([E.T.BIGINT], [[1]]))
    # no finish()
    seen = E.spool.read_spool(mgr.exchange_dir("q2", 0), 0)
    assert seen == []
    sink.abort()
    return seen


def test_unfinished_sink_not_visible(tmp_path):
    both(lambda E: _unfinished(E, str(tmp_path / str(id(E)))))


# ----------------------------------------------------- spool backend ----


def _page(E, i):
    return E.Page.from_pylists([E.T.BIGINT, E.T.VARCHAR],
                               [[i, i + 10], [f"s{i}", f"s{i + 10}"]])


def _object_roundtrip(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    first = be.put("q1/f0/t0/a0/p0.bin", b"hello")
    second = be.put("q1/f0/t0/a0/p0.bin", b"loser")
    assert (first, second) == (True, False)
    assert be.get("q1/f0/t0/a0/p0.bin") == b"hello"  # first wins
    assert be.exists("q1/f0/t0/a0/p0.bin")
    with pytest.raises(KeyError):
        be.get("q1/f0/t0/a0/p9.bin")
    return first, second


def test_object_roundtrip_and_first_publish_wins(tmp_path):
    both(lambda E: _object_roundtrip(E, str(tmp_path / str(id(E)))))


def _list_delete(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    be.put("q1/f0/t0/a0/p0.bin", b"x")
    be.put("q1/f0/t0/a0/p1.bin", b"y")
    be.put("q1/f1/t0/a0/p0.bin", b"z")
    listed = be.list("q1/f0/t0")
    assert listed == ["q1/f0/t0/a0/p0.bin", "q1/f0/t0/a0/p1.bin"]
    be.delete_prefix("q1/f0")
    assert be.list("q1/f0/t0") == []
    assert be.exists("q1/f1/t0/a0/p0.bin")  # sibling prefix untouched
    return listed


def test_list_and_delete_prefix(tmp_path):
    both(lambda E: _list_delete(E, str(tmp_path / str(id(E)))))


def _crc(E):
    frames = [b"frame-one", b"frame-two-longer"]
    blob = E.sb.frame_blob(frames)
    assert E.sb.unframe_blob(blob) == frames
    torn = bytearray(blob)
    torn[6] ^= 0x40
    with pytest.raises(E.spool.SpoolCorruption):
        E.sb.unframe_blob(bytes(torn))
    with pytest.raises(E.spool.SpoolCorruption):
        E.sb.unframe_blob(blob[:-3])
    return blob


def test_crc_framing_detects_corruption():
    both(_crc)


def _writer_commit(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    w = E.sb.SpooledTaskWriter(be, "q7", 1, 0, 0, n_partitions=2)
    pages = [_page(E, i) for i in range(3)]
    for p in pages:
        w.add(0, p)
    w.add(1, pages[0])
    assert E.sb.committed_attempt(be, "q7", 1, 0) is None
    assert w.commit() is True
    assert E.sb.committed_attempt(be, "q7", 1, 0) == 0
    cur = E.sb.open_committed_partition(be, "q7", 1, 0, 0)
    full = _rows(cur.pages())
    assert full == _rows(pages)
    cur2 = E.sb.open_committed_partition(be, "q7", 1, 0, 0, start_page=2)
    tail = _rows(cur2.pages())
    assert tail == pages[2].to_rows()
    blob = be.get(E.sb.partition_key("q7", 1, 0, 0, 0))
    return full, tail, blob


def test_task_writer_commit_marker_and_cursor(tmp_path):
    both(lambda E: _writer_commit(E, str(tmp_path / str(id(E)))))


def _commit_race(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    for attempt in (1, 0):  # later attempt commits first
        w = E.sb.SpooledTaskWriter(be, "q8", 0, 3, attempt,
                                   n_partitions=1)
        w.add(0, _page(E, attempt))
        assert w.commit() is True
    won = E.sb.committed_attempt(be, "q8", 0, 3)
    assert won == 0
    return won


def test_commit_race_lowest_attempt_wins(tmp_path):
    both(lambda E: _commit_race(E, str(tmp_path / str(id(E)))))


def _aborted(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    w = E.sb.SpooledTaskWriter(be, "q9", 0, 0, 0, n_partitions=1)
    w.add(0, _page(E, 1))
    w.abort()
    assert w.commit() is False
    assert E.sb.committed_attempt(be, "q9", 0, 0) is None
    assert be.list("q9") == []
    return be.list("q9")


def test_aborted_writer_publishes_nothing(tmp_path):
    both(lambda E: _aborted(E, str(tmp_path / str(id(E)))))


def _corrupt(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    w = E.sb.SpooledTaskWriter(be, "qa", 0, 0, 0, n_partitions=1)
    w.add(0, _page(E, 5))
    w.commit()
    key = E.sb.partition_key("qa", 0, 0, 0, 0)
    path = os.path.join(base, key)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    with pytest.raises(E.spool.SpoolCorruption) as exc:
        E.sb.BackendSpoolCursor(be, key).pages()
    return str(exc.value)


def test_corrupt_partition_object_is_loud(tmp_path):
    both(lambda E: _corrupt(E, str(tmp_path / str(id(E)))))


def _escape(E, base):
    be = E.sb.LocalFileSpoolBackend(base)
    with pytest.raises(ValueError) as exc:
        be.put("../escape", b"x")
    return str(exc.value)


def test_key_escape_rejected(tmp_path):
    both(lambda E: _escape(E, str(tmp_path / str(id(E)))))


def _key_shape(E):
    keys = (E.sb.attempt_key("q1", 2, 3, 1),
            E.sb.partition_key("q1", 2, 3, 1, 0), E.sb.COMMIT_MARKER)
    assert keys == ("q1/f2/t3/a1", "q1/f2/t3/a1/p0.bin", "COMMIT")
    return keys


def test_commit_marker_key_shape():
    both(_key_shape)
