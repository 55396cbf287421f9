"""Memory accounting and the spill tiers: the torch engine against the
JAX engine.

The local cases of tests/test_memory.py and tests/test_memory_governance.py
on the port. A query under a memory cap far below its state completes
when spill is on — revoking operators park their pages in host RAM
(``SpilledPage``) and, past ``spill_host_memory_bytes``, in CRC-framed
spill files (``DiskSpilledPage``) — and returns the JAX engine's rows; it
fails with EXCEEDED_LOCAL_MEMORY_LIMIT when spill is off. An ORDER BY over
a cap takes the bounded host sort whether spill is on or off. Spill files
are reaped when the query ends, the host tier is used before the disk
tier, over-limit demotion reaches other operators' page lists, and a
spill frame holds the same bytes in both engines and fails loudly when
corrupted.
"""

import os
import threading

import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from test_torch_tpch_q1 import _runners
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.exec import serde as jserde
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch import types as T
from trino_tpu_torch.block import DevicePage
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec import serde
from trino_tpu_torch.exec.memory import (DiskSpilledPage, MemoryExceededError,
                                         QueryMemoryPool, SpilledPage,
                                         device_page_bytes, spill_pages,
                                         spill_root)
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.types import TrinoError

AGG_SQL = ("select l_orderkey, sum(l_quantity) qty from lineitem "
           "group by l_orderkey order by qty desc, l_orderkey limit 10")
JOIN_SQL = ("select o_orderpriority, count(*) from orders o, lineitem l "
            "where o.o_orderkey = l.l_orderkey and l_quantity > 30 "
            "group by o_orderpriority order by o_orderpriority")
SORT_SQL = "select * from lineitem order by l_extendedprice, l_orderkey"

DISK = {"spill_enabled": True, "spill_to_disk_enabled": True,
        "spill_host_memory_bytes": 0}


def make_runner(**props):
    session = Session(catalog="tpch", schema="micro")
    session.properties.update(props)
    return P.LocalQueryRunner({"tpch": TpchConnector(page_rows=1024)},
                              session, desired_splits=8, device="cpu")


@pytest.fixture(scope="module")
def baselines():
    """The JAX engine's rows, unconstrained."""
    r = JRunner({"tpch": JConnector(page_rows=1024)},
                JSession(catalog="tpch", schema="micro"), desired_splits=8)
    return {sql: r.execute(sql).rows for sql in (AGG_SQL, JOIN_SQL,
                                                 SORT_SQL)}


def test_accounting_records_peak(baselines):
    res = make_runner().execute(AGG_SQL)
    mem = res.stats["memory"]
    assert res.rows == baselines[AGG_SQL]
    assert mem["peak_bytes"] > 0
    assert mem["spill_events"] == 0
    assert mem["reserved_bytes"] == 0  # everything released at finish


def test_low_cap_without_spill_fails():
    r = make_runner(query_max_memory_bytes=120_000, spill_enabled=False)
    with pytest.raises(TrinoError) as exc:
        r.execute(AGG_SQL)
    assert exc.value.code == "EXCEEDED_LOCAL_MEMORY_LIMIT"


@pytest.mark.parametrize("sql,cap", [(AGG_SQL, 600_000),
                                     (JOIN_SQL, 150_000)])
def test_low_cap_with_spill_completes(sql, cap, baselines):
    res = make_runner(query_max_memory_bytes=cap,
                      spill_enabled=True).execute(sql)
    assert res.rows == baselines[sql]
    mem = res.stats["memory"]
    assert mem["spill_events"] > 0 and mem["spilled_bytes"] > 0
    assert mem["peak_bytes"] <= cap
    assert "disk_spill_events" not in mem  # no disk tier asked for


def test_host_sort_under_low_cap_matches_device_sort(baselines):
    """A cap too small for the whole-input device sort takes the host
    sort (page-at-a-time download, lexsort, chunked re-upload): the
    same rows in the same order as the JAX engine's."""
    res = make_runner(query_max_memory_bytes=1_000_000,
                      spill_enabled=True).execute(SORT_SQL)
    assert res.stats["memory"]["spill_events"] > 0
    assert res.rows == baselines[SORT_SQL]


@pytest.mark.parametrize("cap", [3_000_000, 4_000_000])
def test_capped_order_by_without_spill_takes_host_sort(cap):
    """An ORDER BY over a memory cap with spill off: the JAX engine sees
    that the whole-input device sort will not fit and sorts on the host,
    which needs no spill; the port does the same (it used to reserve the
    device sort's transient and fail). All 59,814 tiny lineitem rows, in
    the JAX engine's order."""
    sql = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
           "order by l_extendedprice, l_orderkey, l_linenumber")
    jr, pr = _runners("tiny", {"query_max_memory_bytes": cap},
                      page_rows=4096)
    want = jr.execute(sql)
    got = pr.execute(sql)
    assert len(got.rows) == 59_814
    assert got.rows == want.rows
    assert got.stats["memory"]["spill_events"] == 0
    assert got.stats["memory"]["peak_bytes"] \
        == want.stats["memory"]["peak_bytes"] <= cap


@pytest.mark.parametrize("sql,cap", [(AGG_SQL, 600_000),
                                     (JOIN_SQL, 150_000),
                                     (SORT_SQL, 1_000_000)])
def test_disk_spill_oracle(sql, cap, baselines):
    """agg / join / sort forced through the disk tier
    (spill_host_memory_bytes=0 demotes every parked page) return the
    JAX engine's rows."""
    res = make_runner(query_max_memory_bytes=cap, **DISK).execute(sql)
    mem = res.stats["memory"]
    assert mem["spill_events"] > 0
    assert mem["disk_spill_events"] > 0, mem
    assert mem["disk_spilled_bytes"] > 0 and mem["disk_file_bytes"] > 0
    assert res.rows == baselines[sql]


def test_disk_spill_files_reaped_after_query(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    assert spill_root() == str(tmp_path)
    res = make_runner(query_max_memory_bytes=600_000,
                      **DISK).execute(AGG_SQL)
    assert res.stats["memory"]["disk_spill_events"] > 0
    root = os.path.join(str(tmp_path), str(os.getpid()))
    assert os.path.isdir(root)  # the query did write there
    leftovers = [f for d in os.listdir(root)
                 for f in os.listdir(os.path.join(root, d))]
    assert leftovers == []


def test_host_tier_preferred_until_ledger_full(baselines):
    """With a roomy host budget the disk tier stays cold — the tiers are
    ordered, not parallel."""
    res = make_runner(query_max_memory_bytes=600_000, spill_enabled=True,
                      spill_to_disk_enabled=True,
                      spill_host_memory_bytes=1 << 30).execute(AGG_SQL)
    mem = res.stats["memory"]
    assert mem["spill_events"] > 0
    assert mem["disk_spill_events"] == 0
    assert res.rows == baselines[AGG_SQL]


def test_local_explain_analyze_shows_disk_spill():
    res = make_runner(query_max_memory_bytes=600_000,
                      **DISK).execute("explain analyze " + AGG_SQL)
    text = "\n".join(row[0] for row in res.rows)
    assert "disk" in text and "spills" in text


# ------------------------------------------------------- the pool ----


def test_pool_revokes_largest_first():
    pool = QueryMemoryPool(1000, spill_enabled=True)
    order = []
    a = pool.create_context("a")
    b = pool.create_context("b")
    a.set_revoke_callback(lambda: order.append("a") or 600)
    b.set_revoke_callback(lambda: order.append("b") or 300)
    a.reserve(600)
    b.reserve(300)
    c = pool.create_context("c")
    c.reserve(500)  # must revoke a (largest) to fit
    assert order == ["a"]
    assert pool.reserved == 300 + 500
    assert pool.spill_events == 1


def test_pool_raises_when_spill_disabled():
    pool = QueryMemoryPool(100, spill_enabled=False)
    ctx = pool.create_context("x")
    ctx.reserve(90)
    with pytest.raises(MemoryExceededError):
        ctx.reserve(20)


def test_fault_revocation_keeps_rows(baselines):
    """Injected revocation (every 2nd reservation revokes everything
    revocable) parks the aggregation's partials mid-stream, with no cap
    pressure at all; the rows do not move."""
    from trino_tpu_torch.exec import memory

    orig = memory.pool_from_session

    def fault_pool(session, query_id="q"):
        pool = orig(session, query_id)
        pool.fault_revoke_countdown = 2
        return pool

    memory.pool_from_session = fault_pool
    try:
        res = make_runner(query_max_memory_bytes=1 << 30,
                          spill_enabled=True).execute(AGG_SQL)
    finally:
        memory.pool_from_session = orig
    assert res.stats["memory"]["spill_events"] > 0
    assert res.rows == baselines[AGG_SQL]


def _device_page(rows: int, live: int = None):
    live = rows if live is None else live
    return DevicePage([T.BIGINT], [torch.arange(rows, dtype=torch.int64)],
                      [torch.zeros(rows, dtype=torch.bool)],
                      torch.arange(rows) < live, [None])


def test_device_page_bytes():
    # 16*8 data + 16 nulls + 16 valid, for the page and its parked copy
    page = _device_page(16)
    assert device_page_bytes(page) == 16 * 8 + 16 + 16
    assert device_page_bytes(SpilledPage(page)) == 16 * 8 + 16 + 16


def test_spilled_page_compacts_and_returns_to_its_device():
    page = DevicePage(
        [T.BIGINT, T.DOUBLE],
        [torch.arange(64, dtype=torch.int64),
         torch.linspace(0, 1, 64, dtype=torch.float64)],
        [torch.zeros(64, dtype=torch.bool), torch.arange(64) % 5 == 0],
        torch.arange(64) % 3 == 0, [None, None])
    sp = SpilledPage(page)
    assert sp.capacity == 32 and int(sp.valid.sum()) == 22
    back = sp.to_device()
    assert back.device == page.device
    keep = page.valid.numpy()
    assert np.array_equal(back.cols[0][:22].numpy(),
                          page.cols[0].numpy()[keep])
    assert np.array_equal(back.nulls[1][:22].numpy(),
                          page.nulls[1].numpy()[keep])
    assert not back.valid[22:].any()


# ------------------------------------------------- spill frame serde ----


def _arrays():
    cols = [np.arange(64, dtype=np.int64),
            np.linspace(0, 1, 64).astype(np.float64),
            np.arange(64, dtype=np.int32)]
    nulls = [np.zeros(64, dtype=bool), (np.arange(64) % 7 == 0),
             np.ones(64, dtype=bool)]
    valid = np.arange(64) < 50
    return cols, nulls, valid


@pytest.mark.parametrize("compress", [True, False])
def test_spill_frame_bytes_equal_jax(compress):
    cols, nulls, valid = _arrays()
    assert serde.spill_frame(cols, nulls, valid, compress) \
        == jserde.spill_frame(cols, nulls, valid, compress)
    # and each engine reads the other's frame
    c, n, v = jserde.parse_spill_frame(
        serde.spill_frame(cols, nulls, valid, compress))
    assert all(np.array_equal(a, b) for a, b in zip(c + n + [v],
                                                    cols + nulls + [valid]))


def test_spill_frame_roundtrip(tmp_path):
    cols, nulls, valid = _arrays()
    c2, n2, v2 = serde.parse_spill_frame(serde.spill_frame(cols, nulls,
                                                           valid))
    for a, b in zip(cols + nulls + [valid], c2 + n2 + [v2]):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
    path = str(tmp_path / "s.bin")
    serde.write_spill_file(path, cols, nulls, valid)
    assert not os.path.exists(path + ".tmp")  # atomic: no temp residue
    assert open(path, "rb").read() == serde.spill_frame(cols, nulls, valid)
    c3, _, v3 = serde.read_spill_file(path)
    assert np.array_equal(c3[0], cols[0]) and np.array_equal(v3, valid)


def test_spill_file_streaming_read_write(tmp_path):
    """Frames larger than one streaming chunk round-trip, the arrays come
    back writable, and a corrupted or torn file fails loudly."""
    cols = [np.arange(serde._SPILL_CHUNK // 4 + 7, dtype=np.int64)]
    nulls = [np.zeros(len(cols[0]), dtype=bool)]
    valid = np.arange(len(cols[0])) < 50
    path = str(tmp_path / "big.bin")
    serde.write_spill_file(path, cols, nulls, valid)
    c1, _, _ = serde.parse_spill_frame(open(path, "rb").read())
    assert np.array_equal(c1[0], cols[0])
    c2, _, v2 = serde.read_spill_file(path)
    assert np.array_equal(c2[0], cols[0]) and np.array_equal(v2, valid)
    assert c2[0].flags.writeable
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(TrinoError):
        serde.read_spill_file(path)
    with open(path, "wb") as f:
        f.write(serde.spill_frame(cols, nulls, valid)[: len(blob) // 2])
    with pytest.raises(TrinoError):
        serde.read_spill_file(path)


def test_spill_frame_detects_corruption():
    cols, nulls, valid = _arrays()
    frame = bytearray(serde.spill_frame(cols, nulls, valid))
    frame[20] ^= 0xFF  # flip a body byte: CRC must catch it
    with pytest.raises(TrinoError):
        serde.parse_spill_frame(bytes(frame))
    with pytest.raises(TrinoError):
        serde.parse_spill_frame(frame[: len(frame) // 2])  # torn frame


def test_disk_spilled_page_roundtrip():
    pool = QueryMemoryPool(1 << 20, spill_enabled=True, spill_to_disk=True,
                           host_spill_limit=0)
    pages = [_device_page(32, live=20)]
    freed = spill_pages(pages, pool)
    assert freed > 0
    assert isinstance(pages[0], DiskSpilledPage)
    path = pages[0].path
    assert os.path.exists(path)
    back = pages[0].to_device()
    assert np.array_equal(back.cols[0][:20].numpy(), np.arange(20))
    assert int(back.valid.sum()) == 20
    assert pool.host_ledger.resident_bytes == 0
    pool.close()
    assert not os.path.exists(path)


def test_corrupted_spill_file_raises_on_reload():
    """A parked page whose file was damaged raises when it is read back
    (nothing retries the query without spill)."""
    pool = QueryMemoryPool(1 << 20, spill_enabled=True, spill_to_disk=True,
                           host_spill_limit=0)
    pages = [_device_page(64)]
    spill_pages(pages, pool)
    with open(pages[0].path, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(TrinoError):
        pages[0].to_device()
    pool.close()


def test_ledger_demotes_across_operator_lists():
    """When the spilling operator's own list cannot bring the ledger
    under its limit, the largest parked pages of other tracked lists
    demote — the last spiller is rarely the biggest holder."""
    pool = QueryMemoryPool(1 << 30, spill_enabled=True, spill_to_disk=True,
                           host_spill_limit=1 << 30)
    ca = pool.create_context("a-agg")
    cb = pool.create_context("b-join")
    a_pages = [_device_page(4096), _device_page(4096)]
    with ca.lock:
        spill_pages(a_pages, pool, ca.lock)
    assert all(type(p) is SpilledPage for p in a_pages)
    # tighten the limit, then operator B spills a small page: its own
    # list cannot cover the overage
    pool.host_ledger.limit_bytes = 1024
    b_pages = [_device_page(32)]
    with cb.lock:
        spill_pages(b_pages, pool, cb.lock)
    assert any(isinstance(p, DiskSpilledPage) for p in a_pages), \
        "demotion never reached the other operator's list"
    assert pool.host_ledger.cross_list_demotions >= 1
    back = next(p for p in a_pages if isinstance(p, DiskSpilledPage))
    assert os.path.exists(back.path)
    assert int(back.to_device().valid.sum()) == 4096
    pool.close()
    assert not pool.host_ledger._tracked


def test_ledger_cross_list_skips_busy_foreign_locks():
    """A foreign operator holding its context lock is skipped, never
    blocked on: two spilling operators cannot deadlock."""
    pool = QueryMemoryPool(1 << 30, spill_enabled=True, spill_to_disk=True,
                           host_spill_limit=1 << 30)
    ca = pool.create_context("a-op")
    cb = pool.create_context("b-op")
    a_pages = [_device_page(4096)]
    with ca.lock:
        spill_pages(a_pages, pool, ca.lock)
    pool.host_ledger.limit_bytes = 64
    held, release = threading.Event(), threading.Event()

    def hold_a():
        with ca.lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=hold_a)
    t.start()
    assert held.wait(5)
    b_pages = [_device_page(32)]
    with cb.lock:
        spill_pages(b_pages, pool, cb.lock)  # must return, not deadlock
    assert not isinstance(a_pages[0], DiskSpilledPage)  # skipped
    release.set()
    t.join(5)
    assert not t.is_alive()
    pool.close()
