"""The wire of the multi-process runtime: the torch engine's page serde,
RPC framing and fault taxonomy against the JAX engine's.

- Page frames: three seeded pages with nulls in every column (BIGINT,
  INTEGER, DECIMAL at the short and the widest precision the engines
  hold, DATE, DOUBLE with NaN and +-0.0, TIMESTAMP WITH TIME ZONE,
  VARCHAR from two pools, one channel switching to a third pool on the
  last page, and the pooled composites ARRAY, ROW and MAP, one holding
  DECIMALs), built from the same Python values in each engine and sent
  down one serializer stream, so later pages ship pool deltas: every
  frame is byte-equal to the JAX ``PageSerializer``'s, and each engine
  decodes the other's stream to the same rows, the pools rebuilt from
  the deltas.
- A ``DevicePage`` (on the CPU) with a quarter of its lanes live, in a
  seeded scatter, serializes (through ``DevicePage.to_page``, which
  compacts on the device) to the bytes of its compacted host page.
- RPC: messages and frames round trip over a socket pair with the JAX
  engine's bytes on the wire; ``call`` reaches an in-process worker.
- ``fault.py``: ``classify_error_code``, ``classify_exception``,
  ``serialize_failure``, ``RemoteTaskError.from_response``, the
  ``BackoffPolicy`` sequence under one seed, ``Deadline``, ``FaultSchedule``
  matching and ``RecoveryStats`` equal the JAX engine's.
"""

import math
import pickle
import socket
from decimal import Decimal

import numpy as np
import pytest

import trino_tpu.parallel.fault as jf
import trino_tpu.parallel.rpc as jrpc
import trino_tpu_torch.parallel.fault as pf
import trino_tpu_torch.parallel.rpc as prpc
from trino_tpu import types as JT
from trino_tpu.block import Dictionary as JDict
from trino_tpu.block import Page as JPage
from trino_tpu.exec.serde import PageDeserializer as JDe
from trino_tpu.exec.serde import PageSerializer as JSer
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import DevicePage
from trino_tpu_torch.block import Dictionary as PDict
from trino_tpu_torch.block import Page as PPage
from trino_tpu_torch.exec.serde import PageDeserializer as PDe
from trino_tpu_torch.exec.serde import PageSerializer as PSer
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss


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


def _types(T):
    return [T.BIGINT, T.INTEGER, T.decimal_type(12, 2),
            T.decimal_type(18, 4), T.DATE, T.DOUBLE,
            T.timestamp_tz_type("America/New_York"),
            T.VARCHAR, T.VARCHAR,
            T.array_type(T.BIGINT),
            T.row_type([(None, T.BIGINT), (None, T.VARCHAR)]),
            T.map_type(T.VARCHAR, T.decimal_type(10, 2))]


def _columns(seed: int, n: int):
    """Python values of every channel, from a seed; ~1 in 5 NULL."""
    rng = np.random.default_rng(seed)
    null = rng.random((12, n)) < 0.2

    def col(i, make):
        return [None if null[i, r] else make(r) for r in range(n)]

    doubles = [float("nan"), 0.0, -0.0, 1.5e300, -2.25]
    return [
        col(0, lambda r: int(rng.integers(-2**62, 2**62))),
        col(1, lambda r: int(rng.integers(-2**31, 2**31))),
        col(2, lambda r: Decimal(int(rng.integers(-10**11, 10**11)))
            .scaleb(-2)),
        col(3, lambda r: Decimal(int(rng.integers(-10**17, 10**17)))
            .scaleb(-4)),
        col(4, lambda r: int(rng.integers(-20000, 40000))),
        col(5, lambda r: doubles[r % 5] if r < 5
            else float(rng.normal() * 1e6)),
        col(6, lambda r: int(rng.integers(0, 2**50))),
        col(7, lambda r: f"a{seed}-{int(rng.integers(0, 6))}"),
        col(8, lambda r: f"b{int(rng.integers(0, 40))}"),
        col(9, lambda r: tuple(int(x) for x in
                               rng.integers(0, 9, rng.integers(0, 4)))),
        col(10, lambda r: (int(rng.integers(0, 5)),
                           f"r{int(rng.integers(0, 3))}")),
        col(11, lambda r: {f"k{int(rng.integers(0, 3))}":
                           Decimal(int(rng.integers(0, 999))).scaleb(-2)}),
    ]


def _page_stream(T, Page, Dictionary):
    """Three pages: channels 7 and 8 hold pools A and B that grow page
    by page; on the third page channel 8 switches to a fresh pool C."""
    pools = {"a": Dictionary(), "b": Dictionary(), "c": Dictionary(),
             9: Dictionary(), 10: Dictionary(), 11: Dictionary()}
    pages = []
    for seed, n in ((1, 37), (2, 64), (3, 5)):
        dicts = [None] * 7 + [pools["a"],
                              pools["c"] if seed == 3 else pools["b"],
                              pools[9], pools[10], pools[11]]
        pages.append(Page.from_pylists(_types(T), _columns(seed, n),
                                       dictionaries=dicts))
    return pages


def _rows(pages):
    return [tuple("nan" if isinstance(v, float) and math.isnan(v)
                  else (v, math.copysign(1.0, v)) if isinstance(v, float)
                  else v for v in row)
            for p in pages for row in p.to_rows()]


def test_frames_byte_equal_to_jax():
    jpages = _page_stream(JT, JPage, JDict)
    ppages = _page_stream(PT, PPage, PDict)
    assert _rows(ppages) == _rows(jpages)
    jser, pser = JSer(), PSer()
    jframes = [jser.serialize(p) for p in jpages]
    pframes = [pser.serialize(p) for p in ppages]
    for i, (pf_, jf_) in enumerate(zip(pframes, jframes)):
        assert pf_ == jf_, f"frame {i} differs"
    # later pages carry pool deltas, not the whole pools again
    assert len(pframes[2]) < len(pframes[1])


def test_each_engine_decodes_the_others_frames():
    jpages = _page_stream(JT, JPage, JDict)
    ppages = _page_stream(PT, PPage, PDict)
    jser, pser = JSer(), PSer()
    jframes = [jser.serialize(p) for p in jpages]
    pframes = [pser.serialize(p) for p in ppages]
    jde, pde = JDe(), PDe()
    from_port = [jde.deserialize(f) for f in pframes]
    from_jax = [pde.deserialize(f) for f in jframes]
    assert _rows(from_port) == _rows(jpages)
    assert _rows(from_jax) == _rows(ppages)
    for got, want in ((from_jax, ppages), (from_port, jpages)):
        for g, w in zip(got, want):
            assert [str(b.type) for b in g.blocks] == \
                [str(b.type) for b in w.blocks]
    # the receiver rebuilt one pool per (channel, pool id) from deltas
    assert from_jax[1].blocks[7].dictionary is \
        from_jax[0].blocks[7].dictionary
    assert from_jax[2].blocks[8].dictionary is not \
        from_jax[1].blocks[8].dictionary
    # and re-serializing the decoded pages reproduces the stream
    again = PSer()
    assert [again.serialize(p) for p in from_jax] == pframes


def test_device_page_quarter_live_serializes_as_compacted_page():
    """Compaction happens on the device (``DevicePage.live_lanes``)
    before the one host copy; the frame equals the compacted host
    page's, and the JAX engine's frame of that host page."""
    import torch

    n = 256
    host = PPage.from_pylists(_types(PT), _columns(7, n),
                              dictionaries=[None] * 7 + [PDict()
                                                         for _ in range(5)])
    dev = DevicePage.from_page(host, "cpu")
    live = np.zeros(n, dtype=bool)
    live[np.random.default_rng(11).choice(n, n // 4, replace=False)] = True
    dev.valid = torch.from_numpy(live)
    keep = np.nonzero(live)[0]
    blocks = []
    from trino_tpu_torch.block import Block

    for b in host.blocks:
        b = b.numpy()
        nl = b.nulls[keep] if b.nulls is not None else None
        blocks.append(Block(b.type, b.data[keep],
                            nl if nl is not None and nl.any() else None,
                            b.dictionary))
    compacted = PPage(blocks, len(keep))
    frame = PSer().serialize(dev.to_page())
    assert frame == PSer().serialize(compacted)
    assert PDe().deserialize(frame).num_rows == n // 4
    # the JAX engine writes the same bytes for the same host page
    jhost = JPage.from_pylists(
        _types(JT), _columns(7, n),
        dictionaries=[None] * 7 + [JDict() for _ in range(5)])
    jblocks = []
    from trino_tpu.block import Block as JBlock

    for b in jhost.blocks:
        b = b.numpy()
        nl = b.nulls[keep] if b.nulls is not None else None
        jblocks.append(JBlock(b.type, b.data[keep],
                              nl if nl is not None and nl.any() else None,
                              b.dictionary))
    assert JSer().serialize(JPage(jblocks, len(keep))) == frame


# ---------------------------------------------------------------- rpc ----


def _wire(send, payload):
    a, b = socket.socketpair()
    try:
        send(a, payload)
        a.shutdown(socket.SHUT_WR)
        raw = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
        return raw
    finally:
        a.close()
        b.close()


def test_rpc_framing_round_trips():
    msg = {"op": "run_task", "task_id": "q1a0.f1.t0.r0", "rows": 3,
           "nested": [1.5, None, {"k": b"\x00\xff"}]}
    frame = b"\x01" * 70000  # larger than one socket read
    for mod in (prpc, jrpc):
        a, b = socket.socketpair()
        try:
            mod.send_msg(a, msg)
            mod.send_frame(a, frame)
            assert mod.recv_msg(b) == msg
            assert mod.recv_frame(b) == frame
            a.close()
            with pytest.raises(ConnectionError):
                mod.recv_msg(b)  # peer closed mid-frame
        finally:
            b.close()
    # the same bytes on the wire as the JAX engine's
    assert _wire(prpc.send_msg, msg) == _wire(jrpc.send_msg, msg)
    assert _wire(prpc.send_frame, frame) == _wire(jrpc.send_frame, frame)
    assert pickle.loads(_wire(prpc.send_msg, msg)[4:]) == msg


def test_rpc_call_reaches_a_worker_and_with_trace():
    import threading

    from trino_tpu_torch.parallel.worker import WorkerServer
    from trino_tpu_torch.telemetry.tracing import NULL_SPAN, Tracer

    w = WorkerServer(0, "cpu")
    th = threading.Thread(target=w.serve_forever, daemon=True)
    th.start()
    try:
        resp = prpc.call(("127.0.0.1", w.port), {"op": "ping"},
                         timeout=30)
        assert resp["ok"] and resp["tasks"] == 0 and resp["memory"] is None
        resp = prpc.call(("127.0.0.1", w.port), {"op": "nope"}, timeout=30)
        assert "unknown op" in resp["error"]
    finally:
        w.server.shutdown()
        w.server.server_close()
        th.join(timeout=10)
    assert not th.is_alive()
    # the null span adds nothing; a real span adds its context
    assert prpc.with_trace({"op": "x"}, NULL_SPAN) == {"op": "x"}
    span = Tracer(process="coordinator").span("query")
    req = prpc.with_trace({"op": "x"}, span, attempt=1)
    assert req["trace"]["attempt"] == 1 and "trace_id" in req["trace"]


# -------------------------------------------------------------- fault ----


CODES = ["GENERIC_INTERNAL_ERROR", "PAGE_TRANSPORT_ERROR",
         "REMOTE_TASK_ERROR", "NO_NODES_AVAILABLE",
         "EXCEEDED_LOCAL_MEMORY_LIMIT", "EXCEEDED_NODE_MEMORY",
         "EXCEEDED_CLUSTER_MEMORY", "DIVISION_BY_ZERO",
         "EXCEEDED_TIME_LIMIT", "NOT_SUPPORTED", "SYNTAX_ERROR"]


def test_classification_equals_jax():
    assert [pf.classify_error_code(c) for c in CODES] == \
        [jf.classify_error_code(c) for c in CODES]
    assert (pf.USER, pf.INTERNAL, pf.EXTERNAL,
            pf.INSUFFICIENT_RESOURCES) == (jf.USER, jf.INTERNAL,
                                           jf.EXTERNAL,
                                           jf.INSUFFICIENT_RESOURCES)
    from trino_tpu.types import TrinoError as JErr
    from trino_tpu_torch.parallel.spool import SpoolCorruption as PSC
    from trino_tpu_torch.types import TrinoError as PErr
    from trino_tpu.parallel.spool import SpoolCorruption as JSC

    def excs(Err, SC, mod):
        return [Err("x", "DIVISION_BY_ZERO"),
                Err("x", "EXCEEDED_NODE_MEMORY"),
                Err("x", "GENERIC_INTERNAL_ERROR"), MemoryError(),
                ConnectionResetError(), OSError(), EOFError(),
                SC("torn"), RuntimeError("boom"), ValueError(),
                mod.RemoteTaskError("r", mod.USER, "DIVISION_BY_ZERO")]

    assert [pf.classify_exception(e) for e in excs(PErr, PSC, pf)] == \
        [jf.classify_exception(e) for e in excs(JErr, JSC, jf)]
    assert [pf.is_retryable(t) for t in pf.ERROR_TYPES] == \
        [jf.is_retryable(t) for t in jf.ERROR_TYPES]


def test_serialize_failure_equals_jax():
    from trino_tpu.types import TrinoError as JErr
    from trino_tpu_torch.types import TrinoError as PErr

    def fail(Err, mod):
        out = []
        for exc in (Err("division by zero", "DIVISION_BY_ZERO"),
                    RuntimeError("injected failure for task q1a0.f0.t0"),
                    mod.RemoteTaskError("lost", mod.EXTERNAL,
                                        "PAGE_TRANSPORT_ERROR",
                                        connection_lost=True)):
            try:
                raise exc
            except Exception as e:
                d = mod.serialize_failure(e)
            d.pop("remote_traceback")  # names each engine's files
            out.append(d)
        return out

    got, want = fail(PErr, pf), fail(JErr, jf)
    assert got == want
    resp = dict(want[2], remote_traceback="tb")
    a = pf.RemoteTaskError.from_response(resp, "task t failed")
    b = jf.RemoteTaskError.from_response(resp, "task t failed")
    assert (str(a), a.error_type, a.error_code, a.connection_lost,
            a.retry_scope) == (str(b), b.error_type, b.error_code,
                               b.connection_lost, b.retry_scope)


def test_backoff_deadline_and_recovery_equal_jax():
    seed = jf.BackoffPolicy.seed_for("q7")
    assert pf.BackoffPolicy.seed_for("q7") == seed
    for kw in ({}, {"initial": 0.01, "maximum": 0.5, "jitter": 0.4}):
        p = pf.BackoffPolicy(seed=seed, **kw)
        j = jf.BackoffPolicy(seed=seed, **kw)
        assert [p.delay(a) for a in range(12)] == \
            [j.delay(a) for a in range(12)]
    assert pf.Deadline(0).rpc_timeout(5.0) == 5.0
    d = pf.Deadline(1e-9)
    with pytest.raises(Exception) as exc:
        d.rpc_timeout(5.0)
    assert exc.value.code == "EXCEEDED_TIME_LIMIT"
    assert pf.classify_error_code(exc.value.code) == pf.USER
    stats = []
    for mod in (pf, jf):
        r = mod.RecoveryStats()
        r.incr("task_attempts", 3)
        r.record_retry(mod.EXTERNAL)
        r.record_retry(mod.INSUFFICIENT_RESOURCES, query_level=True)
        total = mod.RecoveryStats()
        total.merge(r)
        total.merge(r)
        f = mod.DecayingFailureStats(half_life_s=10.0)
        f.record(now=0.0)
        f.record(now=10.0)
        stats.append((total.to_dict(), f.score(now=20.0), f.total))
    assert stats[0] == stats[1]


def test_fault_schedule_matching_equals_jax():
    def run(mod):
        s = mod.FaultSchedule(seed=5)
        s.add("q3a0.f1", "kill-worker")
        s.add("q3a0.f0.t1", "delay", times=2, delay_s=2.0)
        s.add("q4", "user-error", error_code="NUMERIC_VALUE_OUT_OF_RANGE")
        s.add("q5a0.f2", "revoke-memory", countdown=4)
        s.add("q6", "drop-connection", times=3)
        launches = ["q3a0.f0.t0.r0", "q3a0.f0.t1.r0", "q3a0.f1.t0.r0",
                    "q3a0.f1.t1.r0", "q3a0.f0.t1.r1", "q3a0.f0.t1.spec",
                    "q4a0.f0.t0.s", "q4a1.f0.t0.s", "q5a0.f2.t0.r0",
                    "q6a0.f0.t0.s", "q6a0.f0.t1.s"]
        out = [s.match(t) for t in launches]
        return out, s.pending(), s.armed()

    assert run(pf) == run(jf)
    assert pf.FAULT_KINDS == jf.FAULT_KINDS
    with pytest.raises(ValueError):
        pf.FaultSchedule().add("q1", "melt-down")
