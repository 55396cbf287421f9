"""History-based runtime statistics: per-plan-node actuals that close
the loop into the cost model.

Reference analog: Presto/Trino history-based optimization ("Presto: A
Decade of SQL Analytics at Meta", PAPERS.md — HistoryBasedPlanStatistics
keyed by canonical plan fingerprints).  The engine already *observes*
everything (operator stats, the program profiler) but the optimizer runs
off connector NDV/min-max guesses; this module records what each plan
node ACTUALLY produced and serves it back to every cost rule:

- keyed by ``(statement shape fingerprint, canonical plan-node
  fingerprint)`` — the shape comes from ``cache.normalize_statement``
  (literals parameterized out), and the node fingerprint likewise
  canonicalizes literal values and pushed-down domain bounds away, so
  ``k = 5`` and ``k = 9`` share one history stream;
- EWMA-merged across runs (one outlier run cannot wreck a converged
  history; first run seeds the value exactly);
- invalidated by the same connector ``data_version()`` snapshots the
  plan cache keys on: a DDL/write moves the snapshot and the whole
  statement's history drops loudly instead of steering plans from
  stale data;
- persisted to a JSON sidecar (``hbo_store_path``) so history survives
  process restarts; a corrupt sidecar warns LOUDLY and starts empty
  (never a silent half-load).

Consumers: ``planner.stats.StatsCalculator`` (history beats connector
estimates — ``PlanStats.source`` says which won), the join/agg strategy
rules, adaptive partial aggregation seeding, admission/retry memory
sizing, live-progress fallback, ``system.runtime.plan_stats``, and the
``trino_hbo_*`` metric families.

Recording happens on the host, after the drivers finish, never inside
a device program.

The JAX engine's ``trino_tpu/telemetry/stats_store.py``, copied: the same
fingerprints, so one statement keys the same history in both engines,
and the same sidecar format. The torch engine's process keeps a store of
its own (``store()``), apart from the JAX engine's.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
import warnings
from collections import OrderedDict
from dataclasses import dataclass, fields, is_dataclass
from typing import Dict, Iterable, List, Optional

#: EWMA weight of the newest observation (first observation seeds the
#: value exactly); ``hbo_ewma_alpha`` overrides per session
DEFAULT_EWMA_ALPHA = 0.4

#: Q-error at or above which a recorded actual on a DECISION node
#: (join input, grouped aggregation) is worth a replan — the threshold
#: that invalidates cached plans of the statement shape
MATERIAL_QERROR = 2.0

#: statements the store retains (LRU); nodes ride their statement
MAX_STATEMENTS = 256

#: misestimate histogram bucket upper bounds (Q-error is >= 1.0)
QERROR_BUCKETS = (1.5, 2.0, 4.0, 8.0, 16.0, 64.0, 256.0, float("inf"))


def q_error(estimate: float, actual: float) -> float:
    """The classic symmetric estimation error max(e/a, a/e), floored at
    one row on both sides so empty results stay finite."""
    e = max(float(estimate), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)


# -- fingerprints ----------------------------------------------------------


def statement_fingerprint(shape) -> str:
    """Stable digest of a normalized statement shape (the frozen AST
    ``cache.normalize_statement`` returns) — the statement half of
    every history key."""
    return hashlib.sha1(repr(shape).encode()).hexdigest()[:16]


def snapshot_key(snapshot_fp) -> str:
    """Canonical string form of a connector-snapshot fingerprint (the
    plan cache's ``snapshot_fingerprint`` tuple) — JSON-safe, so the
    sidecar roundtrip compares equal."""
    return repr(snapshot_fp)


#: plan-node fields the fingerprint must NOT see: the strategy fields
#: are what history itself flips (a flip must not orphan the history
#: that caused it), and partial-step state symbols are an exchange-
#: planning artifact
_SKIP_NODE_FIELDS = {"strategy", "strategy_detail", "state_symbols"}

#: aggregation/ranking step canonicalization: exchange planning splits
#: a ``single`` node into ``partial`` + ``final`` AFTER the optimizer
#: ran, so the single-step node the cost rules consult must share its
#: fingerprint with the final-step node the executed operator records
#: under (partial output is a different quantity — it keeps its own)
_CANON_STEP = {"single": "grouped", "final": "grouped",
               "partial": "partial"}


def plan_node_fp(node) -> str:
    """Canonical fingerprint of one plan node: its own salient fields,
    with literal VALUES and pushed-down domain BOUNDS canonicalized
    away (every literal vector of a statement shape maps onto the same
    history stream) and CHILDREN EXCLUDED — exchange planning rewrites
    children after the optimizer consulted history, so a child-
    recursive fingerprint would orphan every distributed actual.
    Node-local fields (table + columns, predicate/assignment structure,
    join criteria, group keys) disambiguate in practice; identical
    twin nodes (a self-join of one table over identical column sets)
    merge their histories — the recorded value is then their sum."""
    return hashlib.sha1(repr(_canon_node(node)).encode()).hexdigest()[:16]


def _canon_node(node) -> tuple:
    out: List[object] = [type(node).__name__]
    for f in fields(node):
        if f.name in _SKIP_NODE_FIELDS:
            continue
        v = getattr(node, f.name)
        if f.name == "step" and isinstance(v, str):
            v = _CANON_STEP.get(v, v)
        if f.name == "criteria" and isinstance(v, (list, tuple)):
            # Join commutation (HBO actuals flipping which side is
            # smaller) swaps every (probe, build) criteria pair; the
            # commuted join is the same logical node, so order within
            # a pair — and among pairs — must not move its history.
            out.append((f.name, tuple(sorted(
                tuple(sorted(_canon_value(s) for s in pair))
                if isinstance(pair, (list, tuple)) else _canon_value(pair)
                for pair in v))))
            continue
        out.append((f.name, _canon_value(v)))
    return tuple(out)


#: canonical forms of frozen dataclass values (symbols, types, row
#: expressions), by identity: the join-order search prices thousands of
#: candidate join nodes built over the same symbols and expressions, and
#: each consults history by fingerprint. An entry holds its value, so
#: the id cannot be reused while it is cached; bounded by clearing.
_CANON_MEMO: Dict[int, tuple] = {}
_CANON_MEMO_MAX = 1 << 16


@functools.lru_cache(maxsize=None)
def _canon_classes() -> tuple:
    """(PlanNode, Literal, Domain), imported on first use (the planner
    imports this module)."""
    from ..expr.ir import Literal
    from ..planner.plan import PlanNode
    from ..predicate import Domain

    return PlanNode, Literal, Domain


def _canon_value(v):
    PlanNode, Literal, Domain = _canon_classes()
    if isinstance(v, PlanNode):
        return "node"             # children are NOT part of the key
    if isinstance(v, Literal):
        # the VALUE is a parameter of the shape, not plan structure
        return ("lit", str(v.type))
    if isinstance(v, Domain):
        # which column is constrained matters; the bounds are literals
        return ("domain", v.null_allowed)
    if is_dataclass(v) and not isinstance(v, type):
        frozen = type(v).__dataclass_params__.frozen
        if frozen:
            hit = _CANON_MEMO.get(id(v))
            if hit is not None and hit[0] is v:
                return hit[1]
        out = (type(v).__name__,) + tuple(
            _canon_value(getattr(v, f.name)) for f in fields(v))
        if frozen:
            if len(_CANON_MEMO) >= _CANON_MEMO_MAX:
                _CANON_MEMO.clear()
            _CANON_MEMO[id(v)] = (v, out)
        return out
    if isinstance(v, (list, tuple)):
        return tuple(_canon_value(x) for x in v)
    return repr(v)


# -- history entries -------------------------------------------------------


@dataclass
class NodeHistory:
    """EWMA-merged actuals of one plan node under one statement shape."""

    fp: str
    name: str
    rows: float = 0.0
    bytes: float = 0.0
    wall_ms: float = 0.0
    flops: float = 0.0
    peak_bytes: float = 0.0
    runs: int = 0
    #: decided adaptive-partial-aggregation verdict of a partial-agg
    #: node ({"verdict": ..., "pass_buckets": [...]}) — seeds the next
    #: run's operator past its observation window
    adaptive: Optional[dict] = None
    #: hybrid-join spill record of a join-build node ({"fanout": ...,
    #: "fraction": ..., "partitions_spilled": ...}) — the SECOND run
    #: sizes its partition fan-out from it (source=hbo) and the
    #: optimizer learns the build will spill
    spill: Optional[dict] = None

    _EWMA_FIELDS = ("rows", "bytes", "wall_ms", "flops", "peak_bytes")

    def merge(self, upd: dict, alpha: float):
        self.runs += 1
        for k in self._EWMA_FIELDS:
            v = float(upd.get(k) or 0.0)
            if self.runs == 1:
                setattr(self, k, v)
            else:
                cur = getattr(self, k)
                setattr(self, k, (1.0 - alpha) * cur + alpha * v)
        if upd.get("adaptive") is not None:
            self.adaptive = upd["adaptive"]
        if upd.get("spill") is not None:
            self.spill = upd["spill"]

    def to_dict(self) -> dict:
        return {"fp": self.fp, "name": self.name, "rows": self.rows,
                "bytes": self.bytes, "wall_ms": self.wall_ms,
                "flops": self.flops, "peak_bytes": self.peak_bytes,
                "runs": self.runs, "adaptive": self.adaptive,
                "spill": self.spill}

    @classmethod
    def from_dict(cls, d: dict) -> "NodeHistory":
        return cls(d["fp"], d.get("name", "?"),
                   float(d.get("rows", 0.0)), float(d.get("bytes", 0.0)),
                   float(d.get("wall_ms", 0.0)),
                   float(d.get("flops", 0.0)),
                   float(d.get("peak_bytes", 0.0)),
                   int(d.get("runs", 0)), d.get("adaptive"),
                   d.get("spill"))


def _dump_statement(fp: str, st: dict) -> dict:
    """JSON-safe form of one statement's history — the ONE shape the
    sidecar (``save``/``load``) and the worker seed
    (``export_seed``/``import_seed``) share; a field added here reaches
    both transports, so they cannot silently drift."""
    return {"fp": fp, "snap": st["snap"],
            "scan_rows": st["scan_rows"],
            "peak_bytes": st["peak_bytes"], "runs": st["runs"],
            "nodes": [h.to_dict() for h in st["nodes"].values()]}


def _parse_statement(s: dict):
    """(fp, statement dict) back from ``_dump_statement`` output;
    raises KeyError/ValueError/TypeError on malformed input — callers
    decide whether that is a corrupt sidecar or a bad seed."""
    return s["fp"], {
        "snap": s["snap"],
        "scan_rows": float(s.get("scan_rows", 0.0)),
        "peak_bytes": float(s.get("peak_bytes", 0.0)),
        "runs": int(s.get("runs", 0)),
        "nodes": {n["fp"]: NodeHistory.from_dict(n)
                  for n in s["nodes"]},
    }


# -- the store -------------------------------------------------------------


class RuntimeStatsStore:
    """Process-wide per-plan-node runtime statistics, LRU-bounded per
    statement shape.  Thread-safe: workers' piggybacked actuals and the
    coordinator's own drivers record concurrently."""

    def __init__(self, max_statements: int = MAX_STATEMENTS):
        self._lock = threading.Lock()
        #: stmt_fp -> {"snap": str, "nodes": {fp: NodeHistory},
        #:             "scan_rows": float, "peak_bytes": float,
        #:             "runs": int}
        self._stmts: "OrderedDict[str, dict]" = OrderedDict()
        self.max_statements = max_statements
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.records = 0
        self.corrupt_loads = 0
        #: plan decisions history CHANGED versus connector estimates
        #: alone, by kind ("join_order" | "distribution") — bumped at
        #: the decision sites (ReorderJoins, ExchangePlanner), the
        #: trino_hbo_plan_flips family
        self.plan_flips: Dict[str, int] = {}
        #: misestimate histogram (Q-error of estimate vs actual at
        #: record time): Prometheus-shaped cumulative buckets
        self._qerr = {"count": 0, "sum": 0.0,
                      "buckets": [[le, 0] for le in QERROR_BUCKETS]}

    def note_plan_flip(self, kind: str):
        """One plan decision just diverged from the connector-only
        choice because recorded history priced it differently."""
        with self._lock:
            self.plan_flips[kind] = self.plan_flips.get(kind, 0) + 1

    # -- lookups -----------------------------------------------------------

    def lookup(self, stmt_fp: str, node_fp: str,
               snap: str) -> Optional[NodeHistory]:
        """History for one node, or None — and when the statement's
        recorded snapshot no longer matches ``snap`` (a DDL/write moved
        a referenced connector's data_version), the WHOLE statement's
        history drops: stale actuals must not steer plans."""
        with self._lock:
            st = self._stmts.get(stmt_fp)
            if st is None:
                self.misses += 1
                return None
            if st["snap"] != snap:
                del self._stmts[stmt_fp]
                self.invalidations += 1
                self.misses += 1
                return None
            h = st["nodes"].get(node_fp)
            if h is None:
                self.misses += 1
                return None
            self._stmts.move_to_end(stmt_fp)
            self.hits += 1
            return h

    def statement_hint(self, stmt_fp: str, snap: str) -> Optional[dict]:
        """Statement-level observed aggregates (scan rows for the
        progress fallback, peak bytes for admission sizing); same
        snapshot-invalidation contract as ``lookup``."""
        with self._lock:
            st = self._stmts.get(stmt_fp)
            if st is None or st["snap"] != snap:
                return None
            return {"scan_rows": st["scan_rows"],
                    "peak_bytes": st["peak_bytes"],
                    "runs": st["runs"]}

    # -- recording ---------------------------------------------------------

    def record_query(self, stmt_fp: str, snap: str, nodes: Iterable[dict],
                     scan_rows: float = 0.0, peak_bytes: float = 0.0,
                     alpha: float = DEFAULT_EWMA_ALPHA) -> bool:
        """Fold one execution's per-node actuals in.  Each node dict:
        ``{fp, name, rows, bytes?, wall_ms?, flops?, peak_bytes?,
        est_rows?, decision?, adaptive?}``.  Returns True when a
        DECISION node (``decision=True``: join inputs, grouped
        aggregations) misestimated materially versus what the planner
        would use next time — the caller then invalidates cached plans
        of this statement shape so the next run re-plans from
        history."""
        material = False
        with self._lock:
            st = self._stmts.get(stmt_fp)
            if st is not None and st["snap"] != snap:
                # re-recorded under a NEW snapshot: the old history is
                # stale both for lookups and as a merge base
                self.invalidations += 1
                st = None
            if st is None:
                st = {"snap": snap, "nodes": {}, "scan_rows": 0.0,
                      "peak_bytes": 0.0, "runs": 0}
                self._stmts[stmt_fp] = st
            self._stmts.move_to_end(stmt_fp)
            while len(self._stmts) > self.max_statements:
                self._stmts.popitem(last=False)
            st["runs"] += 1
            for tgt, v in (("scan_rows", float(scan_rows)),
                           ("peak_bytes", float(peak_bytes))):
                st[tgt] = v if st["runs"] == 1 \
                    else (1.0 - alpha) * st[tgt] + alpha * v
            for upd in nodes:
                h = st["nodes"].get(upd["fp"])
                rows = float(upd.get("rows") or 0.0)
                if upd.get("decision"):
                    # what would the NEXT plan see without this record?
                    prior = h.rows if h is not None and h.runs else \
                        upd.get("est_rows")
                    if prior is not None \
                            and q_error(prior, rows) >= MATERIAL_QERROR:
                        material = True
                if h is None:
                    h = st["nodes"][upd["fp"]] = NodeHistory(
                        upd["fp"], upd.get("name", "?"))
                h.merge(upd, alpha)
                est = upd.get("est_rows")
                if est is not None:
                    q = q_error(est, rows)
                    self._qerr["count"] += 1
                    self._qerr["sum"] += q
                    for b in self._qerr["buckets"]:
                        if q <= b[0]:
                            b[1] += 1
            self.records += 1
        return material

    # -- observability -----------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"statements": len(self._stmts),
                    "nodes": sum(len(s["nodes"])
                                 for s in self._stmts.values()),
                    "hits": self.hits, "misses": self.misses,
                    "invalidations": self.invalidations,
                    "records": self.records,
                    "corrupt_loads": self.corrupt_loads,
                    "plan_flips": sum(self.plan_flips.values())}

    def snapshot(self) -> List[dict]:
        """system.runtime.plan_stats rows: one per (statement, node)."""
        out = []
        with self._lock:
            for stmt_fp, st in self._stmts.items():
                for h in st["nodes"].values():
                    out.append(dict(h.to_dict(), statement=stmt_fp,
                                    statement_runs=st["runs"]))
        return out

    def families(self) -> List[dict]:
        """``trino_hbo_*`` metric families (plain family dicts — the
        histogram payload needs direct construction)."""
        c = self.counters()
        if not (c["statements"] or c["records"] or c["misses"]):
            return []
        with self._lock:
            qerr = {"count": self._qerr["count"],
                    "sum": self._qerr["sum"],
                    "buckets": [list(b) for b in self._qerr["buckets"]]}
            flips = dict(self.plan_flips)
        return [
            {"name": "trino_hbo_plan_flips", "type": "counter",
             "help": "Plan decisions recorded history changed versus "
                     "connector estimates alone "
                     "(kind=join_order|distribution)",
             "samples": [[{"kind": k}, flips.get(k, 0)]
                         for k in ("join_order", "distribution")]},
            {"name": "trino_hbo_store_entries", "type": "gauge",
             "help": "History-based statistics store size "
                     "(kind=statements|nodes)",
             "samples": [[{"kind": "statements"}, c["statements"]],
                         [{"kind": "nodes"}, c["nodes"]]]},
            {"name": "trino_hbo_lookups_total", "type": "counter",
             "help": "History lookups by outcome "
                     "(hit|miss|invalidation)",
             "samples": [[{"outcome": "hit"}, c["hits"]],
                         [{"outcome": "miss"}, c["misses"]],
                         [{"outcome": "invalidation"},
                          c["invalidations"]]]},
            {"name": "trino_hbo_records_total", "type": "counter",
             "help": "Query executions whose per-node actuals were "
                     "folded into the history store",
             "samples": [[{}, c["records"]]]},
            {"name": "trino_hbo_qerror", "type": "histogram",
             "help": "Per-node Q-error (max(est/actual, actual/est)) "
                     "observed at record time — the misestimate "
                     "histogram",
             "samples": [[{}, qerr]]},
        ]

    def qerror_quantile(self, q: float) -> Optional[float]:
        """Q-error quantile for bench reporting, linearly interpolated
        WITHIN the landing bucket from the cumulative counts — a
        regression that stays inside one bucket still moves the
        reported value (the ratchet must see it).  The open-ended
        bucket clamps to its lower bound."""
        with self._lock:
            count = self._qerr["count"]
            buckets = [list(b) for b in self._qerr["buckets"]]
        if not count:
            return None
        target = q * count
        lo, prev_cum = 1.0, 0
        for le, cum in buckets:
            if cum >= target:
                if le == float("inf"):
                    return lo
                in_bucket = cum - prev_cum
                frac = (target - prev_cum) / in_bucket if in_bucket \
                    else 1.0
                return lo + frac * (le - lo)
            lo, prev_cum = le, cum
        return lo

    # -- persistence -------------------------------------------------------

    def save(self, path: str):
        """Atomic JSON sidecar write (tmp + rename): a crash mid-save
        leaves the previous sidecar intact."""
        with self._lock:
            body = {"version": 1, "statements": [
                _dump_statement(fp, st)
                for fp, st in self._stmts.items()]}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(body, f)
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        """Load a sidecar; missing file is fine (fresh store), a
        CORRUPT one warns loudly, counts, and leaves the store empty —
        history silently half-loaded would steer plans from garbage."""
        if not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                body = json.load(f)
            loaded: "OrderedDict[str, dict]" = OrderedDict()
            for s in body["statements"]:
                fp, st = _parse_statement(s)
                loaded[fp] = st
        except (ValueError, KeyError, TypeError, OSError) as e:
            with self._lock:
                self.corrupt_loads += 1
            warnings.warn(
                f"hbo sidecar {path!r} is corrupt and was IGNORED "
                f"(history restarts empty): {e!r}", RuntimeWarning,
                stacklevel=2)
            return False
        with self._lock:
            self._stmts = loaded
        return True

    # -- worker seeding ----------------------------------------------------

    def export_seed(self, max_statements: int = 32) -> dict:
        """Bounded, JSON-safe snapshot of the MOST RECENT statements —
        the coordinator piggybacks this on worker ``configure()`` so
        worker-local planning decisions (adaptive partial-agg seeding,
        local strategy picks) see the same cardinalities the
        coordinator planned from. Bounded by recency, not size-on-
        disk: a replacement worker spawned mid-life gets the freshest
        history, and the RPC payload stays small."""
        with self._lock:
            recent = list(self._stmts.items())[-max_statements:]
            return {"version": 1, "statements": [
                _dump_statement(fp, st) for fp, st in recent]}

    def import_seed(self, payload: dict) -> int:
        """Fold a coordinator seed into this (worker-local) store and
        return how many statements it actually imported. Existing
        statements win — a worker that already observed fresher
        actuals must not regress to the coordinator's shipped EWMA
        (those count 0). A malformed payload warns loudly and imports
        nothing (the half-load rule ``load`` follows)."""
        try:
            loaded = [_parse_statement(s)
                      for s in payload["statements"]]
        except (ValueError, KeyError, TypeError) as e:
            with self._lock:
                self.corrupt_loads += 1
            warnings.warn(
                f"hbo seed payload is malformed and was IGNORED: "
                f"{e!r}", RuntimeWarning, stacklevel=2)
            return 0
        imported = 0
        with self._lock:
            for fp, st in loaded:
                if fp not in self._stmts:
                    self._stmts[fp] = st
                    imported += 1
            while len(self._stmts) > self.max_statements:
                self._stmts.popitem(last=False)
        return imported

    def clear(self):
        with self._lock:
            self._stmts.clear()
            self.hits = self.misses = self.invalidations = 0
            self.records = self.corrupt_loads = 0
            self.plan_flips = {}
            self._qerr = {"count": 0, "sum": 0.0,
                          "buckets": [[le, 0] for le in QERROR_BUCKETS]}


#: the process-wide store (coordinator and workers each own one, like
#: the profiler registry); tests swap via fresh instances or clear()
_STORE = RuntimeStatsStore()


def store() -> RuntimeStatsStore:
    return _STORE


# -- per-query binding -----------------------------------------------------


def merge_actuals(lists: Iterable[List[dict]]) -> List[dict]:
    """Sum same-fingerprint actuals across task/worker shards (every
    task of a stage runs the same chain: shards of one plan node)."""
    by_fp: Dict[str, dict] = {}
    for actuals in lists:
        for a in actuals or ():
            cur = by_fp.get(a["fp"])
            if cur is None:
                by_fp[a["fp"]] = dict(a)
                continue
            for k in ("rows", "bytes", "wall_ms", "flops",
                      "peak_bytes"):
                cur[k] = float(cur.get(k) or 0.0) \
                    + float(a.get(k) or 0.0)
            if a.get("adaptive") is not None:
                cur["adaptive"] = a["adaptive"]
            if a.get("spill") is not None:
                cur["spill"] = a["spill"]
    return list(by_fp.values())


class HboContext:
    """One query's binding of the store to a statement shape +
    connector snapshot.  The planner tags operators with node
    fingerprints through it, the optimizer consults history through
    it, and the runner records actuals through it AFTER execution
    (host-side only — never inside traced code)."""

    def __init__(self, stmt_fp: str, snap: str,
                 stats_store: Optional[RuntimeStatsStore] = None,
                 alpha: float = DEFAULT_EWMA_ALPHA):
        self.stmt_fp = stmt_fp
        self.snap = snap
        self.store = stats_store
        self.alpha = alpha
        # node identity survives only while the node object does: the
        # cached NODE rides in the value (the StatsCalculator pattern)
        self._fps: Dict[int, tuple] = {}

    @classmethod
    def for_statement(cls, stmt, session, metadata,
                      stats_store: Optional[RuntimeStatsStore] = None,
                      alpha: float = DEFAULT_EWMA_ALPHA
                      ) -> Optional["HboContext"]:
        """Context for a plain query statement, or None when the
        statement is unversionable (a referenced connector reports no
        data_version — the same statements the plan cache refuses)."""
        from ..cache import (normalize_statement, snapshot_fingerprint,
                             statement_catalogs)
        from ..sql import ast

        if not isinstance(stmt, ast.QueryStatement):
            return None
        shape, _literals = normalize_statement(stmt)
        snap = snapshot_fingerprint(
            statement_catalogs(stmt, session), metadata)
        if snap is None:
            return None
        return cls(statement_fingerprint(shape), snapshot_key(snap),
                   stats_store if stats_store is not None else store(),
                   alpha=alpha)

    def fp(self, node) -> str:
        hit = self._fps.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        fp = plan_node_fp(node)
        self._fps[id(node)] = (node, fp)
        return fp

    def history(self, node) -> Optional[NodeHistory]:
        if self.store is None:
            return None
        return self.store.lookup(self.stmt_fp, self.fp(node), self.snap)

    def rows_for(self, node) -> Optional[float]:
        h = self.history(node)
        return h.rows if h is not None and h.runs else None

    def adaptive_seed(self, node_fp: str) -> Optional[dict]:
        if self.store is None:
            return None
        h = self.store.lookup(self.stmt_fp, node_fp, self.snap)
        return h.adaptive if h is not None else None

    def spill_hint(self, node_fp: str) -> Optional[dict]:
        """The hybrid-join spill record of this node's previous run
        (None = never observed spilling): feeds fan-out sizing
        (source=hbo) and the optimizer's will-spill cost input."""
        if self.store is None:
            return None
        h = self.store.lookup(self.stmt_fp, node_fp, self.snap)
        return h.spill if h is not None else None

    def statement_hint(self) -> Optional[dict]:
        if self.store is None:
            return None
        return self.store.statement_hint(self.stmt_fp, self.snap)

    # -- recording ---------------------------------------------------------

    def collect_actuals(self, op_stats: Iterable) -> List[dict]:
        """Per-node actuals out of fingerprint-tagged OperatorStats
        (summed across tasks — every task of a stage runs the same
        chain, so same-fp entries are shards of one plan node)."""
        by_fp: Dict[str, dict] = {}
        for st in op_stats:
            fp = getattr(st, "node_fp", None)
            if not fp:
                continue
            cur = by_fp.get(fp)
            if cur is None:
                cur = by_fp[fp] = {
                    "fp": fp, "name": st.name, "rows": 0.0,
                    "bytes": 0.0, "wall_ms": 0.0, "flops": 0.0,
                    "peak_bytes": 0.0}
            cur["rows"] += st.output_rows
            cur["bytes"] += getattr(st, "device_bytes", 0.0) or 0.0
            cur["wall_ms"] += st.wall_ns / 1e6
            cur["flops"] += getattr(st, "flops", 0.0) or 0.0
            peak = (st.metrics or {}).get("peak_bytes") \
                if getattr(st, "metrics", None) else None
            if peak:
                cur["peak_bytes"] += peak
            verdict = (st.metrics or {}).get("adaptive_verdict") \
                if getattr(st, "metrics", None) else None
            if verdict is not None:
                cur["adaptive"] = verdict
            hspill = (st.metrics or {}).get("hybrid_spill") \
                if getattr(st, "metrics", None) else None
            if hspill is not None:
                cur["spill"] = hspill
        return list(by_fp.values())

    def record(self, root, metadata, op_stats: Iterable,
               peak_bytes: float = 0.0, scan_rows: float = 0.0,
               estimates=None) -> Optional[dict]:
        """Record one execution out of fingerprint-tagged
        OperatorStats (the local/in-process runners' path)."""
        return self.record_actuals(root, metadata,
                                   self.collect_actuals(op_stats),
                                   peak_bytes=peak_bytes,
                                   scan_rows=scan_rows,
                                   estimates=estimates)

    def record_actuals(self, root, metadata, actuals: List[dict],
                       peak_bytes: float = 0.0,
                       scan_rows: float = 0.0,
                       estimates=None) -> Optional[dict]:
        """Record one execution from already-collected per-node actual
        dicts (the multi-process runner piggybacks these on task
        responses): estimate every node the way the NEXT planning run
        would (history included), attach Q-errors, fold into the
        store, and return the per-query summary ``{recorded, material,
        worst}`` (worst = the worst-misestimate node for EXPLAIN
        ANALYZE and the slow-query log).  ``estimates`` accepts a
        precomputed ``self.estimates(...)`` result so callers that
        already walked the plan (EXPLAIN ANALYZE rendering) don't pay
        the estimator pass — and its store lookups — twice."""
        if self.store is None:
            return None
        if not actuals:
            return None
        est_map, decision_fps = estimates if estimates is not None \
            else self.estimates(root, metadata)
        worst = None
        for a in actuals:
            est = est_map.get(a["fp"])
            if est is None:
                continue
            a["est_rows"] = est
            a["decision"] = a["fp"] in decision_fps
            q = q_error(est, a["rows"])
            if worst is None or q > worst["qerror"]:
                # node-style name ("TableScan", not "TableScanOperator"):
                # the summary line must not collide with tools that
                # pattern-match operator-stats lines by class name
                name = a["name"][:-8] if a["name"].endswith("Operator") \
                    else a["name"]
                worst = {"name": name, "est_rows": round(est, 1),
                         "actual_rows": int(a["rows"]),
                         "qerror": round(q, 2)}
        material = self.store.record_query(
            self.stmt_fp, self.snap, actuals, scan_rows=scan_rows,
            peak_bytes=peak_bytes, alpha=self.alpha)
        return {"recorded": len(actuals), "material": material,
                "worst": worst}

    def estimates(self, root, metadata):
        """``(fp -> estimated rows, decision-node fps)`` over a plan
        tree, estimated WITH history consulted — exactly what the next
        planning of this shape will see, so a converged history stops
        flagging material changes (the loop terminates)."""
        from ..planner.plan import (AggregationNode, ExchangeNode,
                                    JoinNode)
        from ..planner.stats import StatsCalculator

        calc = StatsCalculator(metadata, history=self)
        est: Dict[str, float] = {}
        decisions = set()

        def walk(node):
            for s in node.sources:
                walk(s)
            est[self.fp(node)] = calc.stats(node).row_count
            if isinstance(node, JoinNode):
                decisions.add(self.fp(node.left))
                decisions.add(self.fp(node.right))
                if getattr(node, "distribution", None) is not None \
                        and isinstance(node.right, ExchangeNode):
                    # DISTRIBUTION decision node: the broadcast-vs-
                    # partitioned choice priced the PRE-exchange build
                    # subtree, so a material misestimate THERE must
                    # also invalidate cached plans of the shape
                    decisions.add(self.fp(node.right.source))
            elif isinstance(node, AggregationNode) and node.group_keys:
                decisions.add(self.fp(node))

        walk(root)
        return est, decisions
