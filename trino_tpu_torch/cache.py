"""Query-shape caching for high-QPS serving: plan + shared-processor
cache, result cache, and the shape keys that drive admission batching.

The JAX engine's ``trino_tpu/cache.py``, copied. Reference analog: the
dispatcher-level ``QueryPreparer`` / prepared-statement machinery plus
the proposed Presto/Trino plan-cache designs — repeat dashboard-style
statements must not re-pay parse -> analyze -> plan -> optimize ->
expression planning on every submission.

Key anatomy (the ONE key shared by every cache tier and the admission
batcher)::

    shape        normalized AST: every parameterizable literal replaced
                 by ast.Parameter(i) — "select c from t where k = 5" and
                 "... k = 9" share a shape
    literals     the parameterized-out literal vector, in walk order
    session_fp   catalog/schema/start_date/timezone + the FULL sorted
                 session-property overrides — any SET SESSION lands in a
                 fresh keyspace (a stale knob can never leak a plan)
    snapshot_fp  per-referenced-catalog connector data versions; a DDL
                 or write bumps the version so every dependent entry
                 misses loudly.  A connector that reports no version
                 (``data_version() is None`` — e.g. the live ``system``
                 catalog) makes the statement UNCACHEABLE.

The plan cache stores the optimized plan root per FULL key (shape +
literals + fingerprints): literal values flow into constant folding and
connector pushdown, so a plan is only provably reusable for the exact
vector it was planned with.  The shape level still pays off twice: the
admission batcher groups same-shape statements, and a "shape hit" /
"invalidation" split in the metrics shows WHY a miss happened.  Repeat
executions reuse the root AND the ``PageProcessor`` instances (their
planned closures and uploaded LUTs — without sharing, every
resubmission re-plans every filter/projection), so the hot path
re-instantiates only cheap operator shells: fresh splits, fresh memory
pools.

The result cache keys WITH literals and charges its pages against a
``QueryMemoryPool`` — over budget it evicts LRU entries instead of
growing without bound.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import fields, is_dataclass
from typing import Dict, List, Optional, Tuple

from .sql import ast
# the template seed store's key, re-exported beside it
from .telemetry.stats_store import statement_fingerprint  # noqa: F401

#: functions whose output varies between identical executions — results
#: must never be served from cache (plans are still fine: the call
#: executes per run)
NONDETERMINISTIC_FUNCTIONS = {"random", "rand", "uuid", "shuffle"}

#: AST literal kinds a shape parameterizes out.  Boolean/NULL literals
#: stay in the shape (two-valued — parameterizing them buys nothing and
#: they often steer planning); interval literals keep their unit parsing
#: in the shape too.
_PARAM_LITERALS = (ast.LongLiteral, ast.DoubleLiteral, ast.DecimalLiteral,
                   ast.StringLiteral, ast.GenericLiteral)


def _literal_token(node) -> tuple:
    """Canonical, hashable value token for one parameterized literal.
    The kind tag keeps 5 (long) and 5.0 (double) distinct — their IR
    types differ, so their plans must too."""
    if isinstance(node, ast.LongLiteral):
        return ("long", node.value)
    if isinstance(node, ast.DoubleLiteral):
        return ("double", node.value)
    if isinstance(node, ast.DecimalLiteral):
        return ("decimal", node.text)
    if isinstance(node, ast.StringLiteral):
        return ("string", node.value)
    return ("generic", node.type_name, node.value)


def normalize_statement(stmt: ast.Statement
                        ) -> Tuple[ast.Node, Tuple[tuple, ...]]:
    """Rewrite ``stmt`` into its shape: literals out, ``Parameter(i)``
    in, returning ``(shape, literal_tokens)``.  The shape is a frozen
    AST tree — hashable, equality-comparable — usable directly as a
    cache-key component."""
    literals: List[tuple] = []

    def walk(node):
        if isinstance(node, _PARAM_LITERALS):
            literals.append(_literal_token(node))
            return ast.Parameter(len(literals) - 1)
        if isinstance(node, tuple):
            return tuple(walk(x) for x in node)
        if is_dataclass(node) and isinstance(node, ast.Node):
            return type(node)(**{f.name: walk(getattr(node, f.name))
                                 for f in fields(node)})
        return node

    return walk(stmt), tuple(literals)


def _walk_nodes(node):
    """Yield every AST node in a statement tree (dataclass fields +
    tuples)."""
    if isinstance(node, tuple):
        for x in node:
            yield from _walk_nodes(x)
        return
    if is_dataclass(node) and isinstance(node, ast.Node):
        yield node
        for f in fields(node):
            yield from _walk_nodes(getattr(node, f.name))


def statement_catalogs(stmt: ast.Statement, session) -> frozenset:
    """Catalogs a statement MAY read: every Table reference resolves to
    its explicit catalog or the session default.  Over-approximates (a
    WITH alias counts as a session-catalog table) — an extra catalog in
    the snapshot fingerprint only costs cache misses, never staleness."""
    cats = set()
    for node in _walk_nodes(stmt):
        if isinstance(node, ast.Table):
            if len(node.name) >= 3:
                cats.add(node.name[0].lower())
            elif session.catalog:
                cats.add(session.catalog.lower())
    return frozenset(cats)


def is_deterministic(stmt: ast.Statement) -> bool:
    """False when any function call can vary between identical runs
    (``current_date``/``now`` are session-pinned via ``start_date`` —
    deterministic under the session fingerprint)."""
    for node in _walk_nodes(stmt):
        if isinstance(node, ast.FunctionCall) and \
                node.name.lower() in NONDETERMINISTIC_FUNCTIONS:
            return False
    return True


def session_fingerprint(session) -> tuple:
    """Everything about a Session that can steer analysis or planning:
    resolution context + start date + the full property override map.
    A SET SESSION of ANY property moves subsequent statements into a
    fresh keyspace — coarse, but it makes "stale knob reuses a plan"
    structurally impossible."""
    return (session.catalog, session.schema, session.timezone,
            session.start_date.toordinal(),
            tuple(sorted(session.properties.items())))


def snapshot_fingerprint(catalogs: frozenset, metadata
                         ) -> Optional[tuple]:
    """(catalog, data_version) per referenced catalog, or None when any
    referenced connector is unversioned (live catalogs like ``system``)
    — None = this statement is uncacheable."""
    out = []
    for cat in sorted(catalogs):
        conn = metadata.connectors.get(cat)
        if conn is None:
            return None
        v = conn.data_version()
        if v is None:
            return None
        out.append((cat, v))
    return tuple(out)


class ParsedQuery:
    """Memoized per-statement-text parse + shape analysis."""

    __slots__ = ("stmt", "shape", "literals", "catalogs",
                 "is_query", "deterministic")

    def __init__(self, stmt, session):
        self.stmt = stmt
        self.is_query = isinstance(stmt, ast.QueryStatement)
        if self.is_query:
            self.shape, self.literals = normalize_statement(stmt)
            self.catalogs = statement_catalogs(stmt, session)
            self.deterministic = is_deterministic(stmt)
        else:
            self.shape = None
            self.literals = ()
            self.catalogs = frozenset()
            self.deterministic = False


class ProcessorCache:
    """Shared ``PageProcessor`` instances keyed by their exact build
    inputs (input types + projection/filter IR — frozen dataclasses, so
    the key is the semantics).  THIS is where repeat statements stop
    re-planning: a PageProcessor owns its planned closures and its
    uploaded LUTs, so re-planning without sharing rebuilds every
    expression of every pipeline on every submission.  Instances are
    shared by concurrent queries: a processor's host caches take its
    own lock."""

    def __init__(self, max_entries: int = 512):
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, input_types, projections, filter_expr):
        from .expr.compiler import PageProcessor

        key = (tuple(input_types), tuple(projections), filter_expr)
        with self._lock:
            proc = self._entries.get(key)
            if proc is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return proc
            self.misses += 1
        # build OUTSIDE the lock: expression planning is the expensive
        # part
        proc = PageProcessor(list(input_types), list(projections),
                             filter_expr)
        with self._lock:
            self._entries.setdefault(key, proc)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            return self._entries[key]


class PlanCache:
    """Optimized plan roots per full key; LRU-bounded.  ``shape_hits``
    counts misses where the SHAPE was known but the literal vector was
    new; ``invalidations`` counts misses where a known shape's snapshot
    moved (a DDL/write bumped a referenced connector)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self._shape_snap: Dict = {}   # shape -> last stored snapshot_fp
        self.hits = 0
        self.misses = 0
        self.shape_hits = 0
        self.invalidations = 0
        self.evictions = 0
        self.hbo_invalidations = 0

    def lookup(self, key):
        shape, snapshot_fp = key[0], key[3]
        with self._lock:
            root = self._entries.get(key)
            if root is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return root
            self.misses += 1
            last_snap = self._shape_snap.get(shape)
            if last_snap is not None:
                if last_snap != snapshot_fp:
                    self.invalidations += 1
                else:
                    self.shape_hits += 1
            return None

    def store(self, key, root, max_entries: int):
        with self._lock:
            self._entries[key] = root
            self._entries.move_to_end(key)
            self._shape_snap[key[0]] = key[3]
            while len(self._entries) > max(1, max_entries):
                self._entries.popitem(last=False)
                self.evictions += 1
            if len(self._shape_snap) > 4 * max(1, max_entries):
                live = {k[0] for k in self._entries}
                self._shape_snap = {s: v for s, v
                                    in self._shape_snap.items()
                                    if s in live}

    def invalidate_shape(self, shape) -> int:
        """Drop every cached plan of one statement shape: history-based
        statistics learned a MATERIALLY different cardinality for a
        decision node, so plans optimized from the old estimates must
        re-plan against history on their next submission (the HBO
        analog of a snapshot bump — same loud-miss philosophy)."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == shape]
            for k in doomed:
                del self._entries[k]
            if doomed:
                self._shape_snap.pop(shape, None)
                self.hbo_invalidations += len(doomed)
            return len(doomed)

    def __len__(self):
        with self._lock:
            return len(self._entries)


def _estimate_result_bytes(rows: List[tuple]) -> int:
    """Cheap accounting estimate for cached rows (sampled string cost);
    governance wants a budget, not an audit."""
    if not rows:
        return 256
    ncols = len(rows[0]) if rows[0] else 1
    per_row = 48 + 24 * ncols
    sample = rows[:: max(1, len(rows) // 32)][:32]
    str_extra = 0
    for r in sample:
        for v in r:
            if isinstance(v, str):
                str_extra += len(v)
    if sample:
        per_row += str_extra // len(sample)
    return 256 + per_row * len(rows)


class ResultCache:
    """Finished result rows per full key (WITH literals).  Entries
    charge a dedicated ``QueryMemoryPool`` — over budget the pool's
    reserve fails and LRU entries evict until the new entry fits (or is
    skipped when larger than the whole budget)."""

    def __init__(self, max_bytes: int = 64 << 20,
                 max_rows: int = 100_000):
        from .exec.memory import QueryMemoryPool

        self.max_bytes = int(max_bytes)
        self.max_rows = int(max_rows)
        self.pool = QueryMemoryPool(self.max_bytes,
                                    query_id="result-cache")
        self._ctx = self.pool.create_context("cached-results")
        self._lock = threading.Lock()
        # key -> (column_names, types, rows, nbytes)
        self._entries: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit
            self.misses += 1
            return None

    def store(self, key, column_names, types, rows, scans=()):
        """``scans`` carries the plan's (catalog, schema, table,
        columns) references so a later hit can re-enforce SELECT for
        the requesting user before serving cached rows."""
        from .types import TrinoError

        if len(rows) > self.max_rows:
            return
        nbytes = _estimate_result_bytes(rows)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._ctx.free(old[3], revocable=False)
            while True:
                try:
                    self._ctx.reserve(nbytes, revocable=False)
                    break
                except TrinoError:
                    if not self._entries:
                        return  # single entry over budget: skip
                    _, evicted = self._entries.popitem(last=False)
                    self._ctx.free(evicted[3], revocable=False)
                    self.evictions += 1
            self._entries[key] = (column_names, types, rows, nbytes,
                                  tuple(scans))

    @property
    def reserved_bytes(self) -> int:
        return self.pool.reserved

    def __len__(self):
        with self._lock:
            return len(self._entries)


def literal_nodes(tokens) -> List[ast.Expression]:
    """Rebuild the AST literal node each ``_literal_token`` came from —
    the inverse of the tokenization, so template machinery can re-run
    the ANALYZER's typing rules (decimal precision, varchar length,
    DATE parsing under the session timezone) instead of duplicating
    them."""
    out: List[ast.Expression] = []
    for tok in tokens:
        kind = tok[0]
        if kind == "long":
            out.append(ast.LongLiteral(tok[1]))
        elif kind == "double":
            out.append(ast.DoubleLiteral(tok[1]))
        elif kind == "decimal":
            out.append(ast.DecimalLiteral(tok[1]))
        elif kind == "string":
            out.append(ast.StringLiteral(tok[1]))
        else:
            out.append(ast.GenericLiteral(tok[1], tok[2]))
    return out


def analyze_literal_tokens(tokens, session):
    """Lower literal tokens to typed IR ``Literal``s via the analyzer
    (one per token, in slot order).  Raises ``AnalysisError`` for
    malformed generic literals — callers treat that as template
    ineligibility."""
    from .sql.analyzer import ExpressionAnalyzer, Scope

    an = ExpressionAnalyzer(Scope([], None), session)
    return [an.analyze(node) for node in literal_nodes(tokens)]


class PlanTemplate:
    """One value-independent optimized plan serving EVERY literal vector
    of a statement shape.  ``param_types`` are the IR types
    the template was planned against — a member whose analyzed literal
    types differ (e.g. varchar(3) vs varchar(5), decimal scale drift)
    must not ride it."""

    __slots__ = ("root", "param_types", "scan_refs")

    def __init__(self, root, param_types, scan_refs=()):
        self.root = root
        self.param_types = tuple(param_types)
        self.scan_refs = tuple(scan_refs)


class TemplateCache:
    """Plan templates per (shape, session_fp, snapshot_fp, user) — the
    full cache key MINUS literals.  Entries are positive (a
    ``PlanTemplate``) or negative (a fallback-reason string: the shape
    was tried and its planning genuinely depends on a literal value, so
    per-statement planning is the loudly-counted answer and rebuild
    attempts stop).  ``shape_uses`` feeds the admission policy: a shape
    earns a template only after enough repeat uses (or an HBO hint)
    prove the template build will amortize."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self._shape_uses: Dict = {}
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.fallbacks: Dict[str, int] = {}
        self.dispositions: Dict[str, int] = {}

    def lookup(self, key):
        """-> ("hit", PlanTemplate) | ("fallback", reason) | None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ("fallback", e) if isinstance(e, str) else ("hit", e)

    def store(self, key, template: PlanTemplate, max_entries: int):
        with self._lock:
            self.builds += 1
            self._entries[key] = template
            self._entries.move_to_end(key)
            while len(self._entries) > max(1, max_entries):
                self._entries.popitem(last=False)

    def store_fallback(self, key, reason: str, max_entries: int):
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
            self._entries[key] = reason
            self._entries.move_to_end(key)
            while len(self._entries) > max(1, max_entries):
                self._entries.popitem(last=False)

    def note_fallback(self, reason: str):
        """Count a per-member/per-batch fallback that doesn't negative-
        cache the whole key (e.g. one member's literal types drifted
        from the template's — other members still ride it)."""
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def note_disposition(self, reason: str):
        """Count HOW a batched launch executed beyond filter/project
        stages (``agg_stage_vmapped`` / ``join_stage_vmapped``) — the
        positive half of the ``non_fp_stage`` split: the
        metric family shows vmapped agg/join launches next to the
        ``unsupported_stage`` fallbacks they replaced."""
        with self._lock:
            self.dispositions[reason] = self.dispositions.get(reason, 0) + 1

    def note_uses(self, shape, n: int = 1) -> int:
        """Count ``n`` submissions of ``shape``; returns the running
        total (a batch of B counts as B uses — a same-shape burst is
        exactly the evidence a template pays for)."""
        with self._lock:
            total = self._shape_uses.get(shape, 0) + n
            self._shape_uses[shape] = total
            if len(self._shape_uses) > 4096:
                # bound the counter map: keep the hottest half
                keep = sorted(self._shape_uses.items(),
                              key=lambda kv: kv[1], reverse=True)[:2048]
                self._shape_uses = dict(keep)
            return total

    def invalidate_shape(self, shape) -> int:
        """HBO re-plan hook (mirrors ``PlanCache.invalidate_shape``)."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == shape]
            for k in doomed:
                del self._entries[k]
            return len(doomed)

    def __len__(self):
        with self._lock:
            return len(self._entries)


class TemplateSeedStore:
    """Process-wide template-earn state shared across the cluster: the
    coordinator's per-shape use totals and negative
    (fallback) verdicts, keyed by ``statement_fingerprint(shape)`` so
    the payload is JSON-safe and process-independent.

    Transport mirrors the HBO seed: the coordinator exports a
    bounded snapshot that piggybacks on worker ``configure()`` and on
    the heartbeat when the local version advanced, so a REPLACEMENT
    worker rides an already-earned template on its first statement
    instead of re-earning ``batched_execution_min_shape_uses``
    locally — and skips shapes the cluster already proved
    value-dependent without paying its own trial plan.

    Merge discipline is max-wins (use totals only ever grow; the max of
    two counters is a sound lower bound of true cluster-wide uses) and
    a remote fallback verdict never overwrites a local one (the local
    process observed its own trial).  All mutation holds ``_lock`` —
    readers race with the heartbeat exporter otherwise.
    """

    MAX_SHAPES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._uses: Dict[str, int] = {}
        self._fallbacks: Dict[str, str] = {}
        self.version = 0          # bumps on any growth: heartbeat delta gate
        self.corrupt_loads = 0

    def note(self, fp: str, total: int):
        with self._lock:
            cur = self._uses.get(fp, 0)
            if total > cur:
                self._uses[fp] = total
                self.version += 1
            self._trim()

    def note_fallback_shape(self, fp: str, reason: str):
        with self._lock:
            if fp not in self._fallbacks:
                self._fallbacks[fp] = reason
                self.version += 1

    def uses(self, fp: str) -> int:
        with self._lock:
            return self._uses.get(fp, 0)

    def fallback_reason(self, fp: str) -> Optional[str]:
        with self._lock:
            return self._fallbacks.get(fp)

    def _trim(self):
        # caller holds _lock; bound like TemplateCache._shape_uses
        if len(self._uses) > self.MAX_SHAPES:
            keep = sorted(self._uses.items(), key=lambda kv: kv[1],
                          reverse=True)[:self.MAX_SHAPES // 2]
            self._uses = dict(keep)

    def export_seed(self, max_shapes: int = 64) -> dict:
        """Bounded JSON-safe snapshot of the HOTTEST shapes (use totals
        are the heat signal the admission policy consults)."""
        with self._lock:
            hot = sorted(self._uses.items(), key=lambda kv: kv[1],
                         reverse=True)[:max_shapes]
            shapes = [[fp, int(n), self._fallbacks.get(fp)]
                      for fp, n in hot]
            for fp, reason in self._fallbacks.items():
                if len(shapes) >= max_shapes:
                    break
                if fp not in self._uses:
                    shapes.append([fp, 0, reason])
            return {"version": 1, "shapes": shapes}

    def import_seed(self, payload: dict) -> int:
        """Fold a coordinator seed in; returns how many shapes carried
        NEW information (higher total or a fresh verdict).  A malformed
        payload warns loudly and imports nothing (the HBO seed's
        half-load rule)."""
        import warnings

        try:
            rows = [(str(fp), int(n), None if reason is None
                     else str(reason))
                    for fp, n, reason in payload["shapes"]]
        except (ValueError, KeyError, TypeError) as e:
            with self._lock:
                self.corrupt_loads += 1
            warnings.warn(
                f"template seed payload is malformed and was IGNORED: "
                f"{e!r}", RuntimeWarning, stacklevel=2)
            return 0
        imported = 0
        with self._lock:
            for fp, n, reason in rows:
                grew = False
                if n > self._uses.get(fp, 0):
                    self._uses[fp] = n
                    grew = True
                if reason is not None and fp not in self._fallbacks:
                    self._fallbacks[fp] = reason
                    grew = True
                if grew:
                    imported += 1
                    self.version += 1
            self._trim()
        return imported

    def clear(self):
        with self._lock:
            self._uses.clear()
            self._fallbacks.clear()
            self.version = 0


#: the process-wide seed store (coordinator and workers each own one);
#: tests reset via ``clear()``
_TEMPLATE_SEEDS = TemplateSeedStore()


def template_seeds() -> TemplateSeedStore:
    return _TEMPLATE_SEEDS


class QueryCache:
    """Per-runner facade: parse memo + plan cache + result cache +
    shared-processor cache, with one metrics surface.  Owned by
    LocalQueryRunner; the admission batcher reads ``parse()`` shapes to
    group same-shape statements."""

    def __init__(self, metadata, result_cache_bytes: int = 64 << 20,
                 max_text_entries: int = 1024):
        self.metadata = metadata
        self._lock = threading.Lock()
        self._texts: "OrderedDict[str, ParsedQuery]" = OrderedDict()
        self.max_text_entries = max_text_entries
        self.plans = PlanCache()
        self.results = ResultCache(max_bytes=result_cache_bytes)
        self.processors = ProcessorCache()
        self.templates = TemplateCache()
        self.coalesced = 0          # identical in-batch statements demuxed
        self.batches = 0            # admission batches executed
        self.batched_queries = 0    # statements that rode a batch
        self.batched_launches = 0   # statements served by ONE vmapped launch
        self.batched_spills = 0     # lanes that overflowed a unified capacity
        self.result_shortcircuits = 0  # batch members served from result cache

    def parse(self, sql: str, session) -> ParsedQuery:
        """Memoized parse + shape analysis (exact statement text).  The
        memo is session-independent for the pieces that matter — shape
        and literals derive from text alone; catalogs use the session
        default catalog, so the memo keys on that too."""
        memo_key = (sql, session.catalog)
        with self._lock:
            pq = self._texts.get(memo_key)
            if pq is not None:
                self._texts.move_to_end(memo_key)
                return pq
        from .sql.parser import parse_statement

        pq = ParsedQuery(parse_statement(sql), session)
        with self._lock:
            self._texts[memo_key] = pq
            while len(self._texts) > self.max_text_entries:
                self._texts.popitem(last=False)
        return pq

    def cache_key(self, pq: ParsedQuery, session,
                  user: Optional[str] = None) -> Optional[tuple]:
        """Full cache key for this statement under this session, or
        None when uncacheable (not a plain query, or a referenced
        catalog is unversioned).  The effective ``user`` scopes the
        entry: tenants with per-user ACLs must never share cached
        plans or rows."""
        if not pq.is_query:
            return None
        snap = snapshot_fingerprint(pq.catalogs, self.metadata)
        if snap is None:
            return None
        return (pq.shape, pq.literals, session_fingerprint(session),
                snap, user or session.user)

    def template_key(self, pq: ParsedQuery, session,
                     user: Optional[str] = None) -> Optional[tuple]:
        """Template cache key: the full key MINUS literals — one entry
        serves every literal vector of the shape.  Same None rules as
        ``cache_key`` (and additionally None for literal-free shapes:
        with zero parameter slots the plan cache already covers them)."""
        if not pq.is_query or not pq.literals:
            return None
        snap = snapshot_fingerprint(pq.catalogs, self.metadata)
        if snap is None:
            return None
        return (pq.shape, session_fingerprint(session), snap,
                user or session.user)

    def note_batch(self, size: int, coalesced: int):
        with self._lock:
            self.batches += 1
            self.batched_queries += size
            self.coalesced += coalesced

    def counters(self) -> Dict[str, int]:
        return {
            "plan_hits": self.plans.hits,
            "plan_misses": self.plans.misses,
            "plan_shape_hits": self.plans.shape_hits,
            "plan_invalidations": self.plans.invalidations,
            "plan_hbo_invalidations": self.plans.hbo_invalidations,
            "plan_evictions": self.plans.evictions,
            "plan_entries": len(self.plans),
            "result_hits": self.results.hits,
            "result_misses": self.results.misses,
            "result_evictions": self.results.evictions,
            "result_entries": len(self.results),
            "result_bytes": self.results.reserved_bytes,
            "processor_hits": self.processors.hits,
            "processor_misses": self.processors.misses,
            "batches": self.batches,
            "batched_queries": self.batched_queries,
            "coalesced": self.coalesced,
            "batched_launches": self.batched_launches,
            "batched_spills": self.batched_spills,
            "result_shortcircuits": self.result_shortcircuits,
            "template_hits": self.templates.hits,
            "template_misses": self.templates.misses,
            "template_builds": self.templates.builds,
            "template_fallbacks": sum(self.templates.fallbacks.values()),
            "template_entries": len(self.templates),
        }

    def add_families(self, reg):
        """Export the cache counters into a MetricsRegistry (GET
        /v1/metrics + system.runtime.metrics)."""
        c = self.counters()
        pc = reg.counter("trino_plan_cache_total",
                         "Plan-cache lookups by outcome (hit|miss|"
                         "shape_hit|invalidation|hbo_invalidation|"
                         "eviction)")
        pc.inc(c["plan_hits"], outcome="hit")
        pc.inc(c["plan_misses"], outcome="miss")
        pc.inc(c["plan_shape_hits"], outcome="shape_hit")
        pc.inc(c["plan_invalidations"], outcome="invalidation")
        pc.inc(c["plan_hbo_invalidations"], outcome="hbo_invalidation")
        pc.inc(c["plan_evictions"], outcome="eviction")
        reg.gauge("trino_plan_cache_entries",
                  "Plan-cache resident entries").set(c["plan_entries"])
        rc = reg.counter("trino_result_cache_total",
                         "Result-cache lookups by outcome "
                         "(hit|miss|eviction)")
        rc.inc(c["result_hits"], outcome="hit")
        rc.inc(c["result_misses"], outcome="miss")
        rc.inc(c["result_evictions"], outcome="eviction")
        reg.gauge("trino_result_cache_bytes",
                  "Result-cache bytes charged to its memory pool").set(
            c["result_bytes"])
        reg.gauge("trino_result_cache_entries",
                  "Result-cache resident entries").set(
            c["result_entries"])
        proc = reg.counter("trino_processor_cache_total",
                           "Shared compiled-PageProcessor lookups "
                           "(hit = a pipeline reused an already-planned "
                           "program)")
        proc.inc(c["processor_hits"], outcome="hit")
        proc.inc(c["processor_misses"], outcome="miss")
        b = reg.counter("trino_admission_batches_total",
                        "Admission batching (kind=batches|queries|"
                        "coalesced)")
        b.inc(c["batches"], kind="batches")
        b.inc(c["batched_queries"], kind="queries")
        b.inc(c["coalesced"], kind="coalesced")
        b.inc(c["batched_launches"], kind="vmapped")
        b.inc(c["batched_spills"], kind="spilled")
        b.inc(c["result_shortcircuits"], kind="result_shortcircuit")
        t = reg.counter("trino_plan_template_total",
                        "Plan-template lookups/builds by outcome "
                        "(hit|miss|build|fallback:<reason>|"
                        "disposition:<reason>)")
        t.inc(c["template_hits"], outcome="hit")
        t.inc(c["template_misses"], outcome="miss")
        t.inc(c["template_builds"], outcome="build")
        for reason, n in sorted(self.templates.fallbacks.items()):
            t.inc(n, outcome=f"fallback:{reason}")
        # taxonomy split: ``non_fp_stage`` became
        # ``unsupported_stage`` (+ the vmapped dispositions below);
        # export the old key as an alias for one release so dashboards
        # keyed on it keep reading during the rename
        legacy = self.templates.fallbacks.get("unsupported_stage", 0)
        if legacy:
            t.inc(legacy, outcome="fallback:non_fp_stage")
        for reason, n in sorted(self.templates.dispositions.items()):
            t.inc(n, outcome=f"disposition:{reason}")
        reg.gauge("trino_plan_template_entries",
                  "Plan-template resident entries (positive + "
                  "negative)").set(c["template_entries"])
