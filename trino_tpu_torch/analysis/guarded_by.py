"""guarded-by pass: Eraser-style lockset inference over must-alias
static facts — "this attribute is guarded by this lock, and this
thread touches it bare".

The engine mutates shared state from many threads (heartbeat/heal
loops, the protocol server's eviction timer and executor drains,
streaming task threads, finalizer-driven spill demotions, retained-
stream replay, the shared processor caches), and the previous eight
passes verify lock ORDERING and LIFECYCLE but never lock COVERAGE.
This pass closes that family — the stats_store EWMA merge, the
stream_results done-race and the ProcessorCache ``_cache_lock`` were
all hand-found instances of it.

Model, in three steps:

1. **Thread-entry index** (``core.thread_entries``): functions handed
   to other threads — ``Thread(target=...)`` / ``Timer(...)`` /
   executor ``submit`` / ``*RequestHandler`` methods /
   ``weakref.finalize`` callbacks — each tagged with its entry kind,
   plus the reachable closure over resolved call edges
   (``core.thread_reachable``). A function not in the closure runs
   only where its callers run.

2. **Lockset inference**: for every ``self.<attr>`` load/store site,
   the set of must-alias locks held there — lexically (the ``with
   self._lock:`` stack, identities via lock-order's ``_Identities``)
   plus interprocedurally: a summary fixpoint propagates the
   INTERSECTION of every resolved caller's held-set into the callee
   (a lock held on only some call paths is not held). Parametric lock
   tokens are dropped rather than guessed: must-alias or nothing.
   Sites live in methods AND in nested defs that capture the
   enclosing method's ``self`` as a closure (``_owning_class`` — the
   per-task ``run_one`` thread-target shape), so closure accesses
   cannot hide from the pass.

3. **Guard inference + report**: an attribute's candidate guard is
   the lock held at a QUALIFYING MAJORITY of its post-``__init__``
   mutating sites (>= 2 guarded sites, strictly more than half). A
   finding is a bare read/write of a guarded attribute from a
   thread-entry-reachable function whose entry set is DIFFERENT from
   the guarded sites' — same-thread sequential access never reports.

Conservatism (mirrors v2): must-alias identities only; attributes
assigned solely in ``__init__`` BEFORE any thread spawn are exempt
(immutable-after-init — publication happens-before the spawn);
attributes whose every site runs on one entry are exempt
(single-entry); every report names the inferred guard, sample guarded
sites and the bare site. Deliberate lock-free designs opt out with
``# qlint: ignore[guarded-by] <reason>``.

A **check-then-act** sub-rule catches the TOCTOU shape on shared
dict/list/set containers (the ``_QueryState`` / memo-dict pattern):
an ``if`` whose test reads ``self.<container>`` and whose body
mutates it, with NO lock held, on a container accessed from more
than one entry.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .core import (FastVisitor, Finding, FunctionInfo, ModuleInfo,
                   ProjectIndex, _spawn_scan, dotted_chain, own_nodes,
                   thread_reachable)
from .lock_order import _Identities, _is_param

PASS_ID = "guarded-by"

#: container methods that mutate in place — a call through
#: ``self.<attr>.<m>(...)`` is a WRITE site of the attribute
_MUTATORS = {"append", "appendleft", "add", "extend", "insert",
             "remove", "discard", "pop", "popleft", "popitem",
             "clear", "update", "setdefault", "move_to_end"}

#: constructors that type an attribute as a shared container for the
#: check-then-act sub-rule
_CONTAINER_CTORS = {"dict", "list", "set", "OrderedDict", "deque",
                    "defaultdict", "collections.OrderedDict",
                    "collections.deque", "collections.defaultdict"}

#: constructors whose result is a mutual-exclusion context manager —
#: ``with self._cond:`` guards exactly like ``with self._lock:`` (a
#: Condition embeds a lock), but its name defeats the lockish-name
#: heuristic, so construction sites register the identity explicitly
_LOCK_CTORS = {"threading.Lock", "threading.RLock",
               "threading.Condition", "Lock", "RLock", "Condition"}


def _known_locks(index: ProjectIndex, ids: _Identities) -> Set[str]:
    """Lock ids of every attribute/name ASSIGNED from a Lock/RLock/
    Condition constructor — the identities ``with`` acceptance trusts
    beyond the name heuristic."""
    known: Set[str] = set()
    for mod in index.modules.values():
        for node in mod.nodes:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            if dotted_chain(node.value.func) not in _LOCK_CTORS:
                continue
            for t in node.targets:
                chain = dotted_chain(t)
                if chain is None:
                    continue
                func = mod.enclosing_function(node.lineno)
                known.add(ids.lock_id(mod, func, chain))
    return known


@dataclass
class AccessSite:
    attr_id: str            # module.Class.attr
    func_id: str
    line: int
    kind: str               # "read" | "write"
    #: lexically held lock ids at the site (with-stack snapshot)
    lexical: FrozenSet[str]
    in_init: bool
    #: entry ids spawned EARLIER in the same ``__init__`` body — a
    #: write carrying any is a post-publication init write (the
    #: ``init-race`` rule's subject)
    post_spawn_entries: Tuple[str, ...] = ()


@dataclass
class _FuncAccesses(FastVisitor):
    """One method's ``self.<attr>`` access sites with the lexical
    with-held lock stack, plus the held-set snapshot at every resolved
    call (the interprocedural propagation input). Mirrors lock-order's
    ``_FuncLocks`` walk so the two passes agree on what "held" means."""

    index: ProjectIndex
    mod: ModuleInfo
    func: FunctionInfo
    ids: _Identities
    #: constructor-known lock identities (Condition and friends)
    known: Set[str] = field(default_factory=set)
    #: the class whose instance `self` denotes here — the function's
    #: own class for methods, the ENCLOSING method's class for nested
    #: defs that capture `self` as a closure (thread targets like
    #: `run_one` are exactly this shape)
    owner_class: Optional[str] = None
    sites: List[AccessSite] = field(default_factory=list)
    #: (callee id, frozenset of held lock ids) per resolved call
    calls_held: List[Tuple[str, FrozenSet[str]]] = \
        field(default_factory=list)
    #: (If line, attrs read in test, attrs written in body,
    #:  held lock ids at the If)
    check_acts: List[Tuple[int, Set[str], Set[str], FrozenSet[str]]] = \
        field(default_factory=list)
    _held: List[str] = field(default_factory=list)

    def __post_init__(self):
        self._in_init = self.func.qualname.endswith("__init__")

    def _held_now(self) -> FrozenSet[str]:
        return frozenset(t for t in self._held if not _is_param(t))

    def _attr_id(self, attr: str) -> Optional[str]:
        if not self.owner_class:
            return None
        return f"{self.mod.name}.{self.owner_class}.{attr}"

    def _site(self, attr: str, line: int, kind: str):
        aid = self._attr_id(attr)
        if aid is not None:
            self.sites.append(AccessSite(aid, self.func.id, line, kind,
                                         self._held_now(),
                                         self._in_init))

    # -- lock stack (the _FuncLocks shape) ------------------------------

    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)
            hit = self.ids.item_lock_id(self.mod, self.func,
                                        item.context_expr)
            if hit is None:
                # name heuristic missed: accept identities PROVEN by a
                # Lock/RLock/Condition construction site (`self._cond`)
                chain = dotted_chain(item.context_expr)
                if chain is not None:
                    canonical = self.index.canonical_chain(self.func,
                                                           chain)
                    lid = self.ids.lock_id(self.mod, self.func,
                                           canonical)
                    if lid in self.known:
                        hit = (lid, canonical)
            if hit is not None:
                self._held.append(hit[0])
                pushed += 1
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self._held.pop()

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        if node is not self.func.node:
            return   # nested defs own their accesses (no self binding)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- access classification ------------------------------------------

    @staticmethod
    def _self_attr(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        return None

    @classmethod
    def _target_attr(cls, target: ast.AST) -> Optional[str]:
        """The self-attribute a single (non-compound) store target
        writes: ``self.x`` rebinds, ``self.d[k]`` container stores —
        THE one predicate both the site recorder and the
        check-then-act body scan share, so they cannot drift."""
        attr = cls._self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            # ``self.d[k] = v`` mutates the container self.d holds
            attr = cls._self_attr(target.value)
        return attr

    def _store_target(self, target: ast.AST, line: int):
        attr = self._target_attr(target)
        if attr is not None:
            self._site(attr, line, "write")
            if isinstance(target, ast.Subscript):
                self.visit(target.slice)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._store_target(e, line)
            return
        if isinstance(target, ast.Starred):
            self._store_target(target.value, line)
            return
        self.visit(target)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._store_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        # ``self.x += 1`` is the classic lost-update read-modify-write:
        # one write site (the read is implied by the same site)
        self._store_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._store_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            attr = self._self_attr(t)
            if attr is None and isinstance(t, ast.Subscript):
                attr = self._self_attr(t.value)
            if attr is not None:
                self._site(attr, node.lineno, "write")
            else:
                self.visit(t)

    def visit_Call(self, node: ast.Call):
        chain = dotted_chain(node.func)
        if chain is not None:
            parts = chain.split(".")
            if len(parts) == 3 and parts[0] == "self" \
                    and parts[-1] in _MUTATORS:
                # self.<attr>.append(...) — in-place mutation
                self._site(parts[1], node.lineno, "write")
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
            target = self.index.resolve(self.mod, self.func, chain)
            if target is not None and target in self.index.functions:
                self.calls_held.append((target, self._held_now()))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        attr = self._self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._site(attr, node.lineno, "read")
        self.generic_visit(node)

    def visit_If(self, node: ast.If):
        test_reads = self._attrs_in(node.test)
        if test_reads:
            body_writes: Set[str] = set()
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    body_writes |= self._write_attrs(sub)
            if test_reads & body_writes:
                self.check_acts.append(
                    (node.lineno, test_reads, body_writes,
                     self._held_now()))
        self.generic_visit(node)

    def _attrs_in(self, expr: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(expr):
            attr = self._self_attr(n)
            if attr is not None:
                aid = self._attr_id(attr)
                if aid is not None:
                    out.add(aid)
        return out

    def _write_attrs(self, node: ast.AST) -> Set[str]:
        """ALL attr ids ``node`` writes (rebind, subscript store incl.
        inside tuple/list unpacks, del, in-place mutator call) — same
        ``_target_attr`` predicate the site recorder uses, so the two
        scans cannot drift."""
        attrs: Set[str] = set()
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            stack = list(node.targets) \
                if not isinstance(node, ast.AugAssign) \
                else [node.target]
            while stack:
                t = stack.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    stack.extend(t.elts)
                elif isinstance(t, ast.Starred):
                    stack.append(t.value)
                else:
                    attr = self._target_attr(t)
                    if attr is not None:
                        attrs.add(attr)
        elif isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain is not None:
                parts = chain.split(".")
                if len(parts) == 3 and parts[0] == "self" \
                        and parts[-1] in _MUTATORS:
                    attrs.add(parts[1])
        return {aid for aid in (self._attr_id(a) for a in attrs)
                if aid is not None}


@dataclass
class GuardAnalysis:
    """Everything the findings (and the not-blind floors) consume."""
    entries: Dict[str, object]
    #: func id -> entry ids reaching it
    reachable: Dict[str, Set[str]]
    #: attr id -> access sites (init included, marked)
    sites: Dict[str, List[AccessSite]]
    #: attr id -> inferred guard lock id
    guards: Dict[str, str]
    #: attr id -> why it is exempt (immutable-after-init | single-entry)
    exempt: Dict[str, str]
    per_func: Dict[str, _FuncAccesses] = field(default_factory=dict)
    #: func id -> interprocedural context lockset (held at EVERY
    #: resolved call path into it)
    context: Dict[str, FrozenSet[str]] = field(default_factory=dict)


def _context_locksets(index: ProjectIndex,
                      per_func: Dict[str, _FuncAccesses],
                      entries: Dict[str, object]
                      ) -> Dict[str, FrozenSet[str]]:
    """Meet-over-callers fixpoint: a lock is in a function's context
    only when EVERY resolved call site reaching it holds the lock
    (callers contribute their own context plus their lexical held-set
    at the call). Roots — functions with no resolved in-edges, and
    thread entries — start empty: nothing is known to be held there."""
    in_edges: Dict[str, int] = {}
    for fa in per_func.values():
        for callee, _held in fa.calls_held:
            in_edges[callee] = in_edges.get(callee, 0) + 1
    ctx: Dict[str, Optional[FrozenSet[str]]] = {}
    for fid in per_func:
        if fid in entries or in_edges.get(fid, 0) == 0:
            ctx[fid] = frozenset()
        else:
            ctx[fid] = None   # TOP: no caller seen yet
    for _ in range(50):
        changed = False
        for fid, fa in per_func.items():
            base = ctx.get(fid)
            if base is None:
                continue
            for callee, held in fa.calls_held:
                if callee not in ctx:
                    continue
                incoming = base | held
                cur = ctx[callee]
                new = incoming if cur is None else (cur & incoming)
                if new != cur:
                    ctx[callee] = new
                    changed = True
        if not changed:
            break
    # functions never reached from a root (unresolved-only callers in
    # a cycle) stay TOP: treat as unknown-empty — their sites cannot
    # claim guarded-ness they did not prove
    return {fid: (c if c is not None else frozenset())
            for fid, c in ctx.items()}


def _owning_class(index: ProjectIndex,
                  func: FunctionInfo) -> Optional[str]:
    """The class whose instance ``self`` denotes inside ``func``: its
    own class for a method, and for a nested def that does NOT bind
    its own ``self`` parameter, the enclosing method's class (closure
    capture — `def run_one(t): ... self.workers ...` inside a method
    reads the method's instance). None when no enclosing method
    resolves: an unattributable `self` must not fabricate sites."""
    cur = func
    for _ in range(5):
        if "self" in cur.params:
            return cur.class_name if cur.class_name else None
        if not cur.scope:
            return None
        nxt = index.functions.get(f"{cur.module}:{cur.scope}")
        if nxt is None:
            return None
        cur = nxt
    return None


def analyze(index: ProjectIndex) -> GuardAnalysis:
    ids = _Identities(index)
    known = _known_locks(index, ids)
    per_func: Dict[str, _FuncAccesses] = {}
    for func in index.iter_functions():
        owner = _owning_class(index, func)
        if owner is None:
            continue
        mod = index.modules[func.module]
        fa = _FuncAccesses(index, mod, func, ids, known, owner)
        for stmt in func.body:
            fa.visit(stmt)
        per_func[func.id] = fa
    # ONE spawn walk feeds the entry index AND the spawn-line map (the
    # analyzer rides a <10s pre-commit CPU ratchet, and one predicate
    # cannot drift against itself)
    entries, spawns = _spawn_scan(index)
    context = _context_locksets(index, per_func, entries)
    reachable = thread_reachable(index, entries)

    # entries spawned inside each function, by line — an __init__
    # write AFTER one of these lines races the spawned thread
    spawned_in: Dict[str, List[Tuple[int, str]]] = {}
    for eid, e in entries.items():
        mod = index.modules.get(e.spawn_module)
        if mod is None:
            continue
        info = mod.enclosing_function(e.spawn_line)
        if info is not None:
            spawned_in.setdefault(info.id, []).append(
                (e.spawn_line, eid))

    sites: Dict[str, List[AccessSite]] = {}
    for fid, fa in per_func.items():
        inherited = context.get(fid, frozenset())
        for s in fa.sites:
            if inherited:
                s.lexical = s.lexical | inherited
            if s.in_init and s.kind == "write":
                s.post_spawn_entries = tuple(sorted(
                    eid for line, eid in spawned_in.get(fid, ())
                    if line < s.line))
            sites.setdefault(s.attr_id, []).append(s)

    guards: Dict[str, str] = {}
    exempt: Dict[str, str] = {}
    for attr_id, ss in sites.items():
        post_init = [s for s in ss if not s.in_init]
        writes = [s for s in post_init if s.kind == "write"]
        if not writes:
            # assigned solely in __init__ — immutable after init,
            # UNLESS some __init__ store lands after a thread spawn in
            # the same body (the spawned thread may already read it;
            # with a RESOLVED spawn target that shape is reported
            # directly by the init-race rule in run()). ANY spawn line
            # kills the exemption, resolved or not — an unresolvable
            # target still publishes `self`
            racy = any(s.kind == "write" and s.in_init
                       and any(ln < s.line
                               for ln in spawns.get(s.func_id, ()))
                       for s in ss)
            if not racy:
                exempt[attr_id] = "immutable-after-init"
                continue
            writes = [s for s in ss if s.kind == "write"]
        tags: Set[str] = set()
        for s in post_init or ss:
            tags |= reachable.get(s.func_id, {"<main>"}) or {"<main>"}
        if len(tags) <= 1:
            exempt[attr_id] = "single-entry"
            continue
        counts: Dict[str, int] = {}
        for s in writes:
            for lock in s.lexical:
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            continue
        best = max(sorted(counts), key=lambda k: counts[k])
        if counts[best] >= 2 and counts[best] * 2 > len(writes):
            guards[attr_id] = best
    return GuardAnalysis(entries, reachable, sites, guards, exempt,
                         per_func, context)


def _fmt_sites(ss: List[AccessSite], guard: str, limit: int = 3) -> str:
    picks = [s for s in ss if guard in s.lexical][:limit]
    return ", ".join(f"{s.func_id.split(':')[-1]}:{s.line}"
                     for s in picks)


def _entry_names(analysis: GuardAnalysis, tags: Set[str]) -> str:
    out = []
    for t in sorted(tags):
        e = analysis.entries.get(t)
        kind = getattr(e, "kind", None)
        name = t.split(":")[-1] if ":" in t else t
        out.append(f"{name} [{kind}]" if kind else name)
    return ", ".join(out)


def run(index: ProjectIndex) -> List[Finding]:
    analysis = analyze(index)
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()

    def effective(fid: str) -> Set[str]:
        """Thread identities a function runs on: the entries reaching
        it, or the caller's thread (``<main>``) when none do —
        main-thread code is a thread too, not a blind spot."""
        return analysis.reachable.get(fid) or {"<main>"}

    for attr_id in sorted(analysis.guards):
        guard = analysis.guards[attr_id]
        ss = analysis.sites[attr_id]
        guarded = [s for s in ss if guard in s.lexical]
        for s in ss:
            if s.in_init or guard in s.lexical:
                continue
            bare_tags = effective(s.func_id)
            # the concurrent counterpart: for a bare READ, the guarded
            # WRITES it can observe torn; for a bare WRITE, every
            # guarded site (reads see the torn write too)
            counter = [g for g in guarded
                       if s.kind == "write" or g.kind == "write"]
            counter_tags: Set[str] = set()
            for g in counter:
                counter_tags |= effective(g.func_id)
            if len(bare_tags | counter_tags) <= 1:
                continue   # one thread identity total: sequential
            func = index.functions[s.func_id]
            key = (attr_id, s.func_id)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                PASS_ID, "guarded-by", func.module, func.qualname,
                s.line,
                f"`{attr_id.rsplit('.', 1)[-1]}` is guarded by "
                f"`{guard}` at {len(guarded)} site(s) "
                f"({_fmt_sites(ss, guard)}) but this {s.kind} holds "
                f"no lock — it runs on "
                f"{_entry_names(analysis, bare_tags)} against guarded "
                f"sites on {_entry_names(analysis, counter_tags)}",
                f"bare:{attr_id}:{func.qualname}"))

    # init-race: an __init__ store AFTER a thread spawn in the same
    # body, where the spawned thread('s reachable closure) touches the
    # same attribute — publication happened before initialization
    # finished, so the new thread can observe the pre-store value (or
    # a torn sequence of them). This is exactly the case the
    # immutable-after-init exemption must NOT cover.
    for attr_id in sorted(analysis.sites):
        ss = analysis.sites[attr_id]
        #: entry id -> a sample non-init site it reaches
        touched_by: Dict[str, AccessSite] = {}
        for s in ss:
            if s.in_init:
                continue
            for e in analysis.reachable.get(s.func_id, ()):
                touched_by.setdefault(e, s)
        for s in ss:
            racing = [e for e in s.post_spawn_entries
                      if e in touched_by]
            if not racing:
                continue
            func = index.functions[s.func_id]
            key = (f"initrace:{attr_id}", s.func_id)
            if key in seen:
                continue
            seen.add(key)
            reader = touched_by[racing[0]]
            reader_fn = reader.func_id.split(":")[-1]
            findings.append(Finding(
                PASS_ID, "init-race", func.module, func.qualname,
                s.line,
                f"`{attr_id.rsplit('.', 1)[-1]}` is stored AFTER "
                f"__init__ already spawned "
                f"{_entry_names(analysis, set(racing))}, which "
                f"reaches a {reader.kind} of it "
                f"({reader_fn}:{reader.line}) — the thread can run "
                f"before this store lands",
                f"initrace:{attr_id}"))

    # check-then-act on shared containers: unlocked test-then-mutate
    containers = _container_attrs(index)
    for fid in sorted(analysis.per_func):
        fa = analysis.per_func[fid]
        inherited = analysis.context.get(fid, frozenset())
        func = index.functions[fid]
        for line, test_reads, body_writes, held in fa.check_acts:
            if held | inherited:
                continue   # some lock held: not the unlocked shape
            for attr_id in sorted(test_reads & body_writes):
                if attr_id not in containers:
                    continue
                ss = analysis.sites.get(attr_id, [])
                tags: Set[str] = set()
                for s in ss:
                    if not s.in_init:
                        tags |= analysis.reachable.get(
                            s.func_id, {"<main>"}) or {"<main>"}
                if len(tags) <= 1:
                    continue   # single-entry container: sequential
                key = (f"cta:{attr_id}", fid)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    PASS_ID, "check-then-act", func.module,
                    func.qualname, line,
                    f"unlocked test-then-mutate on shared container "
                    f"`{attr_id.rsplit('.', 1)[-1]}` (accessed from "
                    f"{len(tags)} entries): the check and the "
                    f"mutation can interleave with another thread's",
                    f"cta:{attr_id}:{func.qualname}"))
    return findings


def _container_attrs(index: ProjectIndex) -> Set[str]:
    """attr ids constructed as dict/list/set/deque/OrderedDict
    literals or calls anywhere in their class — the shapes
    check-then-act applies to."""
    out: Set[str] = set()
    for func in index.iter_functions():
        if func.class_name is None:
            continue
        for node in own_nodes(func.node):
            if not isinstance(node, ast.Assign) \
                    or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            v = node.value
            is_container = isinstance(v, (ast.Dict, ast.List, ast.Set))
            if isinstance(v, ast.Call):
                chain = dotted_chain(v.func)
                if chain in _CONTAINER_CTORS:
                    is_container = True
            if is_container:
                out.add(f"{func.module}.{func.class_name}.{t.attr}")
    return out
