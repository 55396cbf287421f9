"""lock-order pass: AB-BA cycles and blocking calls under a held lock.

Lock identity is structural AND alias-aware: ``with
self._lock:`` in a method of class ``C`` in module ``M`` names the lock
``M.C._lock``; an acquisition through a TYPED instance chain —
``ctx.lock`` with ``ctx: OperatorMemoryContext``, or
``pool.host_ledger._lock`` through ``__init__``-typed attributes —
names the OWNING class's lock, so cross-instance acquisition edges
(e.g. ``HostSpillLedger`` under a per-operator context lock) resolve
structurally instead of being excluded. A lock flowing through a call
argument (``spill_pages(..., lock=ctx.lock)``) is tracked
parametrically: the callee's acquisitions of its ``lock`` parameter
instantiate to the caller's actual lock identity at every resolved
call site (transitively — an actual that is itself a parameter keeps
flowing). Local rebinds (``lock = self._lock``) and returned-attribute
accessors (``with obj.lock():`` where ``def lock(self): return
self._lock``) canonicalize through the core's alias facts.

Locals/parameters that never resolve stay scoped to their function, so
unknown objects can never fabricate a cycle: every unification is a
must-alias fact. While a lock is lexically held, every further
acquisition — in the same body or transitively through resolved
call-graph edges — adds an edge to the acquisition-order graph; a
cycle in that graph is the ``HostSpillLedger`` finalizer-deadlock
class. Self-edges are reported only for locks constructed as
``threading.Lock()`` and only when the re-acquisition is provably the
SAME object: ``self.``-routed, or a parametric flow of the held lock
itself. Two instances of one class are never conflated into a false
self-cycle.

Non-blocking tries (``acquire(blocking=False)``) are excluded
everywhere: they cannot wait, so they can neither close a cycle nor
stall an RPC — ``demote_across``'s cross-list lock hops rely on this.

A second rule flags blocking RPC / subprocess / socket traffic while
holding any lock (``lock-over-rpc``): the worker-loss detector
turns a worker stuck on a peer into a cascading replacement storm if
its server threads serialize behind a lock held across the wire.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import (FastVisitor, Finding, FunctionInfo, ModuleInfo,
                   ProjectIndex, bind_args, dotted_chain)

PASS_ID = "lock-order"

_RPC_PREFIXES = ("subprocess.", "socket.")
_RPC_LASTS = {"send_msg", "recv_msg", "check_output", "check_call"}
_RPC_TARGET_SUFFIXES = (":call",)   # parallel.rpc:call

_PARAM_PREFIX = "<param:"


def _param_token(fid: str, name: str) -> str:
    return f"{_PARAM_PREFIX}{fid}:{name}>"


def _is_param(token: str) -> bool:
    return token.startswith(_PARAM_PREFIX)


def _lockish(chain: Optional[str]) -> bool:
    return bool(chain) and "lock" in chain.split(".")[-1].lower()


class _Identities:
    """Shared lock-identity context: id strings plus, for class-scoped
    ids, the owning ``module.Class`` (the cross-instance witness)."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        #: lock id -> owning "module.Class" when the id is an attribute
        #: of a resolved class (self-scoped or instance-typed)
        self.owners: Dict[str, str] = {}

    def lock_id(self, mod: ModuleInfo, func: Optional[FunctionInfo],
                chain: str) -> str:
        chain = self.index.canonical_chain(func, chain)
        parts = chain.split(".")
        head = parts[0]
        if func is not None and head in func.params \
                and head not in ("self", "cls"):
            if len(parts) == 1:
                # the lock IS a parameter: parametric — instantiated
                # per call site from the caller's actual argument
                return _param_token(func.id, head)
            if head not in func.annotations:
                # attribute of an untyped parameter: scope to the
                # function so distinct callers never unify falsely
                return f"{mod.name}:{func.qualname}.{chain}"
        if len(parts) >= 2:
            site = self.index.instance_type(mod, func, parts[:-1])
            if site is not None:
                owner = f"{site[0]}.{site[1]}"
                lid = f"{owner}.{parts[-1]}"
                self.owners[lid] = owner
                return lid
        if head in ("self", "cls") and func is not None:
            owner_cls = func.class_name or func.qualname
            owner = f"{mod.name}.{owner_cls}"
            lid = f"{owner}.{'.'.join(parts[1:])}"
            self.owners[lid] = owner
            return lid
        if func is not None \
                and head not in mod.module_assigns \
                and head not in mod.scopes.get("", {}) \
                and head not in mod.from_imports \
                and head not in mod.imports:
            # local or unresolved base: scope to the function so
            # distinct callers' locks never unify into a false node
            return f"{mod.name}:{func.qualname}.{chain}"
        return f"{mod.name}.{chain}"

    def item_lock_id(self, mod: ModuleInfo,
                     func: Optional[FunctionInfo],
                     expr: ast.expr
                     ) -> Optional[Tuple[str, Optional[str]]]:
        """(lock id, canonical source chain) of a with-item: a dotted
        chain, or a returned-attribute accessor call (``with
        obj.lock():``). The lockish-name heuristic accepts the RAW
        chain or its alias expansion (`lk = self._lock; with lk:`
        qualifies either way — `lock = self._mu` must too)."""
        chain = dotted_chain(expr)
        if chain is not None:
            canonical = self.index.canonical_chain(func, chain)
            if _lockish(chain) or _lockish(canonical):
                return self.lock_id(mod, func, canonical), canonical
        if isinstance(expr, ast.Call) and not expr.args:
            call_chain = dotted_chain(expr.func)
            if not _lockish(call_chain):
                return None
            target = self.index.resolve(mod, func, call_chain)
            callee = self.index.functions.get(target or "")
            if callee is not None and callee.returns_chain \
                    and callee.class_name:
                attr = callee.returns_chain.split(".", 1)[1]
                owner = f"{callee.module}.{callee.class_name}"
                lid = f"{owner}.{attr}"
                self.owners[lid] = owner
                return lid, call_chain
        return None


def _collect_lock_kinds(index: ProjectIndex,
                        ids: _Identities) -> Dict[str, str]:
    """lock id -> 'lock' | 'rlock' from ``X = threading.(R)Lock()``
    construction sites."""
    kinds: Dict[str, str] = {}
    for mod in index.modules.values():
        for node in mod.nodes:
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            ctor = dotted_chain(node.value.func)
            if ctor not in ("threading.Lock", "threading.RLock",
                            "Lock", "RLock"):
                continue
            kind = "rlock" if ctor.endswith("RLock") else "lock"
            for t in node.targets:
                chain = dotted_chain(t)
                if chain is None:
                    continue
                func = mod.enclosing_function(node.lineno)
                kinds[ids.lock_id(mod, func, chain)] = kind
    return kinds


def _nonblocking(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant):
            return kw.value.value is False
    return False


@dataclass
class _CallUnder:
    target: str                  # resolved callee function id
    node: ast.Call
    chain: str
    line: int
    #: (lock token, canonical source chain) held at the call — the
    #: chain distinguishes THIS instance's lock (`self._lock`) from a
    #: structurally-equal other instance's (`self.other._lock`)
    held: Tuple[Tuple[str, Optional[str]], ...]
    via_self: bool

    @property
    def held_ids(self) -> Tuple[str, ...]:
        return tuple(h for h, _ in self.held)


class _FuncLocks(FastVisitor):
    """One function's lock behaviour: direct acquisitions, ordered
    edges, resolved calls (with the held-lock snapshot), RPC-ish calls
    under a lock. Tokens are concrete lock ids or parametric
    ``<param:fid:name>`` placeholders."""

    def __init__(self, index: ProjectIndex, mod: ModuleInfo,
                 func: FunctionInfo, ids: _Identities):
        self.index = index
        self.mod = mod
        self.func = func
        self.ids = ids
        self.acquired: Set[str] = set()
        #: the subset acquired through THIS instance's own attribute
        #: (`self._lock` — not a structurally-equal peer's)
        self.own_acquired: Set[str] = set()
        self.pairs: List[Tuple[str, str, int]] = []
        #: (lock id, line) of direct re-acquisitions PROVEN same-object
        #: (identical canonical source chains) — structural id equality
        #: alone (two instances of one class) never lands here
        self.self_pairs: List[Tuple[str, int]] = []
        self.calls: List[_CallUnder] = []
        self.rpc_under: List[Tuple[str, str, int]] = []
        #: stack of (lock id, canonical source chain)
        self._held: List[Tuple[str, Optional[str]]] = []
        self._bindings = func.bindings

    @property
    def held_ids(self) -> Tuple[str, ...]:
        return tuple(h for h, _ in self._held)

    def stable_chain(self, chain: Optional[str]) -> bool:
        """A chain denotes ONE object across the whole frame only when
        its head can never be rebound here: ``self``/``cls``, or a
        name with zero bindings in this function (parameters never
        reassigned, module globals never shadowed). A rebindable head
        (`ctx = self._next` between two `ctx.lock` acquisitions) makes
        chain equality meaningless — no same-object claim."""
        if chain is None:
            return False
        head = chain.split(".")[0]
        if head in ("self", "cls"):
            return True
        return self._bindings.get(head, 0) == 0

    def _acquire(self, lock: str, line: int,
                 chain: Optional[str] = None):
        self.acquired.add(lock)
        if chain is not None and chain.startswith("self.") \
                and len(chain.split(".")) == 2:
            self.own_acquired.add(lock)
        for held, held_chain in self._held:
            if held == lock:
                # same structural id: a deadlock only when the SOURCE
                # chains prove the same object — identical chains with
                # a non-rebindable head (`self._lock` twice);
                # `self._lock` vs `other._lock` is two instances of
                # one class — ordered locking, not a self-cycle
                if chain is not None and chain == held_chain \
                        and self.stable_chain(chain):
                    self.self_pairs.append((lock, line))
            else:
                self.pairs.append((held, lock, line))

    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            # the item EXPRESSION runs before its acquisition: calls
            # inside it (`with enter_chan():`) must enter the call
            # graph or their transitive acquisitions vanish
            self.visit(item.context_expr)
            hit = self.ids.item_lock_id(self.mod, self.func,
                                        item.context_expr)
            if hit is not None:
                lock, chain = hit
                self._acquire(lock, node.lineno, chain)
                self._held.append((lock, chain))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self._held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):
        chain = dotted_chain(node.func)
        if chain is not None:
            parts = chain.split(".")
            if parts[-1] == "acquire" and len(parts) > 1 \
                    and not _nonblocking(node):
                base = self.index.canonical_chain(
                    self.func, ".".join(parts[:-1]))
                lock = self.ids.lock_id(self.mod, self.func, base)
                self._acquire(lock, node.lineno, base)
            else:
                target = self.index.resolve(self.mod, self.func, chain)
                if target is not None:
                    self.calls.append(_CallUnder(
                        target, node, chain, node.lineno,
                        tuple(self._held),
                        parts[0] in ("self", "cls")))
                if self._held and self._rpcish(chain, target):
                    for held in self.held_ids:
                        self.rpc_under.append(
                            (held, chain, node.lineno))
        self.generic_visit(node)

    @staticmethod
    def _rpcish(chain: str, target: Optional[str]) -> bool:
        if target and target.endswith(_RPC_TARGET_SUFFIXES):
            return True
        return chain.startswith(_RPC_PREFIXES) \
            or chain.split(".")[-1] in _RPC_LASTS

    def visit_FunctionDef(self, node):
        if node is not self.func.node:
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


@dataclass
class LockGraph:
    """The interprocedural acquisition-order graph plus everything the
    findings (and the not-blind tests) need: edge sample sites, lock
    kinds, class owners, the cross-instance edge subset, and the
    must-alias self-deadlocks parametric flow proved."""

    graph: Dict[str, Set[str]] = field(default_factory=dict)
    edge_site: Dict[Tuple[str, str], Tuple[str, str, int]] = \
        field(default_factory=dict)
    kinds: Dict[str, str] = field(default_factory=dict)
    owners: Dict[str, str] = field(default_factory=dict)
    per_func: Dict[str, _FuncLocks] = field(default_factory=dict)
    #: (held, acquired) edges whose endpoints belong to two DIFFERENT
    #: resolved classes — the cross-instance witness set
    cross_instance_edges: Set[Tuple[str, str]] = field(
        default_factory=set)
    #: (lock, func, line) where a parametric flow proved the held lock
    #: itself is re-acquired (must-alias self-deadlock)
    param_self_cycles: List[Tuple[str, str, int]] = \
        field(default_factory=list)


def build_lock_graph(index: ProjectIndex) -> LockGraph:
    ids = _Identities(index)
    lg = LockGraph(owners=ids.owners)
    for func in index.iter_functions():
        mod = index.modules[func.module]
        fl = _FuncLocks(index, mod, func, ids)
        for stmt in func.body:
            fl.visit(stmt)
        lg.per_func[func.id] = fl
    lg.kinds = _collect_lock_kinds(index, ids)

    # summary fixpoint: each function's transitive acquisitions and
    # ordered pairs, with parametric tokens instantiated per call site
    acq: Dict[str, Set[str]] = {fid: set(fl.acquired)
                                for fid, fl in lg.per_func.items()}
    pairs: Dict[str, Set[Tuple[str, str]]] = {
        fid: {(a, b) for a, b, _ in fl.pairs}
        for fid, fl in lg.per_func.items()}
    site: Dict[Tuple[str, str], Tuple[str, str, int]] = {}
    for fid, fl in lg.per_func.items():
        func = index.functions[fid]
        for a, b, line in fl.pairs:
            site.setdefault((a, b), (func.module, func.qualname, line))

    def substitute(token: str, callee: FunctionInfo,
                   call: _CallUnder, caller: FunctionInfo,
                   caller_mod: ModuleInfo
                   ) -> Tuple[Optional[str], Optional[str]]:
        """(instantiated token, canonical source chain of the actual
        argument) — the chain is what same-object claims compare; a
        bare structural-id match proves nothing across instances."""
        if not _is_param(token):
            return token, None
        inner = token[len(_PARAM_PREFIX):-1]
        owner_fid, name = inner.rsplit(":", 1)
        if owner_fid != callee.id:
            return None, None  # a deeper frame's parameter: not ours
        bound = bind_args(callee, call.node, call.chain,
                          index=index, mod=caller_mod)
        arg = bound.get(name)
        argchain = dotted_chain(arg) if arg is not None else None
        if argchain is None:
            return None, None
        canonical = index.canonical_chain(caller, argchain)
        return ids.lock_id(caller_mod, caller, canonical), canonical

    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for fid, fl in lg.per_func.items():
            caller = index.functions[fid]
            caller_mod = index.modules[caller.module]
            for call in fl.calls:
                callee = index.functions.get(call.target)
                if callee is None:
                    continue
                sub_cache: Dict[str, Tuple[Optional[str],
                                           Optional[str]]] = {}

                def sub(token: str) -> Tuple[Optional[str],
                                             Optional[str]]:
                    if token not in sub_cache:
                        sub_cache[token] = substitute(
                            token, callee, call, caller, caller_mod)
                    return sub_cache[token]

                for token in list(acq.get(call.target, ())):
                    s, s_chain = sub(token)
                    if s is None:
                        continue
                    if s not in acq[fid]:
                        acq[fid].add(s)
                        changed = True
                    for held, held_chain in call.held:
                        if held == s:
                            # must-alias ONLY when the flowed argument
                            # is the held lock's own source chain (and
                            # that chain can't have been rebound):
                            # `grab(other._lock)` under `self._lock`
                            # is a cross-instance hand-off, not a
                            # self-deadlock
                            if _is_param(token) \
                                    and s_chain is not None \
                                    and s_chain == held_chain \
                                    and fl.stable_chain(s_chain) \
                                    and lg.kinds.get(s, "rlock") \
                                    == "lock":
                                rec = (s, fid, call.line)
                                if rec not in lg.param_self_cycles:
                                    lg.param_self_cycles.append(rec)
                            continue
                        if (held, s) not in pairs[fid]:
                            pairs[fid].add((held, s))
                            changed = True
                        site.setdefault(
                            (held, s),
                            (caller.module, caller.qualname,
                             call.line))
                for a, b in list(pairs.get(call.target, ())):
                    if not (_is_param(a) or _is_param(b)):
                        continue   # concrete pairs stand on their own
                    sa, sb = sub(a)[0], sub(b)[0]
                    if sa is None or sb is None or sa == sb:
                        continue
                    if (sa, sb) not in pairs[fid]:
                        pairs[fid].add((sa, sb))
                        changed = True
                    site.setdefault(
                        (sa, sb),
                        (caller.module, caller.qualname, call.line))

    for fid, pp in pairs.items():
        for a, b in pp:
            if _is_param(a) or _is_param(b) or a == b:
                continue
            lg.graph.setdefault(a, set()).add(b)
            lg.graph.setdefault(b, set())
            lg.edge_site.setdefault(
                (a, b), site.get((a, b),
                                 (index.functions[fid].module,
                                  index.functions[fid].qualname, 1)))
            owner_a = lg.owners.get(a)
            owner_b = lg.owners.get(b)
            if owner_a and owner_b and owner_a != owner_b:
                lg.cross_instance_edges.add((a, b))
    return lg


def _cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components with >1 node, canonically
    rotated; self-loop filtering happens at the caller (RLocks)."""
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v: str):
        worklist = [(v, iter(sorted(graph.get(v, ()))))]
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while worklist:
            node, it = worklist[-1]
            advanced = False
            for w in it:
                if w not in graph:
                    continue
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    worklist.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            worklist.pop()
            if worklist:
                parent = worklist[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == idx[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    pivot = min(comp)
                    i = comp.index(pivot)
                    out.append(comp[i:] + comp[:i])

    for v in sorted(graph):
        if v not in idx:
            strong(v)
    return out


def run(index: ProjectIndex) -> List[Finding]:
    lg = build_lock_graph(index)
    findings: List[Finding] = []

    for fid, fl in sorted(lg.per_func.items()):
        func = index.functions[fid]
        for lock, line in fl.self_pairs:
            if lg.kinds.get(lock, "rlock") == "lock":
                findings.append(Finding(
                    PASS_ID, "self-deadlock", func.module,
                    func.qualname, line,
                    f"non-reentrant lock `{lock}` re-acquired while "
                    f"held (threading.Lock deadlocks on itself)",
                    f"self:{lock}"))
        # re-acquiring the held lock through a method of the SAME
        # instance (``self.``-routed call AND a held lock that is THIS
        # instance's own attribute — `self._lock`, not a structurally-
        # equal `self.other._lock`) deadlocks a non-reentrant Lock;
        # structurally-same ids on two instances are NOT conflated —
        # only must-alias routes (self, or parametric flow) report
        for call in fl.calls:
            if not call.via_self:
                continue
            callee = lg.per_func.get(call.target)
            if callee is None:
                continue
            for held, held_chain in call.held:
                own_attr = (held_chain is not None
                            and held_chain.startswith("self.")
                            and len(held_chain.split(".")) == 2)
                if own_attr and held in callee.own_acquired \
                        and lg.kinds.get(held, "rlock") == "lock":
                    findings.append(Finding(
                        PASS_ID, "self-deadlock", func.module,
                        func.qualname, call.line,
                        f"calls `{call.target.split(':')[-1]}` which "
                        f"re-acquires held non-reentrant `{held}` "
                        f"(threading.Lock deadlocks on itself)",
                        f"self:{held}"))
        for held, chain, line in fl.rpc_under:
            findings.append(Finding(
                PASS_ID, "lock-over-rpc", func.module, func.qualname,
                line,
                f"blocking call `{chain}()` while holding `{held}`: "
                f"a slow peer stalls every thread behind this lock",
                f"rpc:{held}:{chain}"))

    for lock, fid, line in lg.param_self_cycles:
        func = index.functions[fid]
        findings.append(Finding(
            PASS_ID, "self-deadlock", func.module, func.qualname, line,
            f"non-reentrant `{lock}` flows through a call argument "
            f"into a blocking re-acquire while held (must-alias: the "
            f"parameter IS the held lock)",
            f"self:{lock}"))

    for comp in _cycles(lg.graph):
        mod_name, qual, line = lg.edge_site.get(
            (comp[0], comp[1] if len(comp) > 1 else comp[0]),
            (comp[0].split(":")[0].rsplit(".", 1)[0], "", 1))
        cyc = " -> ".join(comp + [comp[0]])
        cross = [f"{a} -> {b}" for a, b in sorted(
            lg.cross_instance_edges)
            if a in comp and b in comp]
        detail = f" [cross-instance: {'; '.join(cross)}]" if cross \
            else ""
        findings.append(Finding(
            PASS_ID, "lock-cycle", mod_name, qual, line,
            f"lock acquisition cycle: {cyc} (AB-BA deadlock when the "
            f"orders interleave){detail}", f"cycle:{'|'.join(comp)}"))
    return findings
