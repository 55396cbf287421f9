"""Shared static-analysis core: module index, function table, call
graph, alias tracking, pragma handling.

Everything is stdlib ``ast`` over source text — the analyzed package is
never imported, so the analyzer runs without torch (and cannot be fooled
by import-time machinery). Resolution is deliberately conservative:
only unambiguous targets (same-scope names, ``self.`` methods on the
enclosing class, imported-module attributes, annotated parameters)
resolve to call-graph edges; everything else stays a raw dotted chain
for pattern-based checks. Over-approximating the graph would flood the
purity/lock passes with false paths, under-approximating loses real
ones — unambiguous-only is the tested middle ground, and the fixture
tests in ``tests/test_torch_static_analysis.py`` pin what each pass must
still catch through it.

Alias tracking extends resolution with MUST-alias facts
only — every fact is a definite "these two names denote the same
object", never a may-alias guess, so the lock/lifecycle passes can
unify identities without fabricating false cycles:

- ``FunctionInfo.aliases``: single-assignment locals bound from a
  dotted chain (``lock = self._lock``) expand in place during
  resolution (``canonical_chain``);
- ``ModuleInfo.attr_types``: ``self.x = <annotated param>`` /
  ``self.x = ClassName(...)`` / ``self.x: ClassName`` in a method body
  types the attribute, so chains like ``self.ledger.park()`` or
  ``pool.host_ledger.charge()`` resolve through ``instance_type`` —
  the seam that lets lock-order unify CROSS-INSTANCE lock identities
  structurally (ambiguous re-assignments tombstone the attr);
- ``FunctionInfo.returns_chain``: a method whose every return is the
  same ``self.<attr>`` chain is a returned-attribute accessor —
  ``obj.lock()`` in a with-item denotes the target class's attribute;
- ``bind_args``: maps a resolved call's actual arguments onto the
  callee's parameters, so a lock/resource flowing through
  ``spill_pages(..., lock=ctx.lock)`` keeps its caller-side identity
  inside the callee (parametric substitution in lock-order).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    pass_id: str
    rule: str
    module: str          # dotted module name
    qualname: str        # enclosing function ("" = module level)
    line: int
    message: str
    subject: str         # stable discriminator (no line numbers)

    @property
    def key(self) -> str:
        """Stable baseline key — no line numbers, so unrelated edits
        don't churn the baseline."""
        return (f"{self.pass_id}:{self.rule}:{self.module}:"
                f"{self.qualname or '<module>'}:{self.subject}")

    def render(self) -> str:
        return (f"{self.module}:{self.line} [{self.pass_id}/{self.rule}] "
                f"{(self.qualname + ': ') if self.qualname else ''}"
                f"{self.message}")

    def to_dict(self) -> dict:
        return {"pass": self.pass_id, "rule": self.rule,
                "module": self.module, "qualname": self.qualname,
                "line": self.line, "message": self.message,
                "key": self.key}


@dataclass
class CallSite:
    chain: str                   # dotted source text of the callee
    node: ast.Call
    target: Optional[str] = None  # resolved function id, if unambiguous

    @property
    def line(self) -> int:
        return self.node.lineno


@dataclass
class FunctionInfo:
    module: str
    qualname: str                # Class.method / func / outer.inner
    node: ast.AST                # FunctionDef | AsyncFunctionDef | Lambda
    class_name: Optional[str]
    scope: str                   # enclosing scope qualname ("" = module)
    params: List[str] = field(default_factory=list)
    #: parameter name -> annotated class name (string), best-effort
    annotations: Dict[str, str] = field(default_factory=dict)
    decorators: List[ast.expr] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    #: single-assignment local name -> the dotted chain it MUST alias
    #: (``lock = self._lock``); names bound more than once, bound by
    #: loops/with/aug-assign, or shadowing a parameter never enter
    aliases: Dict[str, str] = field(default_factory=dict)
    #: per-name binding counts in this body (shared with lock-order's
    #: chain-stability check — computed once, alongside ``aliases``)
    bindings: Dict[str, int] = field(default_factory=dict)
    #: when every ``return`` in the body returns the SAME dotted chain
    #: (``return self._lock``) — the returned-attribute-accessor seam
    returns_chain: Optional[str] = None

    @property
    def id(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def body(self) -> list:
        return self.node.body


_PRAGMA_RE = re.compile(r"#\s*qlint:\s*ignore\[([a-z*,\s-]+)\]\s*(.*)$")


def own_nodes(func_node) -> Iterator[ast.AST]:
    """Walk a function body EXCLUDING nested function bodies (they get
    their own FunctionInfo); lambdas stay attributed to this frame —
    the same ownership rule ``_collect_calls`` uses. Every pass walks
    the same bodies, so the walk is kept on the node after the first."""
    nodes = getattr(func_node, "_qlint_own", None)
    if nodes is None:
        nodes = []
        stack: List[ast.AST] = [func_node]
        while stack:
            node = stack.pop()
            nodes.append(node)
            for child in child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                stack.append(child)
        func_node._qlint_own = nodes
    return iter(nodes)


def child_nodes(node: ast.AST) -> List[ast.AST]:
    """``ast.iter_child_nodes(node)`` as a list, kept on the node after
    the first walk (every pass's visitor walks the same trees)."""
    kids = getattr(node, "_qlint_kids", None)
    if kids is None:
        kids = []
        for name in node._fields:
            value = getattr(node, name, None)
            if isinstance(value, ast.AST):
                kids.append(value)
            elif isinstance(value, list):
                kids.extend(v for v in value if isinstance(v, ast.AST))
        node._qlint_kids = kids
    return kids


def walk_all(tree: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(tree))`` (the same breadth-first order), keeping
    every node's children for the later walks."""
    nodes = [tree]
    i = 0
    while i < len(nodes):
        nodes.extend(child_nodes(nodes[i]))
        i += 1
    return nodes


def _visit_nothing(_visitor, _node):
    return None


class FastVisitor(ast.NodeVisitor):
    """``ast.NodeVisitor`` with the same visiting order and semantics,
    minus its per-node costs: the ``visit_<Class>`` method is looked up
    once per (visitor class, node class), and children come from
    ``child_nodes``. A node class the visitor does not handle and that
    has no AST children (``Constant``) is skipped outright."""

    #: visitor class -> {node class -> unbound visit function}
    _tables: Dict[type, Dict[type, object]] = {}

    @classmethod
    def _method(cls, node_cls: type):
        table = FastVisitor._tables.setdefault(cls, {})
        fn = getattr(cls, "visit_" + node_cls.__name__, None)
        if fn is None or fn is ast.NodeVisitor.visit_Constant:
            fn = _visit_nothing if issubclass(node_cls, ast.Constant) \
                else cls.generic_visit
        table[node_cls] = fn
        return fn

    def visit(self, node):
        cls = type(self)
        fn = FastVisitor._tables.get(cls, {}).get(type(node)) \
            or cls._method(type(node))
        return fn(self, node)

    def generic_visit(self, node):
        cls = type(self)
        table = FastVisitor._tables.get(cls) or {}
        for child in child_nodes(node):
            fn = table.get(type(child))
            if fn is None:
                fn = cls._method(type(child))
                table = FastVisitor._tables[cls]
            fn(self, child)


class ModuleInfo:
    def __init__(self, name: str, source: str, path: str = "<memory>",
                 is_package: bool = False):
        self.name = name
        self.path = path
        #: True for a package __init__: its relative imports resolve
        #: against the package itself, not the parent
        self.is_package = is_package
        self.tree = ast.parse(source, filename=path)
        #: ``ast.walk(self.tree)``, walked once for every pass
        self.nodes: List[ast.AST] = walk_all(self.tree)
        #: alias -> dotted module (``import a.b as c`` and
        #: ``from pkg import mod`` both land here when mod is a module)
        self.imports: Dict[str, str] = {}
        #: name -> (dotted module, original name) for from-imports
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        #: names bound by module-level assignments (not defs/imports)
        self.module_assigns: Set[str] = set()
        for stmt in self.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    self.module_assigns.add(t.id)
        #: scope qualname -> {visible def name -> qualname}
        self.scopes: Dict[str, Dict[str, str]] = {"": {}}
        #: class name -> {method name -> qualname}
        self.classes: Dict[str, Dict[str, str]] = {}
        #: line -> set of pass slugs suppressed there
        self.pragmas: Dict[int, Set[str]] = {}
        #: line -> the trailing reason text after the pragma ("" = bare
        #: pragma, which the framework audit reports as a finding)
        self.pragma_reasons: Dict[int, str] = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                self.pragmas[i] = {p.strip()
                                   for p in m.group(1).split(",")}
                self.pragma_reasons[i] = m.group(2).strip()
        #: class name -> {attr name -> class name} typed from method
        #: bodies (``self.x = <annotated param>`` / ``= ClassName()`` /
        #: ``self.x: ClassName``); conflicting assignments tombstone
        #: the attr with "" so ambiguity never resolves
        self.attr_types: Dict[str, Dict[str, str]] = {}
        self._collect()

    # -- collection ------------------------------------------------------

    def _collect(self):
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or
                                 alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom):
                target = self._resolve_from(node)
                if target is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.from_imports[alias.asname or alias.name] = \
                        (target, alias.name)
        self._walk_scope(self.tree.body, scope="", class_name=None)
        self._collect_attr_types()

    def _collect_attr_types(self):
        """Type ``self.<attr>`` from method bodies: an annotated-param
        store, a direct ``ClassName(...)`` construction, or an
        annotated ``self.x: T`` assignment each give a definite class;
        two different candidates for one attr tombstone it ("") —
        must-alias or nothing."""
        def note(cls: str, attr: str, type_name: Optional[str]):
            if type_name is None:
                return
            attrs = self.attr_types.setdefault(cls, {})
            if attrs.get(attr, type_name) != type_name:
                attrs[attr] = ""      # ambiguous: never resolves
            else:
                attrs[attr] = type_name

        for info in self.functions.values():
            if info.class_name is None:
                continue
            for node in own_nodes(info.node):
                target = None
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1:
                    target = node.targets[0]
                elif isinstance(node, ast.AnnAssign):
                    target = node.target
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    continue
                attr = target.attr
                if isinstance(node, ast.AnnAssign):
                    # unresolvable annotations (containers, unions)
                    # tombstone rather than silently keeping a type
                    note(info.class_name, attr,
                         _annotation_name(node.annotation) or "")
                    continue
                value = node.value
                if isinstance(value, ast.Constant) \
                        and value.value is None:
                    continue   # `self.x = None` idles a typed attr
                candidate = ""   # default: untypeable -> tombstone
                if isinstance(value, ast.Name):
                    # a rebind from an UNannotated name makes the attr
                    # ambiguous — tombstone, don't keep a stale type
                    candidate = info.annotations.get(value.id) or ""
                elif isinstance(value, ast.Call):
                    chain = dotted_chain(value.func)
                    if chain is not None:
                        last = chain.split(".")[-1]
                        if last[:1].isupper():
                            candidate = last
                note(info.class_name, attr, candidate)

    def enclosing_function(self, line: int) -> Optional["FunctionInfo"]:
        """Innermost function whose def spans ``line`` (None = module
        level) — shared by every pass that anchors a finding to its
        enclosing function."""
        best = None
        for info in self.functions.values():
            node = info.node
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                if best is None or node.lineno > best.node.lineno:
                    best = info
        return best

    def _resolve_from(self, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        # relative import: strip ``level`` trailing components from
        # this module's dotted name. A leaf module's level=1 is its
        # package; a package __init__'s level=1 is the package ITSELF
        # (model it as a phantom leaf)
        parts = self.name.split(".")
        if self.is_package:
            parts = parts + ["__init__"]
        if node.level > len(parts):
            return None
        base = parts[:len(parts) - node.level]
        if node.module:
            base.append(node.module)
        return ".".join(base)

    def _walk_scope(self, body: Sequence[ast.stmt], scope: str,
                    class_name: Optional[str]):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{scope}.{stmt.name}" if scope else stmt.name
                info = FunctionInfo(self.name, qual, stmt, class_name,
                                    scope)
                info.params = [a.arg for a in
                               stmt.args.posonlyargs + stmt.args.args
                               + stmt.args.kwonlyargs]
                for a in stmt.args.posonlyargs + stmt.args.args \
                        + stmt.args.kwonlyargs:
                    ann = _annotation_name(a.annotation)
                    if ann:
                        info.annotations[a.arg] = ann
                info.decorators = list(stmt.decorator_list)
                info.calls = _collect_calls(stmt)
                info.bindings = _binding_counts(stmt)
                info.aliases = _collect_aliases(info)
                info.returns_chain = _returns_chain(stmt)
                self.functions[qual] = info
                self.scopes.setdefault(scope, {})[stmt.name] = qual
                if class_name is not None and scope == class_name:
                    self.classes.setdefault(class_name, {})[stmt.name] \
                        = qual
                # nested defs live in the function's scope; a method's
                # class context does not extend to its inner functions
                self._walk_scope(stmt.body, qual, None)
            elif isinstance(stmt, ast.ClassDef):
                self.classes.setdefault(stmt.name, {})
                self.scopes.setdefault(scope, {})[stmt.name] = stmt.name
                self._walk_scope(stmt.body, stmt.name, stmt.name)
            elif isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                                   ast.While)):
                # statements nested in control flow at any scope
                for field_name in ("body", "orelse", "finalbody"):
                    self._walk_scope(getattr(stmt, field_name, []) or [],
                                     scope, class_name)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._walk_scope(handler.body, scope, class_name)


def _annotation_name(node) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip('"')
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript) \
            and _annotation_name(node.value) == "Optional":
        # Optional[X] types an attribute that idles at None — the
        # `self._cur: Optional[SpoolCursor] = None` idiom
        return _annotation_name(node.slice)
    return None


def _binding_counts(func_node) -> Dict[str, int]:
    """How many times each local name is BOUND in this function's own
    body — a must-alias requires exactly one binding (loops, tuple
    unpacks, walrus, with-as and except-as all count as bindings)."""
    counts: Dict[str, int] = {}

    def bump(target):
        if isinstance(target, ast.Name):
            counts[target.id] = counts.get(target.id, 0) + 1
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                bump(e)
        elif isinstance(target, ast.Starred):
            bump(target.value)

    for node in own_nodes(func_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bump(t)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                               ast.NamedExpr)):
            bump(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bump(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    bump(item.optional_vars)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            counts[node.name] = counts.get(node.name, 0) + 1
        elif isinstance(node, ast.comprehension):
            bump(node.target)
    return counts


def _collect_aliases(info: "FunctionInfo") -> Dict[str, str]:
    """``name -> chain`` for single-assignment locals bound from a
    dotted chain: the ``lock = self._lock`` rebind that used to hide a
    lock's identity from the passes."""
    counts = info.bindings
    out: Dict[str, str] = {}
    for node in own_nodes(info.node):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not isinstance(t, ast.Name):
            continue
        chain = dotted_chain(node.value)
        if chain is None or chain.split(".")[0] == t.id:
            continue
        if counts.get(t.id, 0) == 1 and t.id not in info.params:
            out[t.id] = chain
    return out


def _returns_chain(func_node) -> Optional[str]:
    """The one ``self.<attr>`` chain every return in the body returns,
    or None — the returned-attribute accessor (``def lock(self):
    return self._lock``) that lets ``obj.lock()`` denote the target
    class's attribute in with-items."""
    chains: Set[Optional[str]] = set()
    saw_return = False
    for node in own_nodes(func_node):
        if isinstance(node, ast.Return):
            saw_return = True
            chains.add(dotted_chain(node.value)
                       if node.value is not None else None)
    if not saw_return or len(chains) != 1:
        return None
    chain = chains.pop()
    if chain and chain.startswith("self.") and len(chain.split(".")) == 2:
        return chain
    return None


def bind_args(callee: "FunctionInfo", call: ast.Call, chain: str,
              index: Optional["ProjectIndex"] = None,
              mod: Optional["ModuleInfo"] = None) -> Dict[str, ast.expr]:
    """Map a resolved call's actual argument expressions onto the
    callee's parameter names, the way Python would: positionals bind
    only positional parameters (never keyword-only), excess
    positionals fall into ``*args`` (unbindable — dropped, since a
    wrong binding would fabricate a must-alias fact), and ``self`` is
    skipped for attribute-form calls UNLESS the attribute base is a
    class (an unbound ``Class.method(obj, ...)`` call binds ``self``
    positionally). The seam that keeps an object flowing through
    ``spill_pages(..., lock=ctx.lock)`` identified with the caller's
    ``ctx.lock`` inside the callee."""
    args_node = callee.node.args
    pos_names = [a.arg for a in
                 args_node.posonlyargs + args_node.args]
    if pos_names and pos_names[0] in ("self", "cls") and "." in chain:
        head = chain.split(".")[0]
        unbound = (index is not None and mod is not None
                   and index._class_site(mod, head) is not None)
        if not unbound:
            pos_names = pos_names[1:]
    bound: Dict[str, ast.expr] = {}
    for name, arg in zip(pos_names, call.args):
        if isinstance(arg, ast.Starred):
            break   # splat: everything from here is position-unknown
        bound[name] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            bound[kw.arg] = kw.value
    return bound


def dotted_chain(node) -> Optional[str]:
    """``a.b.c`` source chain for a Name/Attribute expression, or None
    when the base is a call/subscript (unresolvable)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _collect_calls(func_node) -> List[CallSite]:
    """Every Call in the function body, in ``ast.NodeVisitor`` order
    (pre-order, children in field order), EXCLUDING nested function
    bodies (those get their own FunctionInfo); lambdas stay attributed
    to the enclosing function: they are deferred but almost always
    invoked from this frame."""
    calls: List[CallSite] = []
    stack: List[ast.AST] = [func_node]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain is not None:
                calls.append(CallSite(chain, node))
        for child in reversed(child_nodes(node)):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue   # nested def: its calls belong to it
            stack.append(child)
    return calls


#: request-handler base classes whose methods run on server threads
#: (stdlib socketserver / http.server dispatch)
_HANDLER_BASES = {"BaseRequestHandler", "StreamRequestHandler",
                  "DatagramRequestHandler", "BaseHTTPRequestHandler",
                  "SimpleHTTPRequestHandler"}

#: chains that construct a thread whose ``target=`` runs off-thread
_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}


@dataclass(frozen=True)
class ThreadEntry:
    """One function that runs OFF the main thread, and how it gets
    there — the entry half of the guarded-by pass's thread model."""
    func_id: str
    kind: str            # thread | timer | executor | rpc-handler |
    #                      finalizer
    spawn_module: str    # where the spawn/registration happens
    spawn_line: int


def _spawn_call(node: ast.Call,
                chain: str) -> Optional[Tuple[str, Optional[ast.expr]]]:
    """(entry kind, callable expression) when ``node`` hands work to
    another thread — THE one spawn predicate, shared by the entry
    index and the spawn-site map so the two can never drift. The
    callable expr is None for a spawn whose target is absent."""
    parts = chain.split(".")
    if chain in _THREAD_CTORS:
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        return "thread", target
    if chain in _TIMER_CTORS and len(node.args) >= 2:
        return "timer", node.args[1]
    if parts[-1] == "submit" and len(parts) > 1 and node.args:
        # executor-shaped: the callable is the first argument; a
        # data-carrying .submit(obj) never resolves to a function,
        # so it cannot enter the index
        return "executor", node.args[0]
    if parts[-1] == "finalize" and parts[0] in ("weakref", "finalize") \
            and len(node.args) >= 2:
        return "finalizer", node.args[1]
    return None


def _spawn_scan(index: "ProjectIndex"
                ) -> Tuple[Dict[str, ThreadEntry],
                           Dict[str, List[int]]]:
    """ONE project walk feeding both spawn views: the thread-entry
    index (resolved targets only — must-alias, an unresolvable
    callable can never fabricate an entry; first spawn site wins) and
    the per-function spawn-line map (every spawn-shaped call,
    resolved or not — an unresolvable Thread target still publishes
    ``self`` to another thread)."""
    entries: Dict[str, ThreadEntry] = {}
    spawns: Dict[str, List[int]] = {}

    def add(target: Optional[str], kind: str, mod: "ModuleInfo",
            line: int):
        if target is not None and target in index.functions \
                and target not in entries:
            entries[target] = ThreadEntry(target, kind, mod.name, line)

    for mod_name in sorted(index.modules):
        mod = index.modules[mod_name]
        # spawn call forms, anywhere in the module tree (module-level
        # spawns live outside any FunctionInfo)
        for node in mod.nodes:
            if isinstance(node, ast.ClassDef):
                bases = {(dotted_chain(b) or "").split(".")[-1]
                         for b in node.bases}
                if bases & _HANDLER_BASES:
                    for name, qual in mod.classes.get(node.name,
                                                      {}).items():
                        if name == "handle" or name.startswith("do_"):
                            add(f"{mod.name}:{qual}", "rpc-handler",
                                mod, node.lineno)
                continue
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_chain(node.func)
            if chain is None:
                continue
            hit = _spawn_call(node, chain)
            if hit is None:
                continue
            kind, target_expr = hit
            info = mod.enclosing_function(node.lineno)
            if info is not None:
                spawns.setdefault(info.id, []).append(node.lineno)
            target_chain = dotted_chain(target_expr) \
                if target_expr is not None else None
            if target_chain is not None:
                add(index.resolve(mod, info, target_chain), kind,
                    mod, node.lineno)
    return entries, spawns


def thread_entries(index: "ProjectIndex") -> Dict[str, ThreadEntry]:
    """Every function the project hands to another thread, keyed by
    function id: ``threading.Thread(target=f)`` / ``Timer(..., f)``
    targets, ``<executor>.submit(f, ...)`` callables, methods of
    ``*RequestHandler`` subclasses (``handle`` / ``do_*`` run on server
    threads), and ``weakref.finalize(obj, f, ...)`` callbacks (GC runs
    them on whichever thread drops the last reference)."""
    return _spawn_scan(index)[0]


def thread_reachable(index: "ProjectIndex",
                     entries: Optional[Dict[str, ThreadEntry]] = None
                     ) -> Dict[str, Set[str]]:
    """function id -> the set of thread-entry ids that reach it over
    resolved call edges (entries reach themselves). Functions absent
    from the map run only where their callers run — for a zero-in-edge
    function, the main thread."""
    if entries is None:
        entries = thread_entries(index)
    reached: Dict[str, Set[str]] = {}
    for eid in sorted(entries):
        stack = [eid]
        while stack:
            cur = stack.pop()
            tags = reached.setdefault(cur, set())
            if eid in tags:
                continue
            tags.add(eid)
            func = index.functions.get(cur)
            if func is None:
                continue
            for call in func.calls:
                if call.target and call.target in index.functions:
                    stack.append(call.target)
    return reached


def spawn_sites(index: "ProjectIndex") -> Dict[str, List[int]]:
    """function id -> lines inside that function where a thread is
    spawned/registered (the shared ``_spawn_call`` predicate). The
    immutable-after-init exemption needs this: a ``self.x = ...`` in
    ``__init__`` AFTER a spawn line already races the spawned
    thread."""
    return _spawn_scan(index)[1]


class ProjectIndex:
    """All modules of one package, with cross-module call resolution."""

    def __init__(self, modules: Dict[str, ModuleInfo]):
        self.modules = modules
        self.functions: Dict[str, FunctionInfo] = {}
        for mod in modules.values():
            for info in mod.functions.values():
                self.functions[info.id] = info
        for mod in modules.values():
            for info in mod.functions.values():
                for call in info.calls:
                    call.target = self.resolve(mod, info, call.chain)

    # -- construction ----------------------------------------------------

    @classmethod
    def from_package(cls, package_path: str,
                     package_name: Optional[str] = None,
                     exclude: Sequence[str] = ("analysis",)
                     ) -> "ProjectIndex":
        """Index every .py under ``package_path``. ``exclude`` names
        top-level subpackages to skip (the analyzer does not analyze
        itself by default — it would only find its own pattern
        tables)."""
        package_path = os.path.abspath(package_path)
        if package_name is None:
            package_name = os.path.basename(package_path.rstrip("/"))
        modules: Dict[str, ModuleInfo] = {}
        for root, dirs, files in os.walk(package_path):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__"
                             and not (root == package_path
                                      and d in exclude))
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(root, fn)
                rel = os.path.relpath(path, package_path)
                parts = rel[:-3].split(os.sep)
                is_package = parts[-1] == "__init__"
                if is_package:
                    parts = parts[:-1]
                name = ".".join([package_name] + parts) if parts \
                    else package_name
                with open(path, encoding="utf-8") as f:
                    modules[name] = ModuleInfo(name, f.read(), path,
                                               is_package=is_package)
        return cls(modules)

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     packages: Sequence[str] = ()) -> "ProjectIndex":
        """Fixture entry: {dotted module name: source text};
        ``packages`` names entries that model a package __init__."""
        return cls({name: ModuleInfo(name, src,
                                     is_package=name in packages)
                    for name, src in sources.items()})

    # -- resolution ------------------------------------------------------

    def canonical_chain(self, info: Optional[FunctionInfo],
                        chain: str) -> str:
        """Expand leading single-assignment aliases in place:
        ``lock.acquire`` with ``lock = self._lock`` canonicalizes to
        ``self._lock.acquire`` (bounded — a pathological alias chain
        stops expanding rather than looping)."""
        if info is None:
            return chain
        for _ in range(5):
            parts = chain.split(".")
            expansion = info.aliases.get(parts[0])
            if expansion is None:
                return chain
            chain = ".".join([expansion] + parts[1:])
        return chain

    def _class_site(self, mod: ModuleInfo,
                    name: str) -> Optional[Tuple[str, str]]:
        """(module, class) where ``name`` is defined, seen from
        ``mod`` (local class or from-import)."""
        if name in mod.classes:
            return (mod.name, name)
        if name in mod.from_imports:
            target_mod, orig = mod.from_imports[name]
            target = self.modules.get(target_mod)
            if target is not None and orig in target.classes:
                return (target_mod, orig)
        return None

    def instance_type(self, mod: ModuleInfo,
                      info: Optional[FunctionInfo],
                      parts: Sequence[str]
                      ) -> Optional[Tuple[str, str]]:
        """(module, class) of the INSTANCE a dotted chain denotes —
        ``self`` / an annotated parameter at the head, then typed
        attributes (``attr_types``) for every further hop. None
        whenever any hop is unknown or ambiguous: must-alias only."""
        head = parts[0]
        if head in ("self", "cls"):
            if info is None or not info.class_name:
                return None
            site: Optional[Tuple[str, str]] = (mod.name, info.class_name)
        elif info is not None and head in info.annotations:
            site = self._class_site(mod, info.annotations[head])
        else:
            return None
        for attr in parts[1:]:
            if site is None:
                return None
            owner = self.modules.get(site[0])
            if owner is None:
                return None
            type_name = owner.attr_types.get(site[1], {}).get(attr)
            if not type_name:
                return None
            site = self._class_site(owner, type_name)
        return site

    def resolve(self, mod: ModuleInfo, info: Optional[FunctionInfo],
                chain: str) -> Optional[str]:
        """Resolve a dotted call chain to a function id, or None."""
        chain = self.canonical_chain(info, chain)
        parts = chain.split(".")
        head = parts[0]
        if head in ("self", "cls") and info is not None \
                and info.class_name and len(parts) == 2:
            hit = self._method(mod.name, info.class_name, parts[1])
            if hit:
                return hit
        if len(parts) == 1:
            return self._resolve_bare(mod, info, head)
        # instance-typed resolution: self./annotated-param head plus
        # typed-attribute hops (``self.ledger.park()``,
        # ``pool.host_ledger.charge()``)
        site = self.instance_type(mod, info, parts[:-1])
        if site is not None:
            hit = self._method(site[0], site[1], parts[-1])
            if hit:
                return hit
        # annotated parameter: other._lock-style method calls
        if info is not None and head in info.annotations \
                and len(parts) == 2:
            hit = self._method_anywhere(mod, info.annotations[head],
                                        parts[1])
            if hit:
                return hit
        # local or imported class attribute: Class.method
        if len(parts) == 2:
            hit = self._method_anywhere(mod, head, parts[1])
            if hit:
                return hit
        # imported module attribute: mod.func / pkg.mod.func
        for split in range(len(parts) - 1, 0, -1):
            target_mod = self._module_for(mod, parts[:split])
            if target_mod is None:
                continue
            rest = ".".join(parts[split:])
            target = self.modules.get(target_mod)
            if target is not None and rest in target.functions:
                return f"{target_mod}:{rest}"
        return None

    def _resolve_bare(self, mod: ModuleInfo, info: Optional[FunctionInfo],
                      name: str) -> Optional[str]:
        # nearest enclosing scope first: nested defs shadow module level
        if info is not None:
            scope = info.qualname
            while True:
                # class scopes do not participate in bare-name
                # resolution (Python binds `helper()` in a method to
                # the module-level helper, never the sibling method)
                if scope not in mod.classes:
                    names = mod.scopes.get(scope, {})
                    if name in names and names[name] in mod.functions:
                        return f"{mod.name}:{names[name]}"
                if not scope:
                    break
                scope = scope.rsplit(".", 1)[0] if "." in scope else ""
        elif name in mod.scopes.get("", {}):
            qual = mod.scopes[""][name]
            if qual in mod.functions:
                return f"{mod.name}:{qual}"
        if name in mod.from_imports:
            target_mod, orig = mod.from_imports[name]
            target = self.modules.get(target_mod)
            if target is not None and orig in target.functions:
                return f"{target_mod}:{orig}"
        return None

    def _method(self, module: str, class_name: str,
                method: str) -> Optional[str]:
        mod = self.modules.get(module)
        if mod is None:
            return None
        qual = mod.classes.get(class_name, {}).get(method)
        return f"{module}:{qual}" if qual else None

    def _method_anywhere(self, mod: ModuleInfo, class_name: str,
                         method: str) -> Optional[str]:
        hit = self._method(mod.name, class_name, method)
        if hit:
            return hit
        if class_name in mod.from_imports:
            target_mod, orig = mod.from_imports[class_name]
            return self._method(target_mod, orig, method)
        return None

    def _module_for(self, mod: ModuleInfo,
                    parts: Sequence[str]) -> Optional[str]:
        head = parts[0]
        base = None
        if head in mod.imports:
            base = mod.imports[head]
        elif head in mod.from_imports:
            target_mod, orig = mod.from_imports[head]
            candidate = f"{target_mod}.{orig}"
            if candidate in self.modules:
                base = candidate
            elif target_mod in self.modules and orig not in \
                    self.modules[target_mod].functions:
                return None
        if base is None:
            return None
        full = ".".join([base] + list(parts[1:]))
        if full in self.modules:
            return full
        # single-part chains keep their mapped module even when it is
        # external (callers None-check membership themselves)
        return base if len(parts) == 1 else None

    # -- queries ---------------------------------------------------------

    def iter_functions(self) -> Iterator[FunctionInfo]:
        for mod_name in sorted(self.modules):
            mod = self.modules[mod_name]
            for qual in sorted(mod.functions):
                yield mod.functions[qual]

    def suppressed(self, module: str, line: int, pass_id: str) -> bool:
        mod = self.modules.get(module)
        if mod is None:
            return False
        passes = mod.pragmas.get(line)
        return bool(passes) and (pass_id in passes or "*" in passes)

    def decorator_chain(self, dec: ast.expr) -> Optional[str]:
        """Dotted chain of a decorator expression; for a decorator
        CALL (``@functools.lru_cache(maxsize=8)``) the called chain."""
        if isinstance(dec, ast.Call):
            return dotted_chain(dec.func)
        return dotted_chain(dec)
