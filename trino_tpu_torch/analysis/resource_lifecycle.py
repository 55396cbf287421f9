"""resource-lifecycle pass: every constructed closeable reaches
``close()`` on all paths.

Leaked spool cursors, unclosed channels and a finalizer
resurrection race were each fixed BY HAND once; this pass turns
that review into structure. A CLOSEABLE is any class in the package
that defines ``close()`` (``SpoolCursor``, exchange channels, spillers,
retained streams, sinks) plus the ``open()`` builtin; factory
functions whose every return is a closeable construction
(``spool_channel``, ``spool_task_cursor``) propagate closeability to
their callers.

A construction site is SATISFIED when the object provably cannot leak:

- constructed in a ``with`` item (``__exit__`` owns it);
- ``close()``d inside a ``finally`` block (every path runs it);
- registered into a teardown collection (``state.channels.append`` /
  ``.extend``) or handed to ``weakref.finalize`` — modeled as any use
  of the object as a call ARGUMENT (ownership transfer: the callee or
  the registry is now responsible);
- escaping the frame: returned/yielded, stored into ``self.*`` / a
  module global / a container (the owner's own ``close()`` is its
  contract), or re-aliased into an escaping name.

Otherwise:

- ``leaked-closeable``: no ``close()`` on any path and no escape — the
  object dies by GC at an arbitrary point (fds/files/retained frames
  outlive the query; under refcount pressure the finalizer class
  fires at arbitrary stack depths);
- ``close-not-guaranteed``: a straight-line ``close()`` exists but not
  under ``finally``/``with`` — any exception between construction and
  close leaks it.

Deliberate transfers the analysis cannot see opt out per line with
``# qlint: ignore[resource-lifecycle] <reason>``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (FastVisitor, Finding, FunctionInfo, ModuleInfo,
                   ProjectIndex, dotted_chain, own_nodes)

PASS_ID = "resource-lifecycle"

#: methods that discharge a closeable beside close() itself
_CLOSE_METHODS = {"close", "abort", "finish", "release", "stop"}


def closeable_classes(index: ProjectIndex) -> Dict[str, List[str]]:
    """class name -> defining modules, for every class in the package
    with a ``close()`` method — the not-blind witness for the tier-1
    gate (≥5 on the real repo: cursors, channels, spillers, sinks)."""
    out: Dict[str, List[str]] = {}
    for name in sorted(index.modules):
        mod = index.modules[name]
        for cls, methods in sorted(mod.classes.items()):
            if "close" in methods:
                out.setdefault(cls, []).append(name)
    return out


def closeable_factories(index: ProjectIndex,
                        classes: Dict[str, List[str]]) -> Set[str]:
    """Function ids whose every return is a construction (or factory
    call) of a closeable — callers of ``spool_channel(...)`` hold a
    closeable exactly as if they had called the constructor."""
    out: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for func in index.iter_functions():
            if func.id in out:
                continue
            mod = index.modules[func.module]
            returns = [n for n in own_nodes(func.node)
                       if isinstance(n, ast.Return)]
            if not returns:
                continue
            all_closeable = True
            for r in returns:
                if not (isinstance(r.value, ast.Call) and
                        _constructs(index, mod, func, r.value,
                                    classes, out)):
                    all_closeable = False
                    break
            if all_closeable:
                out.add(func.id)
                changed = True
    return out


def _constructs(index: ProjectIndex, mod: ModuleInfo,
                func: FunctionInfo, call: ast.Call,
                classes: Dict[str, List[str]],
                factories: Set[str]) -> Optional[str]:
    """The closeable class/factory name when ``call`` constructs a
    closeable this pass tracks, else None. Constructor resolution is
    must-alias: the called name must resolve to an INDEXED class with
    ``close()`` (same module or from-import), to a known factory, or
    be the ``open`` builtin."""
    chain = dotted_chain(call.func)
    if chain is None:
        return None
    if chain == "open":
        return "open"
    target = index.resolve(mod, func, chain)
    if target is not None and target in factories:
        return target.split(":")[-1]
    parts = chain.split(".")
    name = parts[-1]
    if name not in classes:
        return None
    site = index._class_site(mod, name)
    if site is not None and name in classes \
            and site[0] in classes[name]:
        return name
    return None


class _Lifecycle(FastVisitor):
    """Track one function's closeable locals: construction sites,
    closes (and whether they sit under a ``finally``), escapes."""

    def __init__(self, index: ProjectIndex, mod: ModuleInfo,
                 func: FunctionInfo, classes: Dict[str, List[str]],
                 factories: Set[str]):
        self.index = index
        self.mod = mod
        self.func = func
        self.classes = classes
        self.factories = factories
        #: var -> (class name, line)
        self.constructed: Dict[str, Tuple[str, int]] = {}
        self.with_managed: Set[str] = set()
        self.closed_finally: Set[str] = set()
        self.closed_plain: Set[str] = set()
        self.escaped: Set[str] = set()
        #: constructions whose value is immediately dropped
        self.dropped: List[Tuple[str, int]] = []
        self._finally_depth = 0

    # -- helpers ---------------------------------------------------------

    def _note_escapes_in(self, expr: Optional[ast.AST]):
        """Names ESCAPING through ``expr``: bare name references and
        call arguments transfer ownership; the receiver of a method
        call (``cur.poll()``) and attribute/item READS
        (``cursor.path``) are uses, not escapes."""
        if expr is None:
            return
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    self.escaped.add(node.id)
                continue
            if isinstance(node, ast.Call):
                stack.extend(node.args)
                stack.extend(kw.value for kw in node.keywords)
                if not isinstance(node.func, ast.Attribute):
                    stack.append(node.func)
                continue
            if isinstance(node, (ast.Attribute, ast.Subscript)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    # -- visitors --------------------------------------------------------

    def visit_Assign(self, node: ast.Assign):
        value = node.value
        is_ctor = isinstance(value, ast.Call) and _constructs(
            self.index, self.mod, self.func, value, self.classes,
            self.factories)
        plain_local = (len(node.targets) == 1
                       and isinstance(node.targets[0], ast.Name))
        if is_ctor and plain_local:
            name = node.targets[0].id
            self.constructed.setdefault(
                name, (is_ctor, node.lineno))
            # arguments to the constructor itself are ordinary uses
            for a in list(value.args) + [kw.value
                                         for kw in value.keywords]:
                self._note_escapes_in(a)
        else:
            # value flowing into an attribute/subscript/module target
            # escapes (ownership transfer); re-aliasing `b = a` makes
            # `a` escape conservatively (b's fate is untracked)
            self._note_escapes_in(value)
            if is_ctor and not plain_local:
                pass   # self.x = C(...): ownership moved to the object
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        chain = dotted_chain(node.func)
        if chain is not None:
            parts = chain.split(".")
            if len(parts) == 2 and parts[1] in _CLOSE_METHODS \
                    and parts[0] in self.constructed:
                if self._finally_depth > 0:
                    self.closed_finally.add(parts[0])
                else:
                    self.closed_plain.add(parts[0])
        # any value used as a call ARGUMENT transfers ownership
        # (append into a teardown list, weakref.finalize, a consumer)
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            self._note_escapes_in(a)
        self.generic_visit(node)

    def visit_With(self, node: ast.With):
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call) and _constructs(
                    self.index, self.mod, self.func, expr,
                    self.classes, self.factories):
                if isinstance(item.optional_vars, ast.Name):
                    self.with_managed.add(item.optional_vars.id)
                # anonymous `with C():` is managed by __exit__ — fine
            elif isinstance(expr, ast.Name):
                # `with cursor:` on an already-constructed local
                self.with_managed.add(expr.id)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Try(self, node: ast.Try):
        for part in (node.body, node.orelse):
            for stmt in part:
                self.visit(stmt)
        for handler in node.handlers:
            for stmt in handler.body:
                self.visit(stmt)
        self._finally_depth += 1
        for stmt in node.finalbody:
            self.visit(stmt)
        self._finally_depth -= 1

    def visit_Return(self, node: ast.Return):
        self._note_escapes_in(node.value)
        self.generic_visit(node)

    def visit_Yield(self, node: ast.Yield):
        self._note_escapes_in(node.value)
        self.generic_visit(node)

    def visit_YieldFrom(self, node: ast.YieldFrom):
        self._note_escapes_in(node.value)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr):
        value = node.value
        if isinstance(value, ast.Call):
            ctor = _constructs(self.index, self.mod, self.func, value,
                               self.classes, self.factories)
            if ctor:
                self.dropped.append((ctor, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if node is not self.func.node:
            return   # nested def: analyzed via its own FunctionInfo
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def run(index: ProjectIndex) -> List[Finding]:
    classes = closeable_classes(index)
    factories = closeable_factories(index, classes)
    findings: List[Finding] = []
    for func in index.iter_functions():
        mod = index.modules[func.module]
        lc = _Lifecycle(index, mod, func, classes, factories)
        for stmt in func.body:
            lc.visit(stmt)
        for name, (cls, line) in sorted(lc.constructed.items()):
            if name in lc.with_managed or name in lc.closed_finally \
                    or name in lc.escaped:
                continue
            if name in lc.closed_plain:
                findings.append(Finding(
                    PASS_ID, "close-not-guaranteed", func.module,
                    func.qualname, line,
                    f"`{name}` ({cls}) is closed on the straight-line "
                    f"path only — an exception between construction "
                    f"and close() leaks it (use with/finally, or "
                    f"register it in a teardown list)",
                    f"plain-close:{cls}:{name}"))
            else:
                findings.append(Finding(
                    PASS_ID, "leaked-closeable", func.module,
                    func.qualname, line,
                    f"`{name}` ({cls}) is constructed but never "
                    f"reaches close() on any path and never escapes "
                    f"this frame — it leaks until GC",
                    f"leak:{cls}:{name}"))
        for cls, line in lc.dropped:
            findings.append(Finding(
                PASS_ID, "leaked-closeable", func.module,
                func.qualname, line,
                f"constructed {cls} is dropped on the floor — nothing "
                f"can ever close it",
                f"drop:{cls}"))
    return findings
