"""recompile pass: hazards that defeat program reuse or stall the card.

Two rules:

- ``unhashable-arg``: a dict/list/set display (or comprehension)
  flowing into an ``lru_cache``'d builder call — the call raises
  ``TypeError: unhashable`` at runtime, or the caller "fixes" it by
  rebuilding per call and the cache silently never hits. Carried over
  from the JAX engine unchanged.
- ``host-sync``: a host read of a device value inside a device program
  (an entry of ``trace_purity.program_entries`` or any function it
  reaches). The JAX engine's rule here is ``traced-branch``: a Python
  ``if`` on a traced value raises there (or retraces per outcome). In
  eager torch the same code runs — and silently waits for the card to
  drain every launch queued before it, once per call. Flagged:

  - ``if`` / ``while`` / ``not`` / ``and`` / ``or`` / conditional-
    expression tests and ``bool()`` / ``int()`` / ``float()`` on a
    tensor value;
  - ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a tensor
    value (a chain such as ``t.cpu().numpy()`` is one read);
  - a call of the device-read helper (``telemetry.device_reads``:
    ``to_host``, ``to_cpu``, ``host_scalar``) on a tensor value: the
    read is the call, reported where it is made;
  - ``torch.cuda.synchronize()`` and any ``.synchronize()``.

  A tensor value is what the pass can prove is one: a non-static,
  unannotated parameter of a program entry (its device inputs, as a
  jit entry's non-static parameters are traced); a parameter annotated
  ``torch.Tensor``; a ``torch.*`` call's result (except the host-valued
  ones, ``torch.device`` / ``torch.iinfo`` / ...); a tensor's method
  result, attribute, subscript or arithmetic; and a local every
  binding of which is one of those. Static accessors stay host values,
  as in the JAX engine's rule: ``.shape`` / ``.dtype`` / ``.ndim`` /
  ``.size()`` / ``.device`` and ``len()`` / ``isinstance()`` / ``is
  None``; so do the program's ``static_argnames`` and parameters
  annotated with a host type (``int``, ``tuple``, ...).

A host read the JAX engine also makes (it reads the same value on the
host, just outside its jitted function) carries a reasoned pragma
naming the JAX engine's line; one whose counterpart stays on the device
(``lax.while_loop``, ``lax.fori_loop``) is a baseline entry, noted with
that line — the baseline may only shrink.

The cached-builder session-read rule lives in the ``cache-coherence``
pass, which generalizes it to memo-dict builders, env vars and mutable
globals; ``_cached_functions`` stays here as the shared lru index.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from .core import (Finding, FunctionInfo, ProjectIndex, dotted_chain,
                   own_nodes)
from .trace_purity import EntryInfo, program_entries, program_reachable

PASS_ID = "recompile"

_CACHE_CHAINS = {"lru_cache", "functools.lru_cache", "cache",
                 "functools.cache"}
_UNHASHABLE = (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
               ast.SetComp, ast.GeneratorExp)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size"}
#: a tensor's host-valued attributes and methods (beside the above)
_HOST_ATTRS = _STATIC_ATTRS | {
    "device", "is_cuda", "layout", "names", "requires_grad", "is_sparse",
    "dim", "numel", "nelement", "element_size", "itemsize", "data_ptr",
    "get_device", "is_contiguous", "is_floating_point", "is_complex",
    "stride", "storage_offset", "untyped_storage", "type", "nbytes"}
#: methods whose call is the host read itself
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: the device-read helper's functions: each call is one host read
_READ_HELPERS = {"to_host", "to_cpu", "host_scalar"}
#: torch functions that return host values
_TORCH_HOST = {"device", "Size", "is_tensor", "iinfo", "finfo",
               "get_default_dtype", "is_floating_point", "is_complex",
               "promote_types", "result_type", "can_cast", "dtype",
               "Generator", "is_grad_enabled", "numel"}
_TENSOR_ANNOTATIONS = {"Tensor", "torch.Tensor"}
_CASTS = {"bool", "int", "float"}
#: reductions: ``x.any()`` of anything not visibly host data
_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin",
               "count_nonzero", "prod", "mean"}
#: builtins whose result is a host value
_HOST_BUILTINS = {"len", "int", "float", "bool", "str", "range",
                  "isinstance", "hasattr", "getattr", "type", "tuple",
                  "list", "dict", "set", "sorted", "repr", "abs", "round"}
_LITERALS = (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set,
             ast.ListComp, ast.SetComp, ast.DictComp, ast.JoinedStr)


def _cached_functions(index: ProjectIndex) -> Dict[str, FunctionInfo]:
    out: Dict[str, FunctionInfo] = {}
    for func in index.iter_functions():
        for dec in func.decorators:
            if index.decorator_chain(dec) in _CACHE_CHAINS:
                out[func.id] = func
    return out


def _annotation(func: FunctionInfo, name: str) -> Optional[str]:
    """The dotted annotation of parameter ``name`` (``torch.Tensor``,
    ``int``; ``Optional[X]`` reads as X), or None."""
    args = func.node.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.arg != name or a.annotation is None:
            continue
        ann = a.annotation
        if isinstance(ann, ast.Subscript):
            ann = ann.value if dotted_chain(ann.value) != "Optional" \
                else ann.slice
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value
        return dotted_chain(ann) or ""
    return None


#: the three verdicts of ``_Kinds``
TENSOR, HOST, UNKNOWN = "tensor", "host", "unknown"


class _Kinds:
    """Which expressions of one function are provably tensors, provably
    host values, or unknown (see the module docstring). Locals take the
    verdict every binding of theirs agrees on: tensors as a greatest
    fixed point (every candidate starts a tensor and loses it at its
    first other binding), then host values the same way among the
    rest."""

    def __init__(self, func: FunctionInfo, entry: Optional[EntryInfo]):
        self.kinds: Dict[str, str] = {}
        for p in func.params:
            ann = _annotation(func, p)
            if ann in _TENSOR_ANNOTATIONS:
                self.kinds[p] = TENSOR
            elif ann is None:
                self.kinds[p] = TENSOR if entry is not None \
                    and p not in entry.static_params \
                    and p not in ("self", "cls") else UNKNOWN
            else:
                self.kinds[p] = HOST
        bindings: Dict[str, List[Optional[ast.expr]]] = {}
        for node in own_nodes(func.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._bind(bindings, t, node.value)
            elif isinstance(node, ast.AugAssign):
                self._bind(bindings, node.target,
                           ast.BinOp(node.target, node.op, node.value))
            elif isinstance(node, ast.AnnAssign) and node.value:
                self._bind(bindings, node.target, node.value)
            elif isinstance(node, (ast.For, ast.AsyncFor,
                                   ast.comprehension, ast.NamedExpr,
                                   ast.With, ast.ExceptHandler)):
                for name in _bound_names(node):
                    bindings.setdefault(name, []).append(None)
        params = {p: self.kinds[p] for p in func.params}
        for verdict in (TENSOR, HOST):
            for name in bindings:
                if self.kinds.get(name) in (None, UNKNOWN) \
                        and params.get(name, verdict) == verdict:
                    self.kinds[name] = verdict
            changed = True
            while changed:
                changed = False
                for name in sorted(bindings):
                    if self.kinds.get(name) != verdict \
                            or params.get(name, verdict) != verdict:
                        continue
                    if not all(v is not None and self.kind(v) == verdict
                               for v in bindings[name]):
                        self.kinds[name] = UNKNOWN
                        changed = True

    @staticmethod
    def _bind(bindings, target: ast.expr, value: ast.expr):
        if isinstance(target, ast.Name):
            bindings.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                # an unpacked element's type is unknown
                for name in _target_names(e):
                    bindings.setdefault(name, []).append(None)

    def is_tensor(self, node: ast.expr) -> bool:
        return self.kind(node) == TENSOR

    def kind(self, node: ast.expr) -> str:
        if isinstance(node, ast.Name):
            return self.kinds.get(node.id, UNKNOWN)
        if isinstance(node, _LITERALS):
            return HOST
        if isinstance(node, ast.Attribute):
            return HOST if node.attr in _HOST_ATTRS \
                else self.kind(node.value)
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        if isinstance(node, ast.BinOp):
            return _join(self.kind(node.left), self.kind(node.right))
        if isinstance(node, ast.UnaryOp):
            return HOST if isinstance(node.op, ast.Not) \
                else self.kind(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return HOST
            kinds = [self.kind(e) for e in [node.left] + node.comparators]
            return TENSOR if TENSOR in kinds else \
                HOST if all(k == HOST for k in kinds) else UNKNOWN
        if isinstance(node, (ast.IfExp, ast.BoolOp)):
            values = [node.body, node.orelse] \
                if isinstance(node, ast.IfExp) else node.values
            kinds = {self.kind(v) for v in values}
            return kinds.pop() if len(kinds) == 1 else UNKNOWN
        return UNKNOWN

    def _call_kind(self, node: ast.Call) -> str:
        chain = dotted_chain(node.func)
        if chain is not None:
            head = chain.split(".")[0]
            if head == "torch" and chain.count(".") == 1:
                return HOST if chain.split(".")[1] in _TORCH_HOST \
                    else TENSOR
            if head in ("np", "numpy") or chain in _HOST_BUILTINS:
                return HOST
        if not isinstance(node.func, ast.Attribute):
            return UNKNOWN
        method = node.func.attr
        receiver = self.kind(node.func.value)
        if method in _HOST_ATTRS or method in ("item", "tolist",
                                                "astype"):
            return HOST   # ``astype`` is numpy's (torch has ``to``)
        if method in _REDUCTIONS:
            # a reduction of anything not visibly host data is taken
            # for a tensor: inside a device program it almost always is
            return HOST if receiver == HOST else TENSOR
        return receiver


def _join(a: str, b: str) -> str:
    if TENSOR in (a, b):
        return TENSOR
    return HOST if a == b == HOST else UNKNOWN


def _target_names(target: ast.expr) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _target_names(e)
    elif isinstance(target, ast.Starred):
        yield from _target_names(target.value)


def _bound_names(node: ast.AST) -> Iterator[str]:
    if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension,
                         ast.NamedExpr)):
        yield from _target_names(node.target)
    elif isinstance(node, ast.With):
        for item in node.items:
            if item.optional_vars is not None:
                yield from _target_names(item.optional_vars)
    elif isinstance(node, ast.ExceptHandler) and node.name:
        yield node.name


def _truth_tensors(test: ast.expr, tensors: "_Kinds") -> List[ast.expr]:
    """The tensor-valued expressions whose truth ``test`` takes."""
    if isinstance(test, ast.BoolOp):
        return [t for v in test.values
                for t in _truth_tensors(v, tensors)]
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _truth_tensors(test.operand, tensors)
    return [test] if tensors.is_tensor(test) else []


def _host_syncs(func: FunctionInfo, tensors: _Kinds):
    """(node, what) for every host read of a tensor in the body."""
    out = []
    inner: Set[int] = set()   # receivers already inside a reported read
    for node in own_nodes(func.node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            kw = {ast.If: "if", ast.While: "while", ast.IfExp: "if",
                  ast.Assert: "assert"}[type(node)]
            for t in _truth_tensors(node.test, tensors):
                out.append((node, f"`{kw}` on a tensor", t))
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                for t in _truth_tensors(cond, tensors):
                    out.append((cond, "comprehension `if` on a tensor", t))
        elif isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain in _CASTS and len(node.args) == 1 \
                    and tensors.is_tensor(node.args[0]):
                out.append((node, f"`{chain}()` of a tensor",
                            node.args[0]))
            elif chain is not None and chain.split(".")[-1] \
                    == "synchronize":
                out.append((node, f"`{chain}()`", None))
            elif chain is not None and chain.split(".")[-1] \
                    in _READ_HELPERS and node.args \
                    and tensors.is_tensor(node.args[0]):
                out.append((node, f"`{chain}()` of a tensor",
                            node.args[0]))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS \
                    and not node.args \
                    and tensors.kind(node.func.value) != HOST:
                out.append((node, f"`.{node.func.attr}()` of a tensor",
                            node.func.value))
    # one finding per read: `t.cpu().numpy()` is a single wait,
    # reported at the outermost call
    for _node, _what, subject in out:
        if subject is None:
            continue
        inner.update(id(n) for n in ast.walk(subject))
    kept = []
    for node, what, subject in out:
        if isinstance(node, ast.Call) and id(node) in inner:
            continue
        kept.append((node, what, subject))
    return kept


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    cached = _cached_functions(index)

    # (a) unhashable arguments into cached builders
    for func in index.iter_functions():
        for call in func.calls:
            if call.target not in cached:
                continue
            builder = cached[call.target]
            exprs = list(call.node.args) \
                + [kw.value for kw in call.node.keywords]
            for e in exprs:
                if isinstance(e, _UNHASHABLE):
                    findings.append(Finding(
                        PASS_ID, "unhashable-arg", func.module,
                        func.qualname, e.lineno,
                        f"dict/list/set argument into lru_cache'd "
                        f"`{builder.qualname}` — unhashable cache "
                        f"key (pass a tuple / frozen value)",
                        f"unhashable:{builder.qualname}"))

    # (b) host reads of device values inside device programs
    entries = program_entries(index)
    reached = program_reachable(index, entries)
    for fid in sorted(reached):
        func = index.functions.get(fid)
        if func is None:
            continue
        entry = entries[reached[fid]].func
        via = "" if fid == entry.id \
            else f" (reached from program {entry.qualname})"
        tensors = _Kinds(func, entries.get(fid))
        ordinals: Dict[str, int] = {}
        for node, what, subject in sorted(
                _host_syncs(func, tensors),
                key=lambda x: (x[0].lineno, x[0].col_offset)):
            text = ast.unparse(subject) if subject is not None \
                else what.strip("`()")
            n = ordinals.get(text, 0)
            ordinals[text] = n + 1
            findings.append(Finding(
                PASS_ID, "host-sync", func.module, func.qualname,
                node.lineno,
                f"{what} `{text}` inside a device program{via} — the "
                f"host waits for every queued launch (keep it on the "
                f"device, or read it once outside the program)",
                f"sync:{text}:{n}"))
    return findings
