"""session-props pass: the registry and its readers cannot drift.

The registry module (any indexed module ending in
``session_properties``) declares properties via module-level
``register(SessionProperty("name", "type", ...))`` calls; engine code
reads them through ``value(session, "name")`` / ``prop_value(props,
"name")`` / ``set_property(d, "name", v)``. Three rules:

- ``undeclared-lookup``: a literal property name read somewhere in the
  package that the registry does not declare — ``value()`` would
  ``KeyError`` at query time (or ``set_property`` reject the SET).
- ``dead-property``: a declared property with zero literal read sites
  in the package — a knob users can SET that changes nothing (the
  ``page_rows`` class: its readers moved to connector config and the
  session property kept validating silently).
- ``bad-type``: a declared type outside the registry vocabulary
  (integer | double | boolean | varchar) — ``_parse`` silently falls
  through to ``str()``, so an "integer" typo'd as "int" coerces
  nothing and validation runs against the raw string.

Dynamic lookups (non-literal name expressions, the registry module's
own generic plumbing) are ignored; they cannot be checked textually.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .core import Finding, ProjectIndex

PASS_ID = "session-props"

_TYPE_VOCAB = {"integer", "double", "boolean", "varchar"}
_READ_LASTS = {"value", "prop_value", "set_property"}


def _registry_module(index: ProjectIndex):
    for name in sorted(index.modules):
        if name.endswith("session_properties"):
            return index.modules[name]
    return None


def _declarations(mod) -> Dict[str, Tuple[str, int]]:
    """name -> (declared type, line) from register(SessionProperty(..))
    calls anywhere at module level (including inside try/if blocks)."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in mod.nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "register" and node.args):
            continue
        inner = node.args[0]
        if not (isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Name)
                and inner.func.id == "SessionProperty"):
            continue
        consts = [a.value for a in inner.args[:2]
                  if isinstance(a, ast.Constant)
                  and isinstance(a.value, str)]
        if len(consts) == 2:
            out[consts[0]] = (consts[1], inner.lineno)
    return out


def run(index: ProjectIndex) -> List[Finding]:
    reg = _registry_module(index)
    if reg is None:
        return []
    declared = _declarations(reg)
    findings: List[Finding] = []

    for name, (type_, line) in sorted(declared.items()):
        if type_ not in _TYPE_VOCAB:
            findings.append(Finding(
                PASS_ID, "bad-type", reg.name, "", line,
                f"property `{name}` declares type {type_!r} outside "
                f"the registry vocabulary {sorted(_TYPE_VOCAB)} — "
                f"_parse silently treats it as varchar",
                f"bad-type:{name}"))

    reads: Dict[str, List[Tuple[str, str, int]]] = {}
    for func in index.iter_functions():
        if func.module == reg.name:
            continue   # the registry's own generic plumbing
        for call in func.calls:
            last = call.chain.split(".")[-1]
            if last not in _READ_LASTS:
                continue
            resolved = call.target or ""
            ok = "session_properties" in resolved
            if not ok:
                head = call.chain.split(".")[0]
                ok = head in ("SP", "session_properties")
            if not ok:
                continue
            for a in call.node.args:
                if isinstance(a, ast.Constant) \
                        and isinstance(a.value, str):
                    reads.setdefault(a.value, []).append(
                        (func.module, func.qualname, call.line))
                    break

    for name in sorted(reads):
        if name not in declared:
            mod, qual, line = reads[name][0]
            findings.append(Finding(
                PASS_ID, "undeclared-lookup", mod, qual, line,
                f"lookup of session property `{name}` which the "
                f"registry does not declare — value() raises "
                f"KeyError at query time",
                f"undeclared:{name}"))

    for name, (_type, line) in sorted(declared.items()):
        if name not in reads:
            findings.append(Finding(
                PASS_ID, "dead-property", reg.name, "", line,
                f"property `{name}` has no read site in the package "
                f"— a SET SESSION knob that changes nothing",
                f"dead:{name}"))
    return findings
