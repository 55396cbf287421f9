"""Plan fragmenter: cut at ExchangeNodes into a fragment DAG.

Reference analog: ``sql/planner/PlanFragmenter.java:114``
(``createSubPlans``) producing ``PlanFragment``s with a
``PartitioningScheme``. A fragment's *partitioning* says how its tasks
are driven ('source' = table splits, 'hash' = consumer-partition count,
'single'); its *output_kind/keys* say how its root repartitions rows for
the consumer (the PartitioningScheme of the reference).

The JAX engine's ``trino_tpu/planner/fragmenter.py``, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .plan import (ExchangeNode, OutputNode, PlanNode, RemoteSourceNode,
                   TableScanNode)
from .symbols import Symbol


@dataclass
class PlanFragment:
    fragment_id: int
    root: PlanNode
    # how this fragment's own tasks are driven
    partitioning: str                    # source | hash | single
    # how the root's output is routed to the consumer
    output_kind: str                     # hash | single | broadcast | output
    output_keys: List[Symbol]
    # fragments this one reads via RemoteSourceNodes
    inputs: List[int] = field(default_factory=list)
    #: scaled-writer hash boundary: the output exchanger re-assigns
    #: logical partitions to consumer (writer) lanes by observed load
    scale_writers: bool = False

    @property
    def output_symbols(self) -> List[Symbol]:
        return self.root.output_symbols


class Fragmenter:
    def __init__(self):
        self.fragments: List[PlanFragment] = []

    def fragment(self, root: OutputNode) -> List[PlanFragment]:
        """Returns fragments in execution (topological) order; the last
        one is the output fragment."""
        body, inputs = self._cut(root.source)
        out = PlanFragment(len(self.fragments), body,
                           self._driving(body), "output", [], inputs)
        self.fragments.append(out)
        return self.fragments

    def _cut(self, node: PlanNode) -> Tuple[PlanNode, List[int]]:
        if isinstance(node, ExchangeNode):
            child_body, child_inputs = self._cut(node.source)
            frag = PlanFragment(len(self.fragments), child_body,
                                self._driving(child_body), node.kind,
                                list(node.keys), child_inputs,
                                scale_writers=getattr(
                                    node, "scale_writers", False))
            self.fragments.append(frag)
            remote = RemoteSourceNode(frag.fragment_id,
                                      list(node.output_symbols), node.kind,
                                      node.orderings)
            return remote, [frag.fragment_id]
        new_sources: List[PlanNode] = []
        inputs: List[int] = []
        for s in node.sources:
            body, ins = self._cut(s)
            new_sources.append(body)
            inputs.extend(ins)
        if not node.sources:
            return node, []
        from .optimizer import _replace_sources

        return _replace_sources(node, new_sources), inputs

    def _driving(self, body: PlanNode) -> str:
        """How tasks of this fragment are created."""
        has_scan = False
        has_hash_remote = False

        def walk(n: PlanNode):
            nonlocal has_scan, has_hash_remote
            if isinstance(n, TableScanNode):
                has_scan = True
            if isinstance(n, RemoteSourceNode) and n.kind == "hash":
                has_hash_remote = True
            for s in n.sources:
                walk(s)

        walk(body)
        if has_scan:
            return "source"
        if has_hash_remote:
            return "hash"
        return "single"


def fragment_plan(root: OutputNode) -> List[PlanFragment]:
    return Fragmenter().fragment(root)


def fragments_str(fragments: List[PlanFragment]) -> str:
    from .plan import plan_tree_str

    out = []
    for f in fragments:
        keys = [s.name for s in f.output_keys]
        out.append(f"Fragment {f.fragment_id} [{f.partitioning}] "
                   f"-> {f.output_kind}{keys if keys else ''} "
                   f"inputs={f.inputs}")
        out.append(plan_tree_str(f.root, 1).rstrip())
    return "\n".join(out)
