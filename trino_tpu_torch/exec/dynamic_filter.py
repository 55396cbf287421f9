"""Dynamic filtering: build-side key domains pruning probe-side scans.

Reference analog: ``server/DynamicFilterService.java:107,278`` +
``operator/DynamicFilterSourceOperator.java`` + the ``TupleDomain``
predicate model (``spi/predicate/``).  There, build-side values stream to
a coordinator service and reach probe scans as TupleDomains; here the
planner links the two sides directly: the join build publishes its key
domain (min/max + a sorted value set when small) into a ``DynamicFilter``
that the probe-side TableScan applies to every page BEFORE rows enter
the pipeline.

The design is the JAX engine's (``trino_tpu/exec/dynamic_filter.py``):
the scan applies the domain as a lane-mask update (no compaction, no
host sync — pruned-row counts accumulate in a device scalar read once at
query end), and the value-set membership test is a ``searchsorted`` +
equality over a padded sorted array, the same binary-search idiom the
join probe uses.

Scheduling guarantee: pipelines of a task run build-before-probe (the
physical planner sequences them), so the filter is complete before the
first probe page is scanned.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..block import padded_size

#: value sets larger than this keep only min/max (reference analog:
#: dynamic-filtering.small.max-distinct-values-per-driver)
MAX_VALUE_SET = 1 << 17


def _as_dtype(value, dtype: torch.dtype):
    """A host scalar cast to ``dtype`` as numpy casts it (a wider integer
    wraps), like the JAX engine's ``jnp.asarray(value, dtype=...)``."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return np.asarray(value).astype(np_dtype).item()


class DynamicFilter:
    """Domain of one join-key column, filled at build publish."""

    def __init__(self, label: str = ""):
        self.label = label
        self.ready = False
        self.allow_nan = False     # build side had NaN float keys
        self.lo = None             # numpy scalar in the key's storage dtype
        self.hi = None
        self._values: Optional[np.ndarray] = None  # sorted unique, padded
        self._values_dev: Optional[torch.Tensor] = None
        self._pruned_dev = None    # lazy device accumulator (no hot sync)
        self._seen_dev = None
        self.build_rows = 0

    # -- build side -----------------------------------------------------

    def collect(self, col, nulls, valid):
        """Collect the domain from build-side device tensors (called once
        at HashBuilder publish; one device->host transfer)."""
        live = (valid & ~nulls).cpu().numpy()
        vals = col.cpu().numpy()[live]
        self.build_rows = int(vals.shape[0])
        if np.issubdtype(vals.dtype, np.floating):
            # NaN build keys: np.unique sorts NaN last, so hi would be
            # NaN and `col <= hi` would prune EVERYTHING.  Drop NaNs from
            # the domain and pass NaN probe lanes through.
            nan_mask = np.isnan(vals)
            self.allow_nan = bool(nan_mask.any())
            vals = vals[~nan_mask]
        if vals.shape[0] == 0:
            # no (finite) build keys: range matches nothing; NaN lanes
            # still pass when the build had NaN keys
            self.lo, self.hi = np.int64(1), np.int64(0)
            self.ready = True
            return
        uniq = np.unique(vals)
        self.lo, self.hi = uniq[0], uniq[-1]
        if uniq.shape[0] <= MAX_VALUE_SET:
            cap = padded_size(int(uniq.shape[0]))
            padded = np.full(cap, uniq[-1], dtype=uniq.dtype)
            padded[:uniq.shape[0]] = uniq
            self._values = padded
            self._values_dev = torch.from_numpy(padded).to(col.device)
        self.ready = True

    # -- probe side -----------------------------------------------------

    def apply(self, col, nulls, valid):
        """valid-mask update for one scanned page (device, no sync)."""
        if not self.ready:
            return valid
        if self.lo > self.hi:  # no finite build keys
            keep = torch.zeros_like(valid)
        else:
            keep = valid & ~nulls & \
                (col >= _as_dtype(self.lo, col.dtype)) & \
                (col <= _as_dtype(self.hi, col.dtype))
            if self._values_dev is not None:
                key = col.to(torch.int64) if col.dtype == torch.bool \
                    else col
                vs = self._values_dev.to(key.dtype)
                idx = torch.searchsorted(vs, key).clamp_(0, vs.shape[0] - 1)
                keep = keep & (vs[idx] == key)
        if self.allow_nan:
            keep = keep | (valid & ~nulls & torch.isnan(col))
        pruned = (valid & ~keep).sum()
        seen = valid.sum()
        self._pruned_dev = pruned if self._pruned_dev is None \
            else self._pruned_dev + pruned
        self._seen_dev = seen if self._seen_dev is None \
            else self._seen_dev + seen
        return keep

    def to_domain(self):
        """The collected build-side key domain as a ``predicate.Domain``
        (reference: DynamicFilterService handing TupleDomains to
        connector scans). NaN admission can't be expressed as a range and
        stays a device-side flag; the device ``apply`` path remains the
        enforcement."""
        from ..predicate import Domain, Range, ValueSet

        if not self.ready:
            return Domain.all_()
        if self.lo > self.hi:  # no finite build keys
            return Domain.none()
        if self._values is not None and self._values.shape[0] <= 1024:
            uniq = np.unique(self._values)
            return Domain(ValueSet.of(*(v.item() for v in uniq)), False)
        return Domain(ValueSet.of_ranges(
            Range(self.lo.item(), True, self.hi.item(), True)), False)

    # -- observability ---------------------------------------------------

    @property
    def pruned_rows(self) -> int:
        return 0 if self._pruned_dev is None else int(self._pruned_dev)

    @property
    def scanned_rows(self) -> int:
        return 0 if self._seen_dev is None else int(self._seen_dev)

    def stats(self) -> dict:
        return {
            "filter": self.label,
            "ready": self.ready,
            "build_rows": self.build_rows,
            "scanned_rows": self.scanned_rows,
            "pruned_rows": self.pruned_rows,
            "has_value_set": self._values is not None,
        }


def resolve_scan_column(node, symbol_name: str):
    """Walk a probe-side plan subtree to the TableScan column feeding
    ``symbol_name``, through renaming projections, filters, sorts and
    probe sides of nested joins (reference analog: the source-symbol walk
    in ``DynamicFilterService.getSourceSymbol``).  Returns
    ``(scan_node, channel)`` or None when the symbol is computed or
    crosses a pipeline boundary (union, aggregation, remote source)."""
    from ..planner.plan import (CrossJoinNode, FilterNode, JoinNode,
                                ProjectNode, SortNode, TableScanNode)
    from ..planner.symbols import SymbolRef

    name = symbol_name
    while True:
        if isinstance(node, TableScanNode):
            for pos, (s, _c) in enumerate(node.assignments):
                if s.name == name:
                    return node, pos
            return None
        # Limit/TopN are NOT transparent — pruning below a LIMIT changes
        # which rows it selects.  Sort alone is row-preserving.
        if isinstance(node, (FilterNode, SortNode)):
            node = node.source
            continue
        if isinstance(node, ProjectNode):
            expr = None
            for s, e in node.assignments:
                if s.name == name:
                    expr = e
                    break
            if not isinstance(expr, SymbolRef):
                return None
            name = expr.name
            node = node.source
            continue
        if isinstance(node, (JoinNode, CrossJoinNode)):
            # probe-side symbols pass through the join unchanged; build
            # symbols won't resolve below and fall out as None
            node = node.left
            continue
        return None


def plan_dynamic_filters(planner, left_node, criteria, join_type: str
                         ) -> List[Tuple[object, DynamicFilter]]:
    """Register a DynamicFilter per eligible equi-clause: returns
    [(build_symbol, filter)] and records the probe-scan attachment in
    ``planner._scan_dfs``.  Inner and semi joins only: LEFT/ANTI probes
    must keep unmatched rows."""
    out: List[Tuple[object, DynamicFilter]] = []
    if join_type not in ("inner", "semi") or not criteria:
        return out
    for lsym, rsym in criteria:
        if lsym.type.is_string or rsym.type.is_string:
            continue  # string keys join via dictionary codes; pools differ
        target = resolve_scan_column(left_node, lsym.name)
        if target is None:
            continue
        scan_node, pos = target
        df = DynamicFilter(label=f"{lsym.name}<-{rsym.name}")
        planner._scan_dfs.setdefault(id(scan_node), []).append((pos, df))
        planner.dynamic_filters.append(df)
        out.append((rsym, df))
    return out
