"""Matmul join: the probe as a blocked one-hot matrix product, on torch.

Reference analog: "Density-optimized Intersection-free Mapping and
Matrix Multiplication for Join-Project Operations" (PAPERS.md,
arXiv 2206.04995) — equi-join over low-NDV keys expressed as dense
matrix products over one-hot key encodings.

The design is the JAX engine's (``trino_tpu/ops/matmul_join.py``):

- **Mapping**: the build side's sorted 64-bit keys (``ops/join.py``)
  over the observed range ``[klo, khi]`` map onto dense codes
  ``key - klo``. The cost model picks the strategy from connector
  statistics (``planner/optimizer.choose_join_strategy``); the operator
  re-checks the actual range at build time and takes the sorted-index
  probe when the mapping would not be dense enough, with the reason in
  its metrics — the reference's own strategy rule, not a device fallback.
- **Build table**: a one-time ``(K, 2)`` table over the key domain —
  ``cnt[k]`` (build rows with code k) and ``first[k]`` (their first
  position in the sorted build). Both equal the sorted-index probe's two
  ``searchsorted`` results.
- **Probe**: one-hot encode the probe codes block by block and multiply
  with the table, giving ``(count, lo)`` per probe row. Semi/anti joins
  finish right there (``matched = count > 0``); inner/left joins feed
  the same ``(lo, count)`` into the sorted-index expansion.

The product must be exact. Each one-hot row has one nonzero lane, so a
float product is exact as long as the type holds the table's integers
and no input is rounded on the way in; TF32 keeps 10 mantissa bits and
would round table values above 2^11. The product therefore runs in
float64, which no TF32 setting touches and which holds every integer
below 2^53 (the JAX engine computes it in float32 at HIGHEST precision).
It is a plain matrix product that the JAX engine leaves to XLA outside
any Pallas kernel, so it stays ``torch.matmul`` here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import types as T
from ..block import DevicePage, padded_size
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar
from .join import KEY_SENTINEL, BuildSide, JoinBridge, LookupJoinOperator

#: default cap on the dense key domain (``matmul_join_max_key_range``):
#: the one-hot width, i.e. per-probe-row MACs — the density knob that
#: bounds the matmul's O(rows * range) work to its low-NDV win region
DEFAULT_MAX_KEY_RANGE = 1024

#: builds past this lose float32-exact counts/positions in the JAX
#: engine (2^24); the cost model (planner/optimizer.choose_join_strategy)
#: imports it so planner estimate and operator re-check cannot drift
MAX_BUILD_ROWS = 1 << 24

#: probe-row / key-domain block sizes of the one-hot product (pow2, so
#: they divide every padded page capacity and table width), the JAX
#: engine's. The results do not depend on either size.
_MB = 1024
_KB = 512


def _build_code_table(key_sorted, klo: int, k_range: int, kp: int):
    """The (kp, 2) float64 build table over dense key codes: column 0 =
    cnt[k] (usable build rows with code k), column 1 = first[k] (their
    first sorted position). Codes beyond the observed range (padding
    lanes) hold zeros. Equal to the sorted-index probe's searchsorted
    pair: unusable rows sort to the sentinel, past every in-range key."""
    codes = torch.arange(kp, dtype=torch.int64, device=key_sorted.device)
    ks = klo + codes  # the int64 key wraps like the uint64; masked below
    lo = torch.searchsorted(key_sorted, ks)
    hi = torch.searchsorted(key_sorted, ks, right=True)
    live = codes < k_range
    cnt = torch.where(live, hi - lo, 0)
    first = torch.where(live, lo, 0)
    return torch.stack([cnt, first], dim=1).to(torch.float64)


# profiled programs (telemetry.profiler), under the JAX engine's names;
# plain calls when profiling is off
_build_code_table = instrument("matmul_join_build_table", _build_code_table,
                               static_argnames=("kp",))


def _blocked_onehot_matmul(codes, table):
    """(m, C) = OneHot(codes) @ table, blocked (_MB x _KB): out[i, :] =
    table[codes[i], :] computed as dense float64 products (codes == kp
    select the all-zero no-match row)."""
    m = codes.shape[0]
    kp, c = table.shape
    mb, kb = min(m, _MB), min(kp, _KB)
    lanes = torch.arange(kb, dtype=codes.dtype, device=codes.device)
    out = torch.zeros((m, c), dtype=table.dtype, device=table.device)
    for r in range(0, m, mb):
        c_blk = codes[r:r + mb]
        acc = out[r:r + mb]
        for k in range(0, kp, kb):
            onehot = (c_blk[:, None] == k + lanes[None, :]).to(table.dtype)
            acc += onehot @ table[k:k + kb]
    return out


def _matmul_lo_count(pkey, pusable, klo: int, k_range: int, table):
    """Per-probe-row (lo, count) via the blocked one-hot product — equal
    to ``join._probe_counts`` for every usable row (dead/unmatched rows
    get count 0 and a lo no kernel reads)."""
    kp = table.shape[0]
    off = pkey - klo  # uint64 difference of the flipped keys (wraps)
    in_range = pusable & (off >= 0) & (off < k_range)
    codes = torch.where(in_range, off, kp)
    out = _blocked_onehot_matmul(codes, table)
    count = out[:, 0].to(torch.int64)
    lo = out[:, 1].to(torch.int64)
    return lo, count


_matmul_lo_count = instrument("matmul_join_probe", _matmul_lo_count)


def _membership_page_valid(valid, count, anti: bool):
    """Semi/anti output mask straight from the matmul counts (exact
    codes: count > 0 IS raw-key membership, no expansion or verify)."""
    matched = count > 0
    return valid & ~matched if anti else valid & matched


_membership_page_valid = instrument("matmul_join_membership",
                                    _membership_page_valid,
                                    static_argnames=("anti",))


class MatmulJoinOperator(LookupJoinOperator):
    """The matmul strategy: identical operator contract and output to
    ``LookupJoinOperator`` (it IS one), with the probe's candidate
    lookup replaced by the blocked one-hot product and semi/anti
    finishing directly on the membership counts. Takes the inherited
    sorted-index probe — per build, with the reason in metrics — when
    the dense mapping is infeasible (multi-key build, empty/oversized
    build, key range past ``max_key_range``)."""

    def __init__(self, probe_types: Sequence[T.Type],
                 probe_key_channels: Sequence[int], bridge: JoinBridge,
                 join_type: str = "inner", filter_fn=None,
                 max_lanes: Optional[int] = None,
                 memory_limited: bool = False,
                 max_key_range: int = DEFAULT_MAX_KEY_RANGE,
                 strategy_detail: str = ""):
        super().__init__(probe_types, probe_key_channels, bridge,
                         join_type, filter_fn, max_lanes, memory_limited)
        self.max_key_range = max_key_range
        #: the cost-model estimate that picked this strategy
        self.strategy_detail = strategy_detail
        self._mm = None  # (klo, k_range, table) once built
        self._fallback_reason: Optional[str] = None

    def metrics(self) -> dict:
        out = {"strategy": "matmul" if self._fallback_reason is None
               else "matmul->sorted-index"}
        if self._fallback_reason is not None:
            out["fallback"] = self._fallback_reason
        elif self._mm is not None:
            out["key_range"] = self._mm[1]
            out["onehot_width"] = int(self._mm[2].shape[0])
        if self.strategy_detail:
            out["estimate"] = self.strategy_detail
        return out

    def _ensure_table(self, b: BuildSide) -> bool:
        """Build the (K, 2) table once per build; False => take the
        inherited sorted-index probe."""
        if self._mm is not None:
            return True
        if self._fallback_reason is not None:
            return False
        reason = None
        klo = khi = 0
        if b.key_mode != "single":
            reason = f"{b.key_mode} key mode (needs one equi key)"
        else:
            n_usable = int(host_scalar(b.usable_sorted.sum(),
                                       "matmul_join.usable"))
            if n_usable == 0:
                reason = "empty build"
            elif n_usable > MAX_BUILD_ROWS:
                reason = f"build {n_usable} rows > f32-exact bound"
            else:
                # usable rows sort first: [0, n_usable) spans the range
                klo = int(host_scalar(b.key_sorted[0], "matmul_join.range"))
                khi = int(host_scalar(b.key_sorted[n_usable - 1],
                                      "matmul_join.range"))
                if khi == KEY_SENTINEL:
                    reason = "key at the u64 sentinel"
                elif khi - klo + 1 > self.max_key_range:
                    reason = (f"key range {khi - klo + 1} > "
                              f"max {self.max_key_range}")
        if reason is not None:
            self._fallback_reason = reason
            return False
        k_range = khi - klo + 1
        kp = max(padded_size(k_range), _KB)
        self._mm = (klo, k_range,
                    _build_code_table(b.key_sorted, klo, k_range, kp))
        return True

    # -- the strategy seams of LookupJoinOperator ----------------------

    def _probe_direct(self, page: DevicePage, b: BuildSide, pkey,
                      pusable) -> Optional[DevicePage]:
        """Semi/anti without a residual filter: membership IS the
        matmul count — emit the masked page with no expansion at all."""
        if self.join_type not in ("semi", "anti") \
                or self.filter_fn is not None \
                or not self._ensure_table(b):
            return None
        klo, k_range, table = self._mm
        _lo, count = _matmul_lo_count(pkey, pusable, klo, k_range, table)
        valid = _membership_page_valid(page.valid, count,
                                       anti=self.join_type == "anti")
        return DevicePage(page.types, page.cols, page.nulls, valid,
                          page.dictionaries)

    def _probe_lo_count(self, b: BuildSide, pkey, pusable):
        if not self._ensure_table(b):
            return super()._probe_lo_count(b, pkey, pusable)
        klo, k_range, table = self._mm
        return _matmul_lo_count(pkey, pusable, klo, k_range, table)
