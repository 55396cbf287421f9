"""A COMPLETE distributed query as one program over d device slabs.

Reference analog: a two-stage Trino query plan — stage 1 scan + partial
aggregation, hash exchange, stage 2 final aggregation (the plan shape of
``sql/planner/optimizations/AddExchanges.java`` for q1) — with the entire
HTTP shuffle (``operator/ExchangeOperator.java:48`` /
``DirectExchangeClient.java:55`` / ``PagePartitioner.java:182``) replaced
by one all-to-all over the slabs.

The JAX engine's ``trino_tpu/parallel/mesh_query.py`` on torch. Its
``shard_map`` over a mesh of d devices is here one process driving d
device slabs (``devices``, which may repeat: ``["cpu"] * d`` in the
tests, ``["cuda:0"] * 4`` on one card): every per-device step runs once
per slab in a plain loop — scan shard -> fused filter/project -> local
partial aggregation (one ``segment_reduce_columns`` call per slab, the
kernel on a CUDA slab) -> all-to-all repartition of groups
(``parallel/exchange.repartition_a2a``) -> merge-final aggregation on
the owning slab (one more kernel call per slab) — and its
``psum``/``pmax`` are a sum and a max over the slabs. The result is
cross-checked against single-device execution.

Sizing protocol (count-first): the program is split at the exchange —
stage 1 (fused filter/project + partial agg) also emits its
per-destination live-group histogram plus a sum/max of those counts
over the slabs, so the host knows the EXACT max (sender, dest) lane load
before running the exchange+final program and ``per_dest`` needs no
guessing. The doubling retry remains as a backstop (and for callers
pinning ``per_dest``), and a retry re-runs only the exchange+final
program, never stage 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..block import Block, Page, padded_size, storage_dtype
from ..ops.aggregation import (_final_project, _merge_states, _state_plan,
                               group_reduce)
from ..ops.global_hash_agg import (EMPTY, global_hash_insert,
                                   global_hash_reduce, pack_keys,
                                   unpack_keys)
from ..ops.kernel_sizing import KERNEL_SIZING
from ..ops.sortkeys import group_operands
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar, to_host
from .exchange import (hash_partition_ids, partition_histogram,
                       repartition_a2a, subbucket_ids)


#: memoized programs + expression builds: a program's seen signatures
#: live on the returned callable (``jit_stats``), so rebuilding one per
#: run_q1_mesh call (or per retry) would count a first call every time
#: (the lru_cache analog of device_exchange._exchange_program)
_PROGRAM_CACHE: dict = {}


def _cached_program(key, build):
    hit = _PROGRAM_CACHE.get(key)
    if hit is None:
        hit = _PROGRAM_CACHE[key] = build()
    return hit


def _shard_page(page: Page, devices: Sequence):
    """Split a host page into d contiguous row shards, padded to one
    common capacity; returns per-slab (cols, nulls, valid), slab s on
    ``devices[s]`` (``cols[s]`` a tuple of column tensors)."""
    n_shards = len(devices)
    rows = page.num_rows
    per = -(-rows // n_shards)
    cap = padded_size(max(per, 16))
    ncols = page.channel_count
    cols = [np.zeros((n_shards, cap), dtype=b.type.storage)
            for b in page.blocks]
    nulls = [np.zeros((n_shards, cap), dtype=bool) for _ in range(ncols)]
    valid = np.zeros((n_shards, cap), dtype=bool)
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, rows)
        k = max(hi - lo, 0)
        if k == 0:
            continue
        for c, b in enumerate(page.blocks):
            cols[c][s, :k] = np.asarray(b.data[lo:hi])
            if b.nulls is not None:
                nulls[c][s, :k] = np.asarray(b.nulls[lo:hi])
        valid[s, :k] = True
    return ([tuple(torch.from_numpy(c[s]).to(dev) for c in cols)
             for s, dev in enumerate(devices)],
            [tuple(torch.from_numpy(x[s]).to(dev) for x in nulls)
             for s, dev in enumerate(devices)],
            [torch.from_numpy(valid[s]).to(dev)
             for s, dev in enumerate(devices)])


def _keys_u64(kr, kn):
    """Group keys as the uint64 bits partition hashing reads (NULL -> 0).
    q1's keys are dictionary codes from pools shared across co-resident
    shards, so raw codes route consistently."""
    return [torch.where(b, torch.zeros((), dtype=torch.int64,
                                       device=k.device), k.to(torch.int64))
            for k, b in zip(kr, kn)]


def q1_stage1_fn(devices: Sequence, proc, step):
    """Build the stage-1 program: per-slab fused filter/project + local
    partial aggregation, PLUS the count-first sizing pass — each slab's
    per-destination live-group histogram, summed over the slabs into
    global per-partition row counts and maxed into the exact max
    (sender, dest) lane load. Takes and returns per-slab lists; the
    totals live on the first slab's device."""
    n = len(devices)

    def stage1(cols, nulls, valid, luts):
        out = {"kr": [], "kn": [], "states": [], "pvalid": [], "part": []}
        hists = []
        home = valid[0].device
        for s in range(n):
            kr, kn, states, pvalid = step(cols[s], nulls[s], valid[s],
                                          luts[s])
            part = hash_partition_ids(_keys_u64(kr, kn), n)
            hists.append(partition_histogram(part, pvalid, n).to(home))
            for name, v in (("kr", kr), ("kn", kn), ("states", states),
                            ("pvalid", pvalid), ("part", part)):
                out[name].append(v)
        stacked = torch.stack(hists)
        return (out["kr"], out["kn"], out["states"], out["pvalid"],
                out["part"], stacked.sum(dim=0), stacked.max())

    return stage1


def q1_exchange_final_fn(devices: Sequence, proc, aggs, per_dest: int):
    """Build the exchange+final program: the all-to-all of the partial
    groups at the (count-first or caller-pinned) ``per_dest``, then
    merge-final aggregation on the owning slab through ``group_reduce``
    (one ``segment_reduce_columns`` call per slab). Separate from stage
    1 so a backstop retry re-runs ONLY the shuffle, never the
    scan/partial-agg.

    ``hot`` is a per-slab (n,) hot-partition mask tensor: a hot
    partition's groups salt their destination with a KEY-derived
    sub-bucket — unlike the generic device exchange's row-index salt,
    every partial of one group shares a sub-bucket, so the group still
    meets on exactly one slab and the per-slab merge-final aggregation
    stays correct with no extra merge stage. A tensor, not a memo key:
    split and unsplit runs share the program."""
    n = len(devices)
    key_types = proc.output_types[:2]
    kinds = tuple(k for a in aggs for (k, _) in _state_plan(a))
    devs = tuple(str(x) for x in devices)

    def dist(kr, kn, states, pvalid, part, hot):
        send_cols, send_nulls, dests = [], [], []
        for s in range(n):
            sub = subbucket_ids(_keys_u64(kr[s], kn[s]), n)
            p = part[s].to(torch.int64)
            dests.append(torch.where(hot[s][p] > 0, (part[s] + sub) % n,
                                     part[s]))
            send_cols.append(tuple(kr[s]) + tuple(states[s]))
            send_nulls.append(tuple(kn[s]) + tuple(
                torch.zeros(x.shape, dtype=torch.bool, device=x.device)
                for x in states[s]))
        ex_cols, ex_nulls, ex_valid, overflow = repartition_a2a(
            send_cols, send_nulls, list(pvalid), dests, num_partitions=n,
            per_dest=per_dest, devices=devs)
        fin_cols, fin_nulls, fin_valid = [], [], []
        for j in range(n):
            cols_j, nulls_j, valid_j = ex_cols[j], ex_nulls[j], ex_valid[j]
            # merge-final aggregation of received partial states
            key_ops: List = []
            for i, t in enumerate(key_types):
                key_ops.extend(group_operands(cols_j[i], nulls_j[i], t))
            merged: List = []
            idx = 2
            for a in aggs:
                k = len(_state_plan(a))
                merged.extend(_merge_states(
                    a, [cols_j[idx + i] for i in range(k)], valid_j,
                    [None] * k, {}))
                idx += k
            out_keys, out_key_nulls, reduced, out_valid = group_reduce(
                tuple(key_ops), tuple(cols_j[:2]), tuple(merged), valid_j,
                kinds)
            fc, fn = list(out_keys), list(out_key_nulls)
            idx = 0
            for a in aggs:
                k = len(_state_plan(a))
                raw, null = _final_project(a, [reduced[idx + i]
                                               for i in range(k)])
                fc.append(raw.to(storage_dtype(a.output_type)))
                fn.append(null | ~out_valid)
                idx += k
            fin_cols.append(fc)
            fin_nulls.append(fn)
            fin_valid.append(out_valid)
        return fin_cols, fin_nulls, fin_valid, overflow

    return dist


def q1_global_hash_fn(devices: Sequence, proc, aggs, table_size: int):
    """Build the GLOBAL-HASH alternative to the exchange+final program
    ("Global Hash Tables Strike Back!", PAPERS.md): no all-to-all of
    partial groups at all — every slab claims its partial groups' slots
    in ONE replicated open-addressing table (splitmix64 probing, claims
    agreed by a min over the slabs) and the state columns merge by a
    sum/min/max over the table replicas. Each slab then finalizes the
    table shard it owns, so the output layout matches the exchange
    path's (n, per-slab) shape. For low-NDV grouping the reduction moves
    O(table) bytes instead of O(partial groups) rows."""
    n = len(devices)
    kinds = tuple(k for a in aggs for (k, _) in _state_plan(a))
    shard = table_size // n
    widths = (32, 32)  # q1 keys are dictionary codes: small, non-negative

    def dist(kr, kn, states, pvalid):
        merged_by_slab, packed = [], []
        for s in range(n):
            merged: List = []
            idx = 0
            for a in aggs:
                k = len(_state_plan(a))
                merged.extend(_merge_states(
                    a, [states[s][idx + j] for j in range(k)], pvalid[s],
                    [None] * k, {}))
                idx += k
            merged_by_slab.append(tuple(merged))
            packed.append(pack_keys(kr[s], kn[s], widths))
        tables, slot_of, resolved, unresolved = global_hash_insert(
            packed, list(pvalid), table_size)
        reduced = global_hash_reduce(slot_of, resolved, list(pvalid),
                                     merged_by_slab, kinds, table_size)
        fin_cols, fin_nulls, fin_valid = [], [], []
        for i in range(n):
            # finalize the owned shard: slot -> group row
            lo, hi = i * shard, (i + 1) * shard
            t_sh = tables[i][lo:hi]
            occupied = t_sh != EMPTY
            fc, fn = [], []
            for (kv, knull), kcol in zip(unpack_keys(t_sh, widths), kr[i]):
                fc.append(kv.to(kcol.dtype))
                fn.append(knull & occupied)
            idx = 0
            for a in aggs:
                k = len(_state_plan(a))
                raw, null = _final_project(a, [reduced[i][idx + j][lo:hi]
                                               for j in range(k)])
                fc.append(raw.to(storage_dtype(a.output_type)))
                fn.append(null | ~occupied)
                idx += k
            fin_cols.append(fc)
            fin_nulls.append(fn)
            fin_valid.append(occupied)
        return fin_cols, fin_nulls, fin_valid, unresolved

    return dist


def run_q1_mesh(devices: Sequence, schema: str = "micro",
                per_dest: Optional[int] = None,
                max_per_dest: int = 1 << 16,
                stats_out: Optional[dict] = None,
                hot_split_threshold: Optional[float] = None,
                agg_strategy: str = "auto"):
    """Execute distributed q1 over the device slabs ``devices``.

    ``per_dest=None`` (default) sizes the exchange count-first: stage 1
    reports the exact max lane load and the data exchange runs ONCE,
    zero retries by construction. Passing ``per_dest`` pins the legacy
    guess (tests use per_dest=1 to exercise the doubling backstop).
    ``stats_out``, when given, is filled with the exchange's skew stats
    (partition_rows, skew_ratio, per_dest, retries, collectives).

    ``hot_split_threshold`` (None = off) enables hot-partition
    splitting: a partition above that fraction of stage 1's live
    groups spreads its groups across receivers by key-derived
    sub-bucket (aggregation-safe — every group still meets on exactly
    one slab). Sizing keeps the UNSALTED count (an upper bound in the
    common case); the doubling backstop covers the remainder.

    ``agg_strategy`` picks the merge shape after stage 1: 'exchange'
    (all-to-all of partial groups + per-slab merge-final), 'global_hash'
    (one replicated table updated by scatter and reduced over the slabs
    — no row shuffle), or 'auto' (default): the
    ``planner.optimizer.choose_agg_strategy`` cost rule decides from
    stage 1's observed live-group count. A pinned ``per_dest`` forces
    the exchange shape (it IS an exchange knob), and a global-hash
    probe-budget overflow falls back to the exchange path — results
    are identical either way.

    Returns (result_rows, n_overflow_retries, connector, scanned_pages) —
    the latter two so callers can re-run the same data locally for the
    equivalence check."""
    from ..benchmarks import q1_device_step, scan_q1_pages
    from ..connectors.tpch import TpchConnector

    devices = [torch.device(x) for x in devices]
    n = len(devices)
    devs = tuple(str(x) for x in devices)
    conn = TpchConnector(page_rows=1 << 14)
    pages = scan_q1_pages(conn, schema, n)
    whole = Page.concat(pages)
    cols, nulls, valid = _shard_page(whole, devices)
    types = [b.type for b in whole.blocks]
    dicts = [b.dictionary for b in whole.blocks]
    tsig = tuple(map(str, types))

    def _build_q1_programs():
        from ..benchmarks import q1_expressions

        proc, step = q1_device_step(types)
        _, _, aggs = q1_expressions(types)
        return proc, step, aggs

    # memoized per type signature: a fresh proc/step per call would
    # rebuild the processor's caches and count a first call every run
    proc, step, aggs = _cached_program(("q1_step", tsig),
                                       _build_q1_programs)
    luts = [proc._fill_luts(dicts, dev) for dev in devices]

    s1 = _cached_program(
        ("stage1", devs, tsig),
        lambda: instrument("mesh_q1_stage1",
                           q1_stage1_fn(devices, proc, step),
                           key=("stage1", devs, tsig)))
    kr, kn, states, pvalid, part, hist, need = s1(cols, nulls, valid, luts)
    part_rows = to_host(hist, "mesh_query.count")
    exact_need = int(host_scalar(need, "mesh_query.count"))
    sizing = "exact" if per_dest is None else "legacy"
    if per_dest is None:
        per_dest = padded_size(max(exact_need, 16))

    # merge-shape decision: the cost rule reads stage 1's observed
    # live-group count (an upper bound on distinct groups — the same
    # histogram the sizing pass already paid for)
    total_groups = int(part_rows.sum())
    pinned = sizing == "legacy"
    strategy = {"auto": "auto", "exchange": "exchange",
                "global_hash": "global-hash",
                "global-hash": "global-hash"}.get(agg_strategy)
    if strategy is None:
        from ..types import TrinoError

        raise TrinoError(f"unknown agg_strategy {agg_strategy!r}",
                         "GENERIC_INTERNAL_ERROR")
    detail = f"forced agg_strategy={agg_strategy}"
    if pinned and strategy != "exchange":
        strategy, detail = "exchange", "per_dest pinned -> exchange"
    elif strategy == "auto":
        from ..planner.optimizer import choose_agg_strategy

        strategy, detail = choose_agg_strategy(total_groups, n)

    retries = 0
    out_cols = out_nulls = out_valid = None
    if strategy == "global-hash":
        # table sized 2x the observed partial-group bound (load <= 0.5)
        # through the kernel sizing history, so repeat runs whose group
        # count jitters reuse the program's signature; must shard
        # evenly over the slabs (both are powers of two)
        table_size = KERNEL_SIZING.suggest(
            ("global-hash-q1", tsig, n), 2 * max(total_groups, 1),
            minimum=max(16, n))
        if table_size % n:
            # the table must shard evenly over the slabs (pow2 capacity
            # over pow2 slabs always does; an odd count keeps exchange)
            strategy = "exchange"
            detail += f"; table {table_size} !% {n} devices -> exchange"
    if strategy == "global-hash":
        fn = _cached_program(
            ("global_hash", devs, tsig, table_size),
            lambda: instrument(
                "mesh_q1_global_hash",
                q1_global_hash_fn(devices, proc, aggs, table_size),
                key=("global_hash", devs, tsig, table_size)))
        out_cols, out_nulls, out_valid, unresolved = fn(
            kr, kn, states, pvalid)
        n_unresolved = int(host_scalar(unresolved, "mesh_query.unresolved"))
        if n_unresolved:
            # probe budget exhausted (adversarial collisions): the
            # exchange path is the exact fallback
            strategy = "exchange"
            detail += f"; global-hash overflow {n_unresolved} -> exchange"
        elif stats_out is not None:
            stats_out.update({
                "kind": "device", "agg_strategy": "global-hash",
                "strategy_detail": detail,
                "table_slots": table_size,
                "rows": total_groups,
                "partition_rows": [int(r) for r in part_rows],
                "a2a_retries": 0, "data_collectives": 1,
            })

    hot: set = set()
    if strategy == "exchange":
        # hot-partition split decision from stage 1's histogram
        if hot_split_threshold is not None and hot_split_threshold < 1.0 \
                and n > 1 and total_groups:
            hot = {p for p in range(n)
                   if part_rows[p] / total_groups > hot_split_threshold}
        hot_np = np.zeros((n,), dtype=np.int32)
        for p in hot:
            hot_np[p] = 1
        hot_mask = [torch.from_numpy(hot_np).to(dev) for dev in devices]

        collectives = 0
        while True:
            fn = _cached_program(
                ("final", devs, tsig, per_dest),
                lambda: instrument(
                    "mesh_q1_exchange_final",
                    q1_exchange_final_fn(devices, proc, aggs, per_dest),
                    key=("final", devs, tsig, per_dest)))
            out_cols, out_nulls, out_valid, overflow = fn(
                kr, kn, states, pvalid, part, hot_mask)
            collectives += 1
            if sum(int(host_scalar(o, "mesh_query.overflow"))
                   for o in overflow) == 0:
                break
            per_dest *= 2
            retries += 1
            if per_dest > max_per_dest:
                from ..types import TrinoError

                raise TrinoError(
                    f"exchange overflow persists at per_dest={per_dest}",
                    "GENERIC_INTERNAL_ERROR")

        if stats_out is not None:
            mean_rows = float(part_rows.mean()) if n else 0.0
            stats_out.update({
                "kind": "device", "sizing": sizing, "per_dest": per_dest,
                "agg_strategy": "exchange", "strategy_detail": detail,
                "observed_max_pair_rows": exact_need,
                "a2a_retries": retries, "data_collectives": collectives,
                "rows": int(part_rows.sum()),
                "partition_rows": [int(r) for r in part_rows],
                "skew_ratio": (round(float(part_rows.max()) / mean_rows, 3)
                               if mean_rows > 0 else 0.0),
                "hot_partitions": sorted(hot),
                "splits": len(hot),
                "split_ways": n if hot else 1,
            })

    # assemble the distributed result: compact valid lanes per slab
    out_types = list(proc.output_types[:2]) + [a.output_type for a in aggs]
    out_dicts = dicts[:2] + [None] * len(aggs)
    ov = np.concatenate([to_host(v, "mesh_query.results")
                         for v in out_valid])
    keep = np.nonzero(ov)[0]
    blocks: List[Block] = []
    for c, (t, d) in enumerate(zip(out_types, out_dicts)):
        data = np.concatenate([to_host(slab[c], "mesh_query.results")
                               for slab in out_cols])[keep]
        nl = np.concatenate([to_host(slab[c], "mesh_query.results")
                             for slab in out_nulls])[keep]
        blocks.append(Block(t, data, nl if nl.any() else None, d))
    rows = Page(blocks, len(keep)).to_rows()
    return rows, retries, conn, pages


def run_q1_mesh_demo(devices: Sequence, schema: str = "micro") -> None:
    """Run the full distributed q1 and cross-check it against
    single-device execution on the first slab's device (the
    DistributedQueryRunner-analog gate)."""
    rows, retries, conn, pages = run_q1_mesh(devices, schema)

    from ..benchmarks import build_q1_driver

    driver, sink = build_q1_driver(conn, schema, source_pages=list(pages),
                                   device=torch.device(devices[0]))
    driver.run_to_completion()
    local_rows: List[tuple] = []
    for p in sink.pages:
        local_rows.extend(p.to_rows())

    key = lambda r: (r[0], r[1])  # noqa: E731
    got, want = sorted(rows, key=key), sorted(local_rows, key=key)
    assert len(got) == len(want), \
        f"distributed {len(got)} groups vs local {len(want)}"
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)
    print(f"mesh q1 ({len(devices)} devices, schema={schema}): "
          f"{len(got)} groups match local execution; "
          f"a2a retries={retries}")
