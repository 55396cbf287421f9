"""The host side of the torch engine's segment-reduce kernel, on the CPU.

``trino_tpu_torch.ops.kernels.plan_columns`` lays out one call of the
Hopper kernel: the descriptor codes, one output block per dtype with the
kernel's scratch (tile-edge carries, and past ``INLINE_COLUMNS`` columns
the descriptor table) carved from block 0, and the packed descriptor
table. ``allocate_outputs`` makes the outputs as views of those blocks.
The kernel itself runs only on a card (tests/test_torch_cuda.py); what
it is handed is checked here: every output a contiguous 1-D view of its
own dtype at the address its descriptor names, no two outputs and the
scratch overlapping, the scratch 16-byte aligned and large enough.
"""

import struct

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import kernels

DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
              torch.float64: 3}
KIND_CODE = {"sum": 0, "min": 1, "max": 2}

#: (dtype, kind) columns of each table: q1's 15 int64 states, the sort
#: path's states with the int32 first-row MIN, and more than 32 columns
#: of four (dtype, kind) pairs (the descriptor table then goes to the
#: device)
TABLES = {
    "q1": [(torch.int64, "sum")] * 15,
    "sort_path": [(torch.int64, "sum")] * 3 + [(torch.float64, "max"),
                                                (torch.int32, "min")],
    "mixed": ([(torch.int64, "sum")] * 34
              + [(torch.int32, "min"), (torch.float32, "max"),
                 (torch.float64, "sum")] * 2),
}


#: the kernel's design's edge cases (``edge_gids``): tests/
#: test_torch_segment_reduce_columns.py holds the plain version against the
#: JAX engine on them, tests/test_torch_cuda.py the kernel against the
#: plain version. "steps" says whether the gids step by at most 1 (then a
#: jump to segments past num_segments): what the JAX engine's Pallas kernel
#: takes; the others go to its plain ``jax.ops.segment_*`` path.
EDGE_CASES = {
    # a gap of 5,000 segments (more than a 2,048-segment fill chunk)
    # between two runs of groups
    "gap_middle": False,
    # 50 groups, then 19,950 segments no row names up to num_segments
    "gap_tail": True,
    # gaps of 3,000 and 2,500 segments across two 2,048-row tile edges
    "gap_at_tile_edges": False,
    # one segment over rows 100..6,999 (four tiles), then a jump to the
    # dump segment
    "segment_over_tiles": False,
    # one row; one row more than a tile
    "n_1": True,
    "n_tile_plus_1": True,
    # gids above num_segments (dropped), steps of 1 below it
    "ns_below_max_gid": True,
}


def _dense(n, rows_per_group, start=0):
    return start + np.arange(n) // rows_per_group


def edge_gids(case):
    """(sorted int32 gids, num_segments) of one of ``EDGE_CASES``."""
    if case == "gap_middle":
        gid = np.concatenate([_dense(3000, 30), _dense(3000, 30, 5100)])
    elif case == "gap_tail":
        gid = _dense(3000, 60)
        return gid.astype(np.int32), 20_000
    elif case == "gap_at_tile_edges":
        gid = np.concatenate([_dense(2048, 32), _dense(2048, 32, 3064),
                              _dense(2048, 32, 5628)])
    elif case == "segment_over_tiles":
        gid = np.concatenate([np.zeros(100), np.ones(6900),
                              np.full(500, 2), np.full(500, 8000)])
        return gid.astype(np.int32), 8001
    elif case == "n_1":
        return np.zeros(1, dtype=np.int32), 2
    elif case == "n_tile_plus_1":
        gid = _dense(2049, 7)
    elif case == "ns_below_max_gid":
        return _dense(5000, 5).astype(np.int32), 600
    else:
        raise ValueError(case)
    return gid.astype(np.int32), int(gid[-1]) + 2


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_gids_are_what_they_say(case):
    gid, ns = edge_gids(case)
    assert gid.dtype == np.int32 and np.all(np.diff(gid) >= 0)
    steps = np.diff(gid[gid < ns])
    assert bool(np.all(steps <= 1)) == EDGE_CASES[case]
    if case.startswith("gap"):
        assert (steps.max() if steps.size else 0) > 2048 or \
            ns - gid.max() > 2048


def _span(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("n,ns", [(0, 5), (1, 2), (2048, 2049),
                                  (2049, 2050), (5000, 3), (8192, 70_001)])
def test_plan_lays_out_outputs_and_scratch(table, n, ns):
    dtypes = [dt for dt, _ in TABLES[table]]
    kinds = [kind for _, kind in TABLES[table]]
    plan = kernels.plan_columns(dtypes, kinds, n, ns)
    k = len(dtypes)
    assert plan.codes == tuple(DTYPE_CODE[dt] * 3 + KIND_CODE[kind]
                               for dt, kind in TABLES[table])
    # one block per dtype, in the order the dtypes first appear
    assert [dt for dt, _ in plan.blocks] == list(dict.fromkeys(dtypes))
    assert list(plan.out_rows) == [dtypes.count(dt) for dt, _ in
                                   plan.blocks]
    for (b, row), dt in zip(plan.slots, dtypes):
        assert plan.blocks[b][0] == dt and 0 <= row < plan.out_rows[b]
    assert len(set(plan.slots)) == k

    carries = 2 * -(-n // kernels.TILE_ROWS)
    dtype0, rows0 = plan.blocks[0]
    row_bytes = ns * dtype0.itemsize
    assert plan.carry_gid_offset % 16 == 0 and plan.carry_val_offset % 16 == 0
    assert plan.carry_gid_offset >= plan.out_rows[0] * row_bytes
    assert plan.carry_val_offset >= plan.carry_gid_offset + 4 * carries
    end = plan.carry_val_offset + 8 * carries * k
    if k > kernels.INLINE_COLUMNS:
        assert plan.table_offset >= end and plan.table_offset % 8 == 0
        end = plan.table_offset + kernels.DESCRIPTOR_BYTES * k
    else:
        assert plan.table_offset == -1
    assert rows0 * row_bytes >= end
    # no more rows than the scratch needs
    assert (rows0 - 1) * row_bytes < end
    assert plan.blocks[1:] == tuple(
        (dt, rows) for (dt, _), rows in zip(plan.blocks[1:],
                                            plan.out_rows[1:]))

    outs, ptrs, scratch = kernels.allocate_outputs(plan, ns, "cpu")
    assert len(outs) == len(ptrs) == k
    spans = []
    for out, ptr, dt in zip(outs, ptrs, dtypes):
        assert out.dtype == dt and out.shape == (ns,) and out.is_contiguous()
        assert out.data_ptr() == ptr
        spans.append(_span(out))
    spans.append((scratch + plan.carry_gid_offset, scratch + end))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert scratch % 16 == 0


def test_plan_without_segments_needs_no_scratch():
    plan = kernels.plan_columns([torch.int64, torch.float32], ["sum", "min"],
                                4096, 0)
    assert plan.blocks == ((torch.int64, 1), (torch.float32, 1))
    assert plan.table_offset == -1
    outs, _, _ = kernels.allocate_outputs(plan, 0, "cpu")
    assert [o.shape for o in outs] == [(0,), (0,)]


def test_descriptor_table_packs_pointers_and_codes():
    cols = [torch.zeros(8, dtype=dt) for dt, _ in TABLES["mixed"]]
    kinds = [kind for _, kind in TABLES["mixed"]]
    plan = kernels.plan_columns([c.dtype for c in cols], kinds, 8, 9)
    outs, ptrs, _ = kernels.allocate_outputs(plan, 9, "cpu")
    packed = plan.table.pack(*[v for c, o, code in zip(cols, ptrs,
                                                       plan.codes)
                               for v in (c.data_ptr(), o, code)])
    assert len(packed) == kernels.DESCRIPTOR_BYTES * len(cols)
    for i, (c, out) in enumerate(zip(cols, outs)):
        got = struct.unpack_from("<3q", packed, kernels.DESCRIPTOR_BYTES * i)
        assert got == (c.data_ptr(), out.data_ptr(), plan.codes[i])


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="unsupported dtype"):
        kernels.plan_columns([torch.int16], ["sum"], 4, 5)
    with pytest.raises(ValueError, match="unknown kind"):
        kernels.plan_columns([torch.int64], ["avg"], 4, 5)


def test_plan_of_no_columns_is_empty():
    plan = kernels.plan_columns([], [], 16, 17)
    assert plan.codes == () and plan.blocks == () and plan.slots == ()
