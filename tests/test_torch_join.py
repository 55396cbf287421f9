"""The torch engine's join pieces against the JAX engine's, on the CPU.

Each case builds its inputs once with numpy from a seed and hands the
same arrays to ``trino_tpu`` (JAX on the CPU) and ``trino_tpu_torch``:

- ``_key_u64`` in every mode (single, packed, hashed, and the float
  frexp key with NaN, -0.0 and NULL), and dictionary keys through the
  probe's pool remap: the port's int64 key is the reference's uint64
  with bit 63 flipped, bit for bit;
- the sorted build index, ``_probe_counts``, ``_expand_verified`` /
  ``_finalize_join`` (inner, left, full) and ``_semi_matched``, lane for
  lane. JAX's build sort is not stable, so the device programs after it
  take the reference's own sorted build arrays;
- ``DynamicFilter.collect``/``apply``: a value set, min/max only above
  ``MAX_VALUE_SET``, an empty build and NaN build keys; masks exactly;
- the matmul probe's ``(lo, count)`` equals the sorted-index probe's;
- whole join operators (every join type, with and without a lane budget
  far below the matches, which forces re-expansion and chunking) give
  the reference's rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trino_tpu import types as JT
from trino_tpu.block import DevicePage as JDevicePage
from trino_tpu.block import Dictionary as JDictionary
from trino_tpu.block import Page as JPage
from trino_tpu.exec import dynamic_filter as jdf
from trino_tpu.ops import join as jj
from trino_tpu.ops import matmul_join as jmm
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import DevicePage as PDevicePage
from trino_tpu_torch.block import Dictionary as PDictionary
from trino_tpu_torch.block import Page as PPage
from trino_tpu_torch.exec import dynamic_filter as pdf
from trino_tpu_torch.ops import join as pj
from trino_tpu_torch.ops import matmul_join as pmm

torch.set_num_threads(2)

SIGN = np.int64(-(1 << 63))


def _flip(u64) -> np.ndarray:
    """The reference's uint64 key as the port holds it."""
    return np.asarray(u64).view(np.int64) ^ SIGN


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _n(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _key_cols(rng, kind, n):
    """(jax type, torch type, raw column, null mask) of one key column."""
    nulls = rng.random(n) < 0.1
    if kind == "bigint":
        col = rng.integers(-40, 40, n).astype(np.int64)
        return JT.BIGINT, PT.BIGINT, col, nulls
    if kind == "date":
        col = rng.integers(9000, 9030, n).astype(np.int32)
        return JT.DATE, PT.DATE, col, nulls
    if kind == "boolean":
        return JT.BOOLEAN, PT.BOOLEAN, rng.random(n) < 0.5, nulls
    # doubles with NaN, -0.0, +0.0, negatives and repeats
    pool = np.array([np.nan, -0.0, 0.0, -1.5, 2.25, 1e300, -3e-300, 7.0])
    return JT.DOUBLE, PT.DOUBLE, pool[rng.integers(0, len(pool), n)], nulls


KEY_CASES = [
    ("single", ["bigint"]), ("single", ["date"]), ("single", ["boolean"]),
    ("single", ["double"]), ("packed", ["date", "date"]),
    ("packed", ["bigint", "date"]), ("hashed", ["bigint", "double"]),
    ("hashed", ["bigint", "date", "boolean"]),
]


@pytest.mark.parametrize("mode,kinds", KEY_CASES)
def test_key_u64_bit_for_bit(mode, kinds):
    rng = np.random.default_rng(len(kinds) * 31 + len(mode))
    n = 512
    cases = [_key_cols(rng, k, n) for k in kinds]
    jkey, jnull = jj._key_u64([jnp.asarray(c) for _, _, c, _ in cases],
                              [jnp.asarray(m) for _, _, _, m in cases],
                              [jt for jt, _, _, _ in cases], mode)
    pkey, pnull = pj._key_u64([_t(c) for _, _, c, _ in cases],
                              [_t(m) for _, _, _, m in cases],
                              [pt for _, pt, _, _ in cases], mode)
    np.testing.assert_array_equal(_n(pnull), np.asarray(jnull))
    np.testing.assert_array_equal(_n(pkey), _flip(jkey))


def _probe_op(engine, probe_types, pools):
    """A probe operator with a stand-in build side (its key pools)."""
    mod = jj if engine == "jax" else pj
    op = mod.LookupJoinOperator(probe_types, list(range(len(pools))),
                                mod.JoinBridge())
    build = type("B", (), {"dictionaries": pools,
                           "key_channels": list(range(len(pools)))})()
    return op, build


def test_dictionary_keys_through_remap_bit_for_bit():
    """Probe codes map into the build's pool: values the build lacks get
    -1 (match nothing); an aligned build pool with a duplicate value maps
    to its first code, as the build side's canonical codes do."""
    rng = np.random.default_rng(3)
    build_vals = ["b", "a", "c", "a", "d"]          # aligned: 'a' twice
    probe_vals = ["a", "x", "d", "c", "b", "y"]
    codes = rng.integers(0, len(probe_vals), 256).astype(np.int32)
    nulls = rng.random(256) < 0.1
    valid = rng.random(256) < 0.9
    keys = {}
    for engine, T_, D, Page_ in (("jax", JT, JDictionary, JDevicePage),
                                 ("torch", PT, PDictionary, PDevicePage)):
        to = jnp.asarray if engine == "jax" else _t
        mod = jj if engine == "jax" else pj
        op, b = _probe_op(engine, [T_.VARCHAR], [D.aligned(build_vals)])
        page = Page_([T_.VARCHAR], [to(codes)], [to(nulls)], to(valid),
                     [D.aligned(probe_vals)])
        kcols, ktypes = op._probe_key_cols(page, b)
        keys[engine] = (kcols[0],) + tuple(mod._key_u64(
            kcols, [page.nulls[0]], ktypes, "single"))
        canon = mod._canonical_codes(to(np.arange(5, dtype=np.int32)),
                                     D.aligned(build_vals))
        keys[engine] += (canon,)
    (jc, jk, jn, jcanon), (pc, pk, pn, pcanon) = keys["jax"], keys["torch"]
    np.testing.assert_array_equal(_n(pc), np.asarray(jc))
    assert set(_n(pc).tolist()) == {0, 1, 2, 4, -1}
    np.testing.assert_array_equal(_n(pk), _flip(jk))
    np.testing.assert_array_equal(_n(pn), np.asarray(jn))
    np.testing.assert_array_equal(_n(pcanon), np.asarray(jcanon))
    assert _n(pcanon).tolist() == [0, 1, 2, 1, 4]


def _build_arrays(rng, n_build, ndv, null_frac=0.1):
    """A build page: int64 key with NULLs and dead lanes, a payload."""
    cap = n_build
    key = rng.integers(0, ndv, cap).astype(np.int64)
    pay = rng.integers(-1000, 1000, cap).astype(np.int64)
    nulls = [rng.random(cap) < null_frac, rng.random(cap) < null_frac]
    valid = rng.random(cap) < 0.9
    return [key, pay], nulls, valid


def _both_build_sides(cols, nulls, valid):
    jb = jj._assemble_build_side(
        [JT.BIGINT, JT.BIGINT], [0], [jnp.asarray(c) for c in cols],
        [jnp.asarray(x) for x in nulls], jnp.asarray(valid),
        valid.shape[0], [None, None])
    pb = pj._assemble_build_side(
        [PT.BIGINT, PT.BIGINT], [0], [_t(c) for c in cols],
        [_t(x) for x in nulls], _t(valid), [None, None])
    return jb, pb


def _rows(b, idx):
    return sorted(zip(*(np.asarray(x)[idx].tolist() for x in
                        [b.cols[0], b.cols[1], b.nulls[0], b.nulls[1]])))


def test_build_index_equal():
    """Same sorted keys and flags; the rows under each key are the same
    multiset (JAX's sort does not keep the input order of ties)."""
    rng = np.random.default_rng(11)
    jb, pb = _both_build_sides(*_build_arrays(rng, 1024, 90))
    np.testing.assert_array_equal(_n(pb.key_sorted), _flip(jb.key_sorted))
    np.testing.assert_array_equal(_n(pb.usable_sorted),
                                  np.asarray(jb.usable_sorted))
    # unusable rows share the sentinel key, so their valid flags and rows
    # compare as multisets
    np.testing.assert_array_equal(np.sort(_n(pb.valid_sorted)),
                                  np.sort(np.asarray(jb.valid_sorted)))
    assert pb.key_mode == jb.key_mode == "single"
    live = np.nonzero(np.asarray(jb.valid_sorted))[0]
    assert _rows(pb, _n(pb.valid_sorted).nonzero()[0]) == _rows(jb, live)


def _jax_build_as_torch(jb):
    """The reference's sorted build side handed to the port as is."""
    return pj.BuildSide(
        _t(_flip(jb.key_sorted)), _t(jb.usable_sorted), _t(jb.valid_sorted),
        [_t(c) for c in jb.cols], [_t(x) for x in jb.nulls],
        list(jb.types), list(jb.dictionaries), list(jb.key_channels),
        jb.key_mode)


def _probe_arrays(rng, n, ndv):
    key = rng.integers(-5, ndv + 5, n).astype(np.int64)
    pay = rng.integers(0, 100, n).astype(np.int64)
    nulls = [rng.random(n) < 0.1, rng.random(n) < 0.05]
    valid = rng.random(n) < 0.85
    return [key, pay], nulls, valid


def _probe(rng, ndv=90):
    """(jax build, torch twin of it, probe arrays, jax (lo, count, key),
    torch (lo, count, key))."""
    jb, _ = _both_build_sides(*_build_arrays(rng, 1024, ndv))
    pb = _jax_build_as_torch(jb)
    pcols, pnulls, pvalid = _probe_arrays(rng, 512, ndv)
    jkey, jnull = jj._key_u64([jnp.asarray(pcols[0])],
                              [jnp.asarray(pnulls[0])], [JT.BIGINT],
                              "single")
    pkey, pnull = pj._key_u64([_t(pcols[0])], [_t(pnulls[0])], [PT.BIGINT],
                              "single")
    jlo, jcount = jj._probe_counts(jb.key_sorted, jb.usable_sorted, jkey,
                                   jnp.asarray(pvalid) & ~jnull)
    plo, pcount = pj._probe_counts(pb.key_sorted, pb.usable_sorted, pkey,
                                   _t(pvalid) & ~pnull)
    return jb, pb, (pcols, pnulls, pvalid), (jlo, jcount), (plo, pcount)


def test_probe_counts_equal():
    jb, pb, _, (jlo, jcount), (plo, pcount) = _probe(
        np.random.default_rng(12))
    np.testing.assert_array_equal(_n(pcount), np.asarray(jcount))
    live = np.asarray(jcount) > 0
    assert live.sum() > 100
    np.testing.assert_array_equal(_n(plo)[live], np.asarray(jlo)[live])
    # rows of no candidates still agree where searchsorted stays in range
    np.testing.assert_array_equal(_n(plo), np.asarray(jlo))


@pytest.mark.parametrize("join_type", ["inner", "left", "full"])
def test_expand_and_finalize_equal(join_type):
    rng = np.random.default_rng({"inner": 1, "left": 2, "full": 3}[join_type])
    jb, pb, (pcols, pnulls, pvalid), (jlo, jcount), (plo, pcount) = \
        _probe(rng)
    total = int(np.asarray(jcount).sum())
    out_cap = 1 << (total - 1).bit_length()
    jkeys = (jnp.asarray(pcols[0]),)
    jpi, jbi, jkeep = jj._expand_verified(jlo, jcount, jkeys,
                                          (jb.cols[0],), out_cap=out_cap)
    ppi, pbi, pkeep = pj._expand_verified(plo, pcount, [_t(pcols[0])],
                                          [pb.cols[0]], pb.usable_sorted,
                                          out_cap)
    np.testing.assert_array_equal(_n(ppi), np.asarray(jpi))
    np.testing.assert_array_equal(_n(pkeep), np.asarray(jkeep))
    live = np.asarray(jkeep)
    np.testing.assert_array_equal(_n(pbi)[live], np.asarray(jbi)[live])

    left = join_type != "inner"
    jout = jj._finalize_join(
        tuple(jnp.asarray(c) for c in pcols),
        tuple(jnp.asarray(x) for x in pnulls), jnp.asarray(pvalid),
        tuple(jb.cols), tuple(jb.nulls), jpi, jbi, jkeep, left=left)
    pout = pj._finalize_join(
        [_t(c) for c in pcols], [_t(x) for x in pnulls], _t(pvalid),
        pb.cols, pb.nulls, ppi, pbi, pkeep, left=left)
    (jc, jn, jv), (pc, pn, pv) = jout, pout
    want_valid = np.asarray(jv)
    np.testing.assert_array_equal(_n(pv), want_valid)
    for a, b in zip(pc + pn, list(jc) + list(jn)):
        np.testing.assert_array_equal(_n(a)[want_valid],
                                      np.asarray(b)[want_valid])
    if join_type == "full":
        jacc = jj._mark_build_matched(
            jnp.zeros(jb.valid_sorted.shape[0] + 1, dtype=bool), jkeep, jbi)
        pacc = pj._mark_build_matched(
            torch.zeros(pb.valid_sorted.shape[0] + 1, dtype=torch.bool),
            pkeep, pbi)
        np.testing.assert_array_equal(_n(pacc)[:-1], np.asarray(jacc)[:-1])


def test_semi_matched_equal():
    jb, pb, (pcols, _, pvalid), (jlo, jcount), (plo, pcount) = _probe(
        np.random.default_rng(13))
    n = pvalid.shape[0]
    want = jj._semi_matched(jlo, jcount, (jnp.asarray(pcols[0]),),
                            (jb.cols[0],), n, out_cap=2048)
    got = pj._semi_matched(plo, pcount, [_t(pcols[0])], [pb.cols[0]],
                           pb.usable_sorted, n, 2048)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    assert 0 < int(_n(got).sum()) < n


def test_matmul_probe_equals_sorted_index_probe():
    """The one-hot product's (lo, count) is the two binary searches'
    result for every usable probe row, and the JAX engine's too."""
    rng = np.random.default_rng(14)
    jb, pb, _, (jlo, jcount), (plo, pcount) = _probe(rng, ndv=300)
    bridge = pj.JoinBridge()
    bridge.set_build(pb)
    op = pmm.MatmulJoinOperator([PT.BIGINT, PT.BIGINT], [0], bridge)
    assert op._ensure_table(pb), op._fallback_reason
    klo, k_range, table = op._mm
    assert k_range == 300 and table.shape == (512, 2)
    pcols, pnulls, pvalid = _probe_arrays(rng, 4096, 300)
    pkey, pnull = pj._key_u64([_t(pcols[0])], [_t(pnulls[0])], [PT.BIGINT],
                              "single")
    usable = _t(pvalid) & ~pnull
    mlo, mcount = pmm._matmul_lo_count(pkey, usable, klo, k_range, table)
    slo, scount = pj._probe_counts(pb.key_sorted, pb.usable_sorted, pkey,
                                   usable)
    # BIGINT -1 has the sentinel's 64 bits: on the sorted index it finds
    # the unusable build rows as candidates (which the raw-key check
    # rejects, in both engines); the matmul probe counts 0 for it
    at_sentinel = _t(pcols[0] == -1)
    assert bool(at_sentinel.any())
    assert torch.equal(mcount[~at_sentinel], scount[~at_sentinel])
    assert not bool(mcount[at_sentinel].any())
    live = scount > 0
    assert torch.equal(mlo[live & ~at_sentinel], slo[live & ~at_sentinel])
    # and the JAX engine's matmul probe on the same inputs
    jklo = np.uint64(np.asarray(jb.key_sorted)[0])
    jtable = jmm._build_code_table(jb.key_sorted, jklo, np.uint64(k_range),
                                   kp=512)
    jkey, jnull = jj._key_u64([jnp.asarray(pcols[0])],
                              [jnp.asarray(pnulls[0])], [JT.BIGINT],
                              "single")
    jmlo, jmcount = jmm._matmul_lo_count(
        jkey, jnp.asarray(pvalid) & ~jnull, jklo, np.uint64(k_range), jtable)
    np.testing.assert_array_equal(_n(mcount), np.asarray(jmcount))
    np.testing.assert_array_equal(_n(mlo)[_n(live)],
                                  np.asarray(jmlo)[_n(live)])


def _filters(col, nulls, valid, probe):
    """DynamicFilter.collect on the build column, then apply on the probe
    page, in both engines: (jax mask, torch mask, jax df, torch df)."""
    j, p = jdf.DynamicFilter("k"), pdf.DynamicFilter("k")
    j.collect(jnp.asarray(col), jnp.asarray(nulls), jnp.asarray(valid))
    p.collect(_t(col), _t(nulls), _t(valid))
    pc, pn, pv = probe
    jm = j.apply(jnp.asarray(pc), jnp.asarray(pn), jnp.asarray(pv))
    pm = p.apply(_t(pc), _t(pn), _t(pv))
    return np.asarray(jm), _n(pm), j, p


def _probe_page(rng, n, lo, hi, dtype=np.int64):
    return (rng.integers(lo, hi, n).astype(dtype), rng.random(n) < 0.05,
            rng.random(n) < 0.9)


@pytest.mark.parametrize("case", ["value_set", "min_max_only", "empty",
                                  "nan_keys", "int32"])
def test_dynamic_filter_masks_equal(case):
    rng = np.random.default_rng(21)
    if case == "value_set":
        col = rng.integers(0, 10_000, 3000) * 3
        probe = _probe_page(rng, 4096, -50, 30_050)
    elif case == "min_max_only":
        # more distinct keys than MAX_VALUE_SET: only the range prunes
        n = 2 * pdf.MAX_VALUE_SET
        col = rng.permutation(n).astype(np.int64) * 2 + 1000
        probe = _probe_page(rng, 4096, 0, 3 * n)
    elif case == "empty":
        col = np.arange(64, dtype=np.int64)
        probe = _probe_page(rng, 1024, 0, 100)
    elif case == "nan_keys":
        col = rng.integers(0, 50, 500).astype(np.float64) / 4
        col[::7] = np.nan
        pc = rng.integers(-10, 300, 2048).astype(np.float64) / 4
        pc[::11] = np.nan
        probe = (pc, rng.random(2048) < 0.05, rng.random(2048) < 0.9)
    else:
        col = rng.integers(9000, 9200, 800).astype(np.int32) * 2
        probe = _probe_page(rng, 2048, 17_000, 19_000, np.int32)
    nulls = rng.random(col.shape[0]) < 0.05
    valid = (np.zeros(col.shape[0], dtype=bool) if case == "empty"
             else rng.random(col.shape[0]) < 0.95)
    jm, pm, j, p = _filters(col, nulls, valid, probe)
    np.testing.assert_array_equal(pm, jm)
    assert p.stats() == j.stats()
    assert (p._values is None) == (case in ("min_max_only", "empty"))
    if case == "empty":
        assert not pm.any()
    elif case == "nan_keys":
        assert p.allow_nan and pm[np.isnan(probe[0]) & probe[2]
                                  & ~probe[1]].all()
    assert 0 < p.pruned_rows < p.scanned_rows or case == "empty"
    assert str(p.to_domain()) == str(j.to_domain())


def _run_join(mod, op_cls, join_type, types_, build_cols, probe_cols,
              max_lanes=None, page_rows=256):
    """Build, then probe page by page, through one engine's operators;
    sorted output rows."""
    dev = {} if mod is jj else {"device": "cpu"}
    D = JDictionary if mod is jj else PDictionary
    Page_ = JPage if mod is jj else PPage
    DP = JDevicePage if mod is jj else PDevicePage
    bridge = mod.JoinBridge()
    build = mod.HashBuilderOperator(types_, [0], bridge, **dev)
    bdicts = [D() if t.is_pooled else None for t in types_]
    pdicts = [D() if t.is_pooled else None for t in types_]
    for lo in range(0, len(build_cols[0]), page_rows):
        build.add_input(DP.from_page(Page_.from_pylists(
            types_, [c[lo:lo + page_rows] for c in build_cols], bdicts),
            **dev))
    build.finish()
    build.get_output()
    probe = op_cls(types_, [0], bridge, join_type, max_lanes=max_lanes)
    rows = []
    for lo in range(0, len(probe_cols[0]), page_rows):
        probe.add_input(DP.from_page(Page_.from_pylists(
            types_, [c[lo:lo + page_rows] for c in probe_cols], pdicts),
            **dev))
        while (p := probe.get_output()) is not None:
            rows.extend(p.to_page().to_rows())
    probe.finish()
    while not probe.is_finished():
        p = probe.get_output()
        if p is not None:
            rows.extend(p.to_page().to_rows())
    return sorted(rows, key=repr), probe


def _int_cols(rng, n, ndv, null_frac=0.1):
    keys = (rng.zipf(1.8, n) % ndv).astype(int)
    return [[int(v) if rng.random() >= null_frac else None for v in keys],
            [int(v) for v in rng.integers(0, 1000, n)]]


@pytest.mark.parametrize("max_lanes", [None, 16])
@pytest.mark.parametrize("join_type", ["inner", "left", "full", "semi",
                                       "anti"])
def test_join_operators_rows_equal(join_type, max_lanes):
    """Skewed keys with NULLs on both sides; a lane budget of 16 forces
    the overflow re-expansion and the chunked expansion."""
    rng = np.random.default_rng(len(join_type) + (max_lanes or 0))
    build_cols = _int_cols(rng, 700, 60)
    probe_cols = _int_cols(rng, 900, 90)
    want, _ = _run_join(jj, jj.LookupJoinOperator, join_type,
                        [JT.BIGINT, JT.BIGINT], build_cols, probe_cols,
                        max_lanes)
    got, _ = _run_join(pj, pj.LookupJoinOperator, join_type,
                       [PT.BIGINT, PT.BIGINT], build_cols, probe_cols,
                       max_lanes)
    assert got == want and want
    if join_type in ("inner", "semi", "anti"):
        mm, op = _run_join(pj, pmm.MatmulJoinOperator, join_type,
                           [PT.BIGINT, PT.BIGINT], build_cols, probe_cols,
                           max_lanes)
        assert op.metrics()["strategy"] == "matmul"
        assert mm == want


def test_matmul_string_keys_and_fallback_rows_equal():
    """Dictionary-coded keys ride the matmul probe (codes are the dense
    domain); a key range past max_key_range re-checks onto the sorted
    index, with the reason in the metrics; both give the reference's
    rows."""
    rng = np.random.default_rng(5)
    vocab = [f"k{i:03d}" for i in range(60)]
    bk = [vocab[i] if rng.random() > 0.05 else None
          for i in rng.integers(0, 40, 500)]
    pk = [vocab[i] if rng.random() > 0.05 else None
          for i in rng.integers(0, 60, 700)]
    bv = [int(v) for v in rng.integers(0, 100, 500)]
    pv = [int(v) for v in rng.integers(0, 100, 700)]
    want, _ = _run_join(jj, jj.LookupJoinOperator, "inner",
                        [JT.VARCHAR, JT.BIGINT], [bk, bv], [pk, pv])
    got, op = _run_join(pj, pmm.MatmulJoinOperator, "inner",
                        [PT.VARCHAR, PT.BIGINT], [bk, bv], [pk, pv])
    assert op.metrics()["strategy"] == "matmul" and got == want
    wide = [[0, 10_000_000, 5], [1, 2, 3]]
    want, _ = _run_join(jj, jj.LookupJoinOperator, "inner",
                        [JT.BIGINT, JT.BIGINT], wide, wide)
    got, op = _run_join(pj, pmm.MatmulJoinOperator, "inner",
                        [PT.BIGINT, PT.BIGINT], wide, wide)
    assert op.metrics()["strategy"] == "matmul->sorted-index"
    assert "key range" in op.metrics()["fallback"]
    assert got == want and len(want) == 3
