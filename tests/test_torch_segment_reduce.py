"""The torch engine's segment reduce against the JAX engine's Pallas kernel.

``trino_tpu_torch.ops.kernels.segment_reduce`` replaces
``trino_tpu.ops.pallas_kernels.segment_reduce``. On the CPU it runs its
plain PyTorch version; the JAX side runs the Pallas kernel in interpret
mode, as tests/test_pallas_kernels.py does. Same numpy-seeded inputs go
to both. Ints must match exactly; float SUMs may differ by the order of
addition, so they are held to a relative tolerance of 1e-12 (float64) or
1e-5 (float32) of the segment's sum of magnitudes; MIN/MAX are exact.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import pallas_kernels as pk
from trino_tpu_torch.ops import kernels

torch.set_num_threads(2)

KINDS = ["sum", "min", "max"]
DTYPES = ["int32", "int64", "float32", "float64"]
RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture
def force_interpret(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_PALLAS", "interpret")


def _sorted_gids(rng, n, approx_groups, n_invalid):
    """Non-decreasing gids with steps of <=1, then n_invalid trailing
    rows jumped to the dump segment n (num_segments = n + 1)."""
    b = (rng.random(n) < (approx_groups / max(n, 1))).astype(np.int32)
    b[0] = 1
    gid = (np.cumsum(b) - 1).astype(np.int32)
    if n_invalid:
        gid[-n_invalid:] = n
    return gid


def _values(rng, n, dtype):
    if dtype == "int32":
        return rng.integers(-2 ** 30, 2 ** 30, n).astype(np.int32)
    if dtype == "int64":
        return rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    return (rng.normal(size=n) * 1e3).astype(dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [7, 512, 1000, 4096])
def test_matches_pallas_kernel(kind, dtype, n, force_interpret):
    rng = np.random.default_rng(42 + n)
    n_invalid = min(n // 5, 100)
    gid = _sorted_gids(rng, n, max(2, n // 7), n_invalid)
    col = _values(rng, n, dtype)
    want = np.asarray(pk.segment_reduce(jnp.asarray(col), jnp.asarray(gid),
                                        num_segments=n + 1, kind=kind))
    got = kernels.segment_reduce(torch.from_numpy(col),
                                 torch.from_numpy(gid), n + 1, kind).numpy()
    # the live segments: every gid a valid row names
    live = int(gid[-n_invalid - 1]) + 1 if n_invalid else int(gid[-1]) + 1
    got, want = got[:live], want[:live]
    if dtype in RTOL and kind == "sum":
        scale = np.zeros(n + 1)
        np.add.at(scale, gid, np.abs(col.astype(np.float64)))
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= RTOL[dtype] * scale[:live])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_empty_segments_hold_the_identity(kind):
    col = torch.tensor([5, -3, 7], dtype=torch.int64)
    gid = torch.tensor([0, 0, 3], dtype=torch.int32)
    got = kernels.segment_reduce(col, gid, 5, kind).tolist()
    ident = kernels.segment_identity(kind, torch.int64)
    expect = {"sum": [2, ident, ident, 7, ident],
              "min": [-3, ident, ident, 7, ident],
              "max": [5, ident, ident, 7, ident]}[kind]
    assert got == expect


def test_int_sums_wrap_like_jax():
    """int64 sums wrap in two's complement, as jnp's do."""
    big = np.full(4, 2 ** 62, dtype=np.int64)
    gid = np.zeros(4, dtype=np.int32)
    want = np.asarray(pk.segment_reduce(jnp.asarray(big), jnp.asarray(gid),
                                        1, "sum"))
    got = kernels.segment_reduce(torch.from_numpy(big),
                                 torch.from_numpy(gid), 1, "sum").numpy()
    assert got.tolist() == want.tolist() == [0]


def test_out_of_range_gids_are_dropped():
    col = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    gid = torch.tensor([0, 2, 9], dtype=torch.int32)
    got = kernels.segment_reduce(col, gid, 2, "sum").tolist()
    assert got == [1.0, 0.0]


def test_cpu_path_never_counts_a_launch():
    before = kernels.segment_reduce.launches
    kernels.segment_reduce(torch.ones(8, dtype=torch.int64),
                           torch.zeros(8, dtype=torch.int32), 1, "sum")
    assert kernels.segment_reduce.launches == before


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown kind"):
        kernels.segment_reduce(torch.ones(2), torch.zeros(2,
                                                          dtype=torch.int32),
                               1, "avg")


def test_library_path_names_the_source_hash(tmp_path, monkeypatch):
    """An edited source builds into a new library file, never a stale one."""
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text("// one")
    first = kernels._library_path("k.cu")
    (tmp_path / "k.cu").write_text("// two")
    assert kernels._library_path("k.cu") != first
    assert first.startswith(kernels.BUILD_DIR) and "libk-" in first
