"""The torch engine on a CUDA card: its kernels against their plain
versions, and q1 on the card against q1 on the CPU.

Every test here needs a card (a CUDA kernel has no CPU mode): each is
marked ``cuda`` and skips without one. The file imports neither jax nor
trino_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: ints and MIN/MAX exactly; a float SUM within SUM_RTOL of the
segment's sum of |x| from the exact sum (the float values are multiples
of 2^-10, so the plain version in float64 adds them exactly).
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch import LocalQueryRunner
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import kernels
from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.sql.analyzer import Session

pytestmark = pytest.mark.cuda

KINDS = ["sum", "min", "max"]
DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64]
SUM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rng, n, groups, dtype, dev):
    """Sorted gids (``groups`` runs over the first 95% of rows, then the
    dump segment n) and values of ``dtype``."""
    live = max(1, n - n // 20) if n else 0
    b = np.zeros(n, dtype=np.int32)
    if groups > 1 and live > 1:
        b[np.sort(rng.choice(np.arange(1, live), min(groups, live) - 1,
                             replace=False))] = 1
    gid = np.cumsum(b).astype(np.int32)
    gid[live:] = n
    if dtype.is_floating_point:
        col = np.floor(rng.uniform(0, 1000, n) * 1024) / 1024
    elif dtype == torch.int32:
        col = rng.integers(-2 ** 30, 2 ** 30, n)
    else:
        col = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    return (torch.from_numpy(col).to(dtype).to(dev),
            torch.from_numpy(gid).to(dev))


def _assert_matches(got, col, gid, ns, kind):
    if kind != "sum" or not col.dtype.is_floating_point:
        assert torch.equal(
            got, kernels.segment_reduce_reference(col, gid, ns, kind))
        return
    want = kernels.segment_reduce_reference(col.double(), gid, ns, "sum")
    mag = kernels.segment_reduce_reference(col.abs().double(), gid, ns,
                                           "sum")
    limit = SUM_RTOL[col.dtype] * mag
    assert bool(((got.double() - want).abs() <= limit).all())


# q1's aggregation page (262,144) and its final merge of 24 page partials
# (8,388,608: several carry tiles), each at 4 groups and at ~n/7
@pytest.mark.parametrize("n,groups", [(262_144, 4), (262_144, 37_449),
                                      (8_388_608, 4), (8_388_608, 1_198_372),
                                      (1000, 140), (7, 3), (2048, 1)])
def test_kernel_matches_plain_version(dev, n, groups):
    rng = np.random.default_rng(n + groups)
    for dtype in DTYPES:
        col, gid = _inputs(rng, n, groups, dtype, dev)
        for kind in KINDS:
            before = kernels.segment_reduce.launches
            got = kernels.segment_reduce(col, gid, n + 1, kind)
            assert kernels.segment_reduce.launches == before + 1
            _assert_matches(got, col, gid, n + 1, kind)


def test_empty_input_is_all_identity(dev):
    col = torch.empty(0, dtype=torch.int64, device=dev)
    gid = torch.empty(0, dtype=torch.int32, device=dev)
    got = kernels.segment_reduce(col, gid, 5, "min")
    assert got.tolist() == [torch.iinfo(torch.int64).max] * 5


def test_repeated_float_sums_are_bit_identical(dev):
    rng = np.random.default_rng(1)
    col, gid = _inputs(rng, 262_144, 4, torch.float32, dev)
    first = kernels.segment_reduce(col, gid, 262_145, "sum")
    for _ in range(3):
        assert torch.equal(kernels.segment_reduce(col, gid, 262_145, "sum"),
                           first)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    col = torch.ones(16, dtype=torch.int64, device=dev)
    gid = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.segment_reduce(col, gid.to(torch.int64), 1, "sum")
    with pytest.raises(TypeError):
        kernels.segment_reduce(col.to(torch.int16), gid, 1, "sum")
    with pytest.raises(ValueError):
        kernels.segment_reduce(col[::2], gid[::2].clone(), 1, "sum")
    with pytest.raises(ValueError):
        kernels.segment_reduce(col, gid.cpu(), 1, "sum")


def test_q1_on_the_card_equals_the_cpu_path(dev):
    def run(device):
        runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                                  Session(catalog="tpch", schema="tiny"),
                                  device=device)
        return runner.execute(TPCH_QUERIES[1]).rows

    before = kernels.segment_reduce.launches
    on_card = run(dev)
    launched = kernels.segment_reduce.launches - before
    assert launched >= 15
    assert on_card == run("cpu")
