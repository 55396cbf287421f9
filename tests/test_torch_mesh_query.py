"""The torch engine's mesh program (``parallel/mesh_query.py``) against
the JAX engine's: the 5 cases of tests/test_mesh_query.py at n = 2, 4
and 8 device slabs.

The JAX engine runs ``run_q1_mesh`` over ``jax.devices()[:n]`` (the 8
virtual CPU devices of tests/conftest.py); the port over ``["cpu"] * n``.
q1 at micro: rows equal the JAX mesh's and the local driver's (decimals
and counts exactly; q1's averages are decimals), the doubling backstop
under ``per_dest=1`` with the JAX engine's retry count, no new program
first call on a repeat run (the JAX engine's "no re-trace"), zero
retries and the JAX engine's skew stats under count-first sizing, and
``auto`` picking the global hash with the exchange's rows. Both engines'
kernel sizing histories are reset around each case, so the global
table's size is decided from the same observations.
"""

import jax
import pytest

from trino_tpu import jit_stats as jjit
from trino_tpu.ops.kernel_sizing import KERNEL_SIZING as J_SIZING
from trino_tpu.parallel import mesh_query as jmq
from trino_tpu_torch import jit_stats as pjit
from trino_tpu_torch.ops.kernel_sizing import KERNEL_SIZING as P_SIZING
from trino_tpu_torch.parallel import mesh_query as pmq


@pytest.fixture(autouse=True)
def _fresh_sizing():
    for h in (J_SIZING, P_SIZING):
        h.reset()
    yield
    for h in (J_SIZING, P_SIZING):
        h.reset()


def _key(r):
    return (r[0], r[1])


def _both(n, **kw):
    """(jax rows, port rows, jax retries, port retries, jax stats, port
    stats) of one mesh q1 configuration."""
    jstats, pstats = {}, {}
    jrows, jret, _c, _p = jmq.run_q1_mesh(jax.devices("cpu")[:n],
                                          schema="micro", stats_out=jstats,
                                          **kw)
    prows, pret, _c, _p = pmq.run_q1_mesh(["cpu"] * n, schema="micro",
                                          stats_out=pstats, **kw)
    return (sorted(jrows, key=_key), sorted(prows, key=_key), jret, pret,
            jstats, pstats)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_q1_matches_local(n, capsys):
    pmq.run_q1_mesh_demo(["cpu"] * n, schema="micro")
    assert f"mesh q1 ({n} devices, schema=micro): 4 groups match" in \
        capsys.readouterr().out
    jrows, prows, _jr, _pr, jst, pst = _both(n)
    assert prows == jrows and len(prows) == 4
    assert pst == jst


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_q1_overflow_retry(n):
    """per_dest=1 forces exchange overflow; the protocol doubles
    capacity and re-runs ONLY the exchange+final, never stage 1, with
    the JAX engine's retry count and rows."""
    jrows, prows, _jr, _pr, _js, _ps = _both(n, per_dest=None)
    s1_before = pjit.total_for("mesh_q1_stage1")
    jrows, prows, jret, pret, jst, pst = _both(n, per_dest=1)
    assert pret == jret >= 1
    assert prows == jrows and len(prows) == 4
    assert pst == jst
    assert pjit.total_for("mesh_q1_stage1") == s1_before


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_q1_repeat_run_does_not_retrace(n):
    """Repeat runs reuse the memoized stage1/exchange+final programs:
    no new first call in either engine."""
    names = ("mesh_q1_stage1", "mesh_q1_exchange_final")
    _both(n, agg_strategy="exchange")  # warm
    pbefore, jbefore = pjit.total_for(*names), jjit.total_for(*names)
    _both(n, agg_strategy="exchange")
    assert pjit.total_for(*names) == pbefore
    assert jjit.total_for(*names) == jbefore


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_q1_count_first_sizing_zero_retries(n):
    jrows, prows, jret, pret, jst, pst = _both(n, agg_strategy="exchange")
    assert pret == jret == 0
    assert prows == jrows and len(prows) == 4
    assert pst == jst
    assert pst["sizing"] == "exact" and pst["agg_strategy"] == "exchange"
    assert pst["data_collectives"] == 1
    assert pst["per_dest"] >= pst["observed_max_pair_rows"]
    assert len(pst["partition_rows"]) == n
    assert sum(pst["partition_rows"]) == pst["rows"] > 0
    assert pst["skew_ratio"] >= 1.0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_q1_auto_picks_global_hash_and_matches_exchange(n):
    jrows, prows, jret, pret, jst, pst = _both(n)
    assert pret == jret == 0
    assert pst == jst
    assert pst["agg_strategy"] == "global-hash"
    assert "groups" in pst["strategy_detail"]
    assert pst["table_slots"] >= 2 * 4
    _jr, want, _a, _b, _c, _d = _both(n, agg_strategy="exchange")
    assert prows == jrows == want and len(prows) == 4
    names = ("mesh_q1_global_hash", "global_hash_insert",
             "global_hash_reduce")
    before = pjit.total_for(*names)
    pmq.run_q1_mesh(["cpu"] * n, schema="micro", agg_strategy="global_hash")
    assert pjit.total_for(*names) == before
