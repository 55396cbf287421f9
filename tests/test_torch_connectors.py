"""Writes, DDL and SHOW over the memory and black-hole connectors: the
torch engine against the JAX engine.

Each case runs the same statements through both engines, each with its
own memory, black-hole and tpch catalogs, and compares every result:
the written-row counts of CTAS, INSERT and DELETE, the rows read back,
and the SHOW listings. These are the statements of the local cases of
tests/test_connectors.py (its distributed read waits for the port's
distribution), plus SHOW CATALOGS/SCHEMAS/TABLES/COLUMNS/SESSION and
DELETE with and without WHERE. A statement that fails in the JAX engine
must fail in the port with the same error code.
"""

import pytest

import trino_tpu_torch as P
from test_torch_tpch_q1 import _same_rows
from trino_tpu.connectors.blackhole import BlackHoleConnector as JBlackHole
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.types import TrinoError as JTrinoError
from trino_tpu_torch.connectors.blackhole import BlackHoleConnector
from trino_tpu_torch.connectors.catalog import create_catalogs
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.types import TrinoError


def _pair():
    jr = JRunner(
        {"memory": JMemory(),
         "blackhole": JBlackHole(rows_per_page=10, pages_per_split=2,
                                 split_count=2),
         "tpch": JTpch(page_rows=4096)},
        JSession(catalog="memory", schema="default"))
    pr = P.LocalQueryRunner(create_catalogs({
        "memory": {"connector": "memory"},
        "blackhole": {"connector": "blackhole", "rows_per_page": 10,
                      "pages_per_split": 2, "split_count": 2},
        "tpch": {"connector": "tpch", "page_rows": 4096}}),
        Session(catalog="memory", schema="default"), device="cpu")
    return jr, pr


def _run_both(statements):
    """Every statement through both engines in order; results (or error
    codes) must agree. Returns the torch engine's results."""
    jr, pr = _pair()
    out = []
    for sql in statements:
        try:
            want = jr.execute(sql)
        except JTrinoError as e:
            with pytest.raises(TrinoError) as got:
                pr.execute(sql)
            assert got.value.code == e.code, sql
            out.append(e.code)
            continue
        got = pr.execute(sql)
        assert got.column_names == want.column_names, sql
        _same_rows(got.rows, want.rows)
        out.append(got.rows)
    return out


def test_create_insert_select():
    got = _run_both([
        "create table t (a bigint, b varchar)",
        "insert into t values (1, 'x'), (2, 'y')",
        "select * from t order by a",
        "insert into t (b, a) values ('z', 3)",
        "select * from t order by a",
    ])
    assert got[1] == [(2,)]
    assert got[4] == [(1, "x"), (2, "y"), (3, "z")]


def test_ctas_from_tpch():
    got = _run_both([
        "create table n as select n_name, n_regionkey "
        "from tpch.micro.nation",
        "select count(*), max(n_regionkey) from n",
        "select n_regionkey, count(*) from n "
        "group by n_regionkey order by n_regionkey",
        "select n_name, n_regionkey from n order by n_name",
    ])
    assert got[0] == [(25,)]
    assert got[2] == [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]


def test_insert_missing_columns_get_null():
    got = _run_both([
        "create table u (a bigint, b double, c varchar)",
        "insert into u (a) values (7)",
        "select * from u",
    ])
    assert got[2] == [(7, None, None)]


@pytest.mark.parametrize("where", [True, False])
def test_delete(where):
    """DELETE rewrites the table's pages through its canonical
    dictionaries (with WHERE) or empties it (without)."""
    stmts = ["create table d as select n_nationkey, n_regionkey, n_name "
             "from tpch.micro.nation"]
    if where:
        stmts += ["delete from d where n_regionkey = 0",
                  "select count(*) from d",
                  "delete from d where n_name like 'A%' or n_nationkey > 20",
                  "select n_name, count(*) from d group by n_name "
                  "order by n_name",
                  "insert into d values (99, 9, 'ALGERIA')",
                  "select n_name, n_nationkey from d where n_name = 'ALGERIA'"]
    stmts += ["delete from d", "select count(*) from d"]
    got = _run_both(stmts)
    if where:
        assert got[1] == [(5,)] and got[2] == [(20,)]
    assert got[-1] == [(0,)]


def test_drop_table():
    got = _run_both([
        "create table g (x bigint)",
        "show tables",
        "drop table g",
        "show tables",
        "drop table if exists g",
        "drop table g",
    ])
    assert ("g",) in got[1] and ("g",) not in got[3]
    assert isinstance(got[5], str)  # an error in both engines


def test_create_if_not_exists():
    got = _run_both([
        "create table e (x bigint)",
        "create table if not exists e (x bigint)",
        "create table e (x bigint)",
    ])
    assert isinstance(got[2], str)


def test_blackhole_read_write():
    got = _run_both([
        "create table blackhole.default.bh "
        "as select n_nationkey from tpch.micro.nation",
        "select count(*) from blackhole.default.bh",
        "insert into blackhole.default.bh values (1), (2)",
    ])
    assert got == [[(25,)], [(40,)], [(2,)]]


def test_show_statements():
    got = _run_both([
        "create table s1 (a bigint, b varchar, c decimal(12,2), d date)",
        "create table s2 as select * from tpch.micro.region",
        "show schemas",
        "show schemas from tpch",
        "show tables",
        "show tables from tpch.micro",
        "show columns from s1",
        "show columns from s2",
        "show columns from tpch.micro.lineitem",
    ])
    assert got[4] == [("s1",), ("s2",)]


def test_show_session():
    """Names, values, defaults and types agree after a SET SESSION (the
    port's property descriptions drop the JAX engine's history notes)."""
    jr, pr = _pair()
    for r in (jr, pr):
        r.execute("set session desired_splits = 2")
        r.execute("set session spill_enabled = true")
    want = jr.execute("show session")
    got = pr.execute("show session")
    assert got.column_names == want.column_names
    assert [row[:4] for row in got.rows] == [row[:4] for row in want.rows]
    assert ("desired_splits", "2", "4", "integer") in \
        [row[:4] for row in got.rows]


def test_show_catalogs():
    """Both engines' runners add a ``system`` catalog of their own (the
    runtime tables over the runner's live state); the listings are the
    same."""
    jr, pr = _pair()
    want = jr.execute("show catalogs").rows
    assert pr.execute("show catalogs").rows == want
    assert want == [("blackhole",), ("memory",), ("system",), ("tpch",)]


def test_memory_table_dictionaries_stay_canonical():
    """Pages appended by several writes re-encode into one pool per
    column, so GROUP BY and joins over the table see one code space."""
    pr = P.LocalQueryRunner(
        {"memory": MemoryConnector(), "blackhole": BlackHoleConnector()},
        Session(catalog="memory", schema="default"), device="cpu")
    pr.execute("create table w (k varchar)")
    pr.execute("insert into w values ('b'), ('a')")
    pr.execute("insert into w values ('a'), ('c')")
    data = pr.metadata.connectors["memory"].tables[("default", "w")]
    assert len({id(p.block(0).dictionary) for p in data.pages}) == 1
    assert pr.execute("select k, count(*) from w group by k order by k"
                      ).rows == [("a", 2), ("b", 1), ("c", 1)]


def test_port_sources_import_neither_jax_nor_trino_tpu():
    """A grep over every source of the port and chip_smoke.py: no import
    of jax or of the JAX package; and importing the modules of the write,
    spill and EXPLAIN ANALYZE paths loads neither."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bad = re.compile(r"^\s*(import\s+(jax|jaxlib|trino_tpu)\b(?!_torch)"
                     r"|from\s+(jax|jaxlib|trino_tpu)\b(?!_torch))", re.M)
    paths = [os.path.join(repo, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(repo, "trino_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    hits = [p for p in paths if bad.search(open(p).read())]
    assert len(paths) > 40 and hits == []
    code = ("import sys, trino_tpu_torch.connectors.catalog, "
            "trino_tpu_torch.connectors.memory, "
            "trino_tpu_torch.connectors.blackhole, "
            "trino_tpu_torch.exec.serde, trino_tpu_torch.exec.memory, "
            "trino_tpu_torch.ops.sort, trino_tpu_torch.runner; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'trino_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
