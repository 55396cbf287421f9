"""What ``tpch_sf1_cluster4.exchange`` and ``.exchange2`` read is pinned:
a digest of every generated array, string pool and page bound of the
configuration, and of the statements ``workload.plan`` draws, each
taken on the harness before schemas had generators of their own
(``exchange2``'s with its 50 ms poll). A change to the data layer or to
the draws that moves either fails here."""

import hashlib
import json
import os

import numpy as np
import pytest

from sqlbench.tests.conftest import ROOT

SF = 0.01
TABLES = {
    0: "3a8bc8102749ab896cd30161bfb2ba007b6a75e4c9b07871ffd067abd4e41dc2",
    2 ** 31 + 11:
        "e89c84756f76a74d2622f650e63efeb53f28a4ac76d1fdeba203b699230676f1",
}
STATEMENTS = {
    ("exchange", 7):
        "1cae0530edf73e3e6016178fecd4aec85169bef9d36cbd549859ca6936ccd36d",
    ("exchange", 2 ** 31 + 99):
        "bbac8b3b79fbfc0b1ef678adc19b9e59989805f1ab8564a16839d744474041ed",
    ("exchange2", 7):
        "a0679228af6dd7968ae8900046789568c5fab1aa3a05f26ab352a4117a9213f4",
    ("exchange2", 2 ** 31 + 99):
        "d62163dffbaf9ad09451e19ad568c6cba65a89e18599b73c4a94090dc8a1a3fd",
}


def db_digest(db) -> str:
    h = hashlib.sha256()
    for name, t in db.tables.items():
        h.update(json.dumps([name, t.columns]).encode())
        for c, _ in t.columns:
            v = t.arrays[c]
            if isinstance(v, tuple):
                h.update(v[0].dtype.str.encode())
                h.update(v[0].tobytes())
                h.update("\x00".join(v[1]).encode())
            else:
                h.update(v.dtype.str.encode())
                h.update(np.ascontiguousarray(v).tobytes())
        h.update(np.asarray(t.pages, dtype=np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(TABLES))
def test_tables_and_pages_are_pinned(seed):
    from sqlbench import data, workload

    cfg = workload.read_json(os.path.join(
        ROOT, "sqlbench", "configs", "tpch_sf1_cluster4.json"))
    assert db_digest(data.generate(cfg, seed, SF)) == TABLES[seed]


@pytest.mark.parametrize("traffic,seed", sorted(STATEMENTS))
def test_statements_are_pinned(traffic, seed):
    from sqlbench import workload

    plan = workload.plan(workload.load_traffic(traffic), seed)
    got = hashlib.sha256(json.dumps(plan, sort_keys=True).encode())
    assert got.hexdigest() == STATEMENTS[(traffic, seed)]
