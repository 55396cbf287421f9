"""The qgen draws repeat for a seed, stay within TPC-H clause 2.4's
ranges (a ``list`` draw within its values, distinct), and every
stream's statements follow from the seed alone."""

import datetime

import numpy as np
import pytest

from sqlbench import workload

RANGES = {
    "q1": {"DELTA": range(60, 121)},
    "q3": {"SEGMENT": {"AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                       "HOUSEHOLD"},
           "DATE": {(datetime.date(1995, 3, 1) + datetime.timedelta(d)
                     ).isoformat() for d in range(31)}},
    "q6": {"DATE": {f"{y}-01-01" for y in range(1993, 1998)},
           "DISCOUNT": {f"0.0{d}" for d in range(2, 10)},
           "QUANTITY": {24, 25}},
    "q18": {"QUANTITY": range(312, 316)},
}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_draws_repeat_and_stay_in_range(name):
    t = workload.load_template(name)
    rng1, rng2 = np.random.default_rng([5, 1]), np.random.default_rng([5, 1])
    a = [t.draw(rng1) for _ in range(2000)]
    b = [t.draw(rng2) for _ in range(2000)]
    assert a == b
    seen = {k: set() for k in RANGES[name]}
    for params in a:
        assert set(params) == set(RANGES[name])
        for k, v in params.items():
            assert v in RANGES[name][k], (name, k, v)
            seen[k].add(v)
    for k, allowed in RANGES[name].items():
        assert len(seen[k]) == len(allowed), (name, k, "not all drawn")


@pytest.mark.parametrize("traffic", ["agg", "exchange", "exchange2"])
def test_plan_follows_the_seed(traffic):
    t = workload.load_traffic(traffic)
    seed = 2 ** 31 + 99
    p1 = workload.plan(t, seed, window_statements=64)
    p2 = workload.plan(t, seed, window_statements=64)
    p3 = workload.plan(t, seed + 1, window_statements=64)
    assert p1 == p2 and p1 != p3
    assert p1["poll_s"] == t["poll_ms"] / 1e3
    users = [s["user"] for s in p1["streams"]]
    assert len(set(users)) == len(users) == t["streams"]
    for s in p1["streams"]:
        most = t.get("warmup_max_per_template", t["warmup_per_template"])
        assert most >= t["warmup_per_template"] >= 1
        for stmts in s["warmup"]:
            assert len(stmts) == most and \
                len({w["template"] for w in stmts}) == 1
        warm = [w["template"] for stmts in s["warmup"] for w in stmts]
        assert sorted(warm) == sorted(t["templates"] * most)
        names = [w["template"] for w in s["window"]]
        k = len(t["templates"])
        assert sorted(names[:k]) == sorted(t["templates"])
        assert all(names[i] == names[i % k] for i in range(len(names)))
        for w in s["window"]:
            assert workload.load_template(w["template"]).render(
                w["params"]) == w["sql"]
    firsts = [s["window"][0]["template"] for s in p1["streams"]]
    assert len(set(firsts)) == min(len(firsts), len(t["templates"]))


def test_list_draws_k_distinct_values_and_repeats():
    """dsqgen's ``ulist``: ``k`` distinct values of the list, the same
    for the same seed, rendered as literals for ``IN (...)``."""
    states = ["AL", "CA", "GA", "IA", "IL", "KS", "MI", "MN", "O'K"]
    t = workload.Template("t", "select 1 where s in ({STATES})",
                          {"STATES": {"kind": "list", "values": states,
                                      "k": 3}})
    rng1, rng2 = np.random.default_rng([9, 1]), np.random.default_rng([9, 1])
    a = [t.draw(rng1)["STATES"] for _ in range(500)]
    assert a == [t.draw(rng2)["STATES"] for _ in range(500)]
    for picks in a:
        assert len(picks) == len(set(picks)) == 3
        assert set(picks) <= set(states)
    assert {s for picks in a for s in picks} == set(states)
    assert len({tuple(p) for p in a}) > 100
    assert t.render({"STATES": ["CA", "O'K", "AL"]}) == \
        "select 1 where s in ('CA', 'O''K', 'AL')"
