"""Every reference returns the port's rows on its CPU path, for several
draws of each template, and a reference in float32 (the control) does
not."""

import json

import numpy as np
import pytest

from sqlbench import check, workload

#: extra draws outside the qgen ranges where those select nothing at
#: this scale (q18's QUANTITY over 300 matches no order of SF 0.01)
EXTRA = {"q18": [{"QUANTITY": 200}, {"QUANTITY": 250}]}


def _served(res):
    """A QueryResult as the protocol serves it: JSON values."""
    from trino_tpu_torch.server.protocol import _json_value

    cols = [{"name": n, "type": str(t)}
            for n, t in zip(res.column_names, res.types)]
    rows = [[_json_value(v, t) for v, t in zip(r, res.types)]
            for r in res.rows]
    return cols, json.loads(json.dumps(rows))


@pytest.mark.parametrize("name", ["q1", "q3", "q6", "q18"])
def test_reference_matches_port(name, db, cpu_runner):
    t = workload.load_template(name)
    rng = np.random.default_rng(7)
    draws = [t.draw(rng) for _ in range(3)] + EXTRA.get(name, [])
    tables = check.tables_of(db)
    ref = check.reference(name)
    nonempty = 0
    for params in draws:
        cols, rows = _served(cpu_runner.execute(t.render(params)))
        want = ref.answer(tables, params)
        nonempty += bool(rows)
        assert check.same_rows(rows, cols, want, ref.LIMIT, ref.ORDER_KEY), \
            (name, params, rows[:3], want[:3])
    assert nonempty


@pytest.mark.parametrize("name", ["q1", "q3"])
def test_float32_control_fails(name, db, cpu_runner):
    t = workload.load_template(name)
    rng = np.random.default_rng(8)
    records = []
    for _ in range(3):
        params = t.draw(rng)
        cols, _ = _served(cpu_runner.execute(t.render(params)))
        records.append({"template": name, "params": params,
                        "columns": cols})
    assert check.control(records, db, "float32")["mismatched"] >= 1
