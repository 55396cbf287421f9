"""Named ROW fields in the torch engine: ``types.parse_type`` and the wire.

The page serde writes a block's type as ``str(type)``, so a ROW with
named fields travels as ``row(a bigint, b varchar)``. The JAX engine's
``parse_type`` reads each field as a type and cannot decode that frame
(a fault it keeps: the JAX package is the unchanged reference); the
port's reads ``name type`` fields, quoted names and nested
``row``/``array``/``map`` field types, and keeps an anonymous field
anonymous. The writer is unchanged, so a named-ROW frame stays
byte-equal to the JAX serializer's. The last case runs a statement that
returns a named ROW through ``ProcessQueryRunner(device="cpu")``: the
table crosses the wire to the worker processes and the rows come back
through it, equal to ``LocalQueryRunner(device="cpu")``'s.
"""

import pytest

from trino_tpu import types as JT
from trino_tpu.block import Page as JPage
from trino_tpu.exec.serde import PageDeserializer as JDe
from trino_tpu.exec.serde import PageSerializer as JSer
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import Page as PPage
from trino_tpu_torch.exec.serde import PageDeserializer as PDe
from trino_tpu_torch.exec.serde import PageSerializer as PSer


def _named(T):
    inner = T.row_type([("x", T.DOUBLE), (None, T.array_type(T.BIGINT))])
    return T.row_type([("a", T.BIGINT), ("b", T.VARCHAR), ("c", inner)])


@pytest.mark.parametrize("text,names", [
    ("row(a bigint, b varchar)", ("a", "b")),
    ("row(bigint, varchar)", (None, None)),
    ("ROW(A BIGINT, b  VARCHAR(10))", ("A", "b")),
    ('row("first field" bigint, "q""uote" date)', ("first field",
                                                   'q"uote')),
    ("row(a decimal(12, 2), b row(c integer, d array(row(e date))))",
     ("a", "b")),
    ("row(t timestamp(6) with time zone, double precision)", ("t", None)),
    ("row(date date, bigint)", ("date", None)),
])
def test_parse_named_row_fields(text, names):
    t = PT.parse_type(text)
    assert t.is_row and t.names == names
    # the parsed type prints back to a text that parses to itself (the
    # writer, the JAX engine's, does not quote names: a name that needs
    # quotes does not survive the print)
    if all(n is None or n.isidentifier() for n in names):
        assert PT.parse_type(str(t)) == t


def test_named_row_types_round_trip_and_anonymous_match_jax():
    for t in (_named(PT), PT.map_type(PT.VARCHAR, _named(PT)),
              PT.array_type(_named(PT))):
        assert PT.parse_type(str(t)) == t
    nested = PT.parse_type(str(_named(PT)))
    assert nested.types[2].names == ("x", None)
    # where the JAX engine can read a ROW (anonymous fields), both agree
    for text in ("row(bigint, varchar)", "row(decimal(12,2), array(date))",
                 "map(varchar, row(bigint, double))"):
        assert str(PT.parse_type(text)) == str(JT.parse_type(text))
    with pytest.raises(PT.TypeError_):
        PT.parse_type("row(a b c)")


def _page(T, Page):
    values = [None if i % 5 == 4 else
              (i, f"s{i % 3}", (i / 4.0, tuple(range(i % 3))))
              for i in range(23)]
    return Page.from_pylists([T.BIGINT, _named(T)],
                             [list(range(23)), values])


def test_named_row_frame_byte_equal_to_jax_and_decodes():
    jframe = JSer().serialize(_page(JT, JPage))
    pframe = PSer().serialize(_page(PT, PPage))
    assert pframe == jframe
    back = PDe().deserialize(jframe)
    assert back.blocks[1].type == _named(PT)
    assert back.to_rows() == _page(PT, PPage).to_rows()
    # the JAX engine keeps the fault: its reader refuses the frame
    with pytest.raises(JT.TypeError_):
        JDe().deserialize(pframe)


def _named_row_table(conn):
    """Table ``default.t`` (k bigint, r row(a bigint, b varchar, c
    row(x double, array(bigint)))) written through the connector API."""
    from trino_tpu_torch.connectors.spi import ColumnHandle

    cols = [ColumnHandle("k", PT.BIGINT, 0),
            ColumnHandle("r", _named(PT), 1)]
    handle = conn.metadata().create_table("default", "t", cols)
    sink = conn.page_sink(handle, cols)
    sink.append_page(_page(PT, PPage))
    sink.finish()


SQL = "select k, r from t where k < 20 order by k"


def test_process_runner_returns_named_row():
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.parallel import ProcessQueryRunner
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.sql.analyzer import Session

    conn = MemoryConnector()
    _named_row_table(conn)
    local = LocalQueryRunner({"memory": conn},
                             Session(catalog="memory", schema="default"),
                             device="cpu")
    want = local.execute(SQL)
    with ProcessQueryRunner({"memory": {"connector": "memory"}},
                            Session(catalog="memory", schema="default"),
                            n_workers=2, desired_splits=2,
                            device="cpu") as c:
        _named_row_table(c.connectors["memory"])
        # replicate the committed table to the workers: its frames carry
        # the named ROW type as text
        c._sync_table("memory", "default", "t")
        got = c.execute(SQL)
    assert got.rows == want.rows and len(got.rows) == 20
    assert got.rows[1][1] == (1, "s1", (0.25, (0,)))
    assert got.types == want.types and got.types[1] == _named(PT)
