"""A generator module for the CPU tests that serves the port's own
TPC-DS connector through the harness's schema contract (``data.py``):
``TABLES``, ``source_rows``, ``generate`` and ``page_bounds``. It stands
in for a TPC-DS generator of the benchmark's own, which no configuration
has yet, so that a second schema, with nulls, goes through
``data.generate``, ``data.load_memory`` and the harness's runner. The
port's connector has no seed: only seed 0 is served."""

from typing import Dict, List, Sequence, Tuple

import numpy as np

from sqlbench import tpchgen
from trino_tpu_torch.connectors.tpcds import (TpcdsConnector,
                                              _TABLE_COLUMNS, _counts)

TABLES = tuple(_TABLE_COLUMNS)


def source_rows(table: str, sf: float) -> int:
    return _counts(sf)[table]


def generate(table: str, sf: float, columns: Sequence[str],
             seed: int) -> Dict[str, object]:
    """The port's page of ``table``, each block as the contract has it:
    a string column as (int32 codes, distinct strings), a column with
    nulls as a masked array."""
    assert seed == 0, "the port's TPC-DS connector has no seed"
    page = TpcdsConnector().table(table).generate(
        sf, 0, source_rows(table, sf), list(columns))
    out = {}
    for c, block in zip(columns, page.blocks):
        if block.type.is_string:
            assert block.nulls is None, c
            pool, codes = np.unique(
                np.array(block.dictionary.decode(block.data), dtype=object),
                return_inverse=True)
            out[c] = (codes.astype(np.int32), list(pool))
        elif block.nulls is None:
            out[c] = np.asarray(block.data)
        else:
            out[c] = np.ma.MaskedArray(np.asarray(block.data),
                                       mask=block.nulls_array())
    return out


def page_bounds(table: str, sf: float, seed: int, desired_splits: int,
                page_rows: int) -> List[Tuple[int, int]]:
    """The pages of the port's split manager and page source: the same
    rule as TPC-H's, over the table's rows."""
    return tpchgen.split_pages(source_rows(table, sf), desired_splits,
                               page_rows)
