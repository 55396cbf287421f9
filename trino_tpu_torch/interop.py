"""Building device pages from plain numpy data.

Pages made by another engine (the JAX engine's, turned into numpy) enter
this one here, lane for lane: same capacity, same padding, same null and
valid masks, same dictionary codes. Only numpy arrays and Python lists of
pool values cross, so nothing of the other engine is imported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import types as T
from .block import DevicePage, Dictionary


def device_page_from_numpy(types: Sequence[T.Type],
                           cols: Sequence[np.ndarray],
                           nulls: Sequence[np.ndarray],
                           valid: np.ndarray,
                           dictionary_values: Sequence[Optional[list]],
                           device) -> DevicePage:
    """A DevicePage on ``device`` holding exactly these lanes.

    ``dictionary_values[i]`` is the value pool of a pooled column i (its
    codes index it), None for every other column; each pool becomes an
    aligned Dictionary so codes keep their meaning even where values
    repeat."""
    if not (len(types) == len(cols) == len(nulls) == len(dictionary_values)):
        raise ValueError("types, cols, nulls and dictionary_values must "
                         "have one entry per column")
    cap = len(valid)
    out_cols, out_nulls, dicts = [], [], []
    for t, c, n, pool in zip(types, cols, nulls, dictionary_values):
        c = np.array(c, dtype=t.storage)   # a writable, owned copy
        n = np.array(n, dtype=bool)
        if c.shape != (cap,) or n.shape != (cap,):
            raise ValueError(f"column of shape {c.shape} / nulls of shape "
                             f"{n.shape} on a page of capacity {cap}")
        out_cols.append(torch.from_numpy(c).to(device))
        out_nulls.append(torch.from_numpy(n).to(device))
        if t.is_pooled:
            dicts.append(Dictionary.aligned(pool if pool is not None
                                            else []))
        else:
            dicts.append(None)
    valid_t = torch.from_numpy(np.array(valid, dtype=bool))
    return DevicePage(list(types), out_cols, out_nulls, valid_t.to(device),
                      dicts)
