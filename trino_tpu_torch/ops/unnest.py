"""UNNEST on torch: expand pooled array columns to one row per element.

Reference analog: ``operator/unnest/UnnestOperator.java`` (12 files of
per-type unnesters). The JAX engine's design (``trino_tpu/ops/unnest.py``)
as plain torch ops: arrays are dictionary codes, so the expansion is the
join-expansion pattern — per-row element counts come from a host
length-LUT over the pool, lanes expand with the cumsum/searchsorted trick,
and element values gather from a FLATTENED element LUT (elements of pool
entry c live at flat[offset[c] .. offset[c] + len(c))). Varchar elements
re-encode into a fresh element pool.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, Dictionary, padded_size, storage_dtype
from .operator import Operator


class UnnestOperator(Operator):
    def __init__(self, input_types: Sequence[T.Type],
                 array_channels: Sequence[int],
                 element_types: Sequence[T.Type],
                 with_ordinality: bool = False):
        self.input_types = list(input_types)
        self.array_channels = list(array_channels)
        self.element_types = list(element_types)
        self.with_ordinality = with_ordinality
        self._pending: Optional[DevicePage] = None
        self._done = False
        self._luts: Dict = {}  # (chan, pool uid, len, device) -> bundle

    @property
    def output_types(self) -> List[T.Type]:
        out = list(self.input_types) + list(self.element_types)
        if self.with_ordinality:
            out.append(T.BIGINT)
        return out

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def _channel_luts(self, chan: int, d: Optional[Dictionary],
                      et: T.Type, device):
        """(len_lut, offset_lut, (flat_values, flat_nulls), element_dict)
        on ``device``: per-code array length, flat offset, and the
        flattened element payload."""
        key = (chan, d.uid if d is not None else 0,
               len(d) if d is not None else 0, device)
        hit = self._luts.get(key)
        if hit is not None:
            return hit
        values = d.values if d is not None else []
        lens = np.asarray([len(v) for v in values] or [0], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]) \
            .astype(np.int64)
        flat: List = []
        for v in values:
            flat.extend(v)
        edict = None
        if et.is_pooled:
            edict = Dictionary()
            flat_vals = edict.encode(flat)
            if not len(flat_vals):
                flat_vals = np.zeros(1, dtype=np.int32)
            enull = np.asarray([v is None for v in flat] or [False],
                               dtype=bool)
        else:
            flat_vals = np.zeros(max(len(flat), 1), dtype=et.storage)
            enull = np.zeros(max(len(flat), 1), dtype=bool)
            for i, v in enumerate(flat):
                if v is None:
                    enull[i] = True
                elif et.is_decimal:
                    flat_vals[i] = et.to_raw(v)
                else:
                    flat_vals[i] = v
        bundle = tuple(torch.from_numpy(a).to(device)
                       for a in (lens, offsets, flat_vals, enull)) + (edict,)
        if len(self._luts) >= 128:
            self._luts.clear()
        self._luts[key] = bundle
        return bundle

    def add_input(self, page: DevicePage):
        n = page.capacity
        dev = page.device
        per_chan = []
        counts = torch.zeros(n, dtype=torch.int64, device=dev)
        for ch, et in zip(self.array_channels, self.element_types):
            lens, offsets, flat_vals, flat_null, edict = self._channel_luts(
                ch, page.dictionaries[ch], et, dev)
            codes = torch.clamp(page.cols[ch].to(torch.int64), 0,
                                lens.shape[0] - 1)
            live = page.valid & ~page.nulls[ch]
            clen = torch.where(live, lens[codes], 0)
            counts = torch.maximum(counts, clen)
            per_chan.append((codes, clen, offsets, flat_vals, flat_null,
                             edict))
        total = int(counts.sum())  # one scalar sync per page
        cap = padded_size(max(total, 16))
        probe_idx, within, lane_valid = _expand_with_pos(counts, cap)

        out_cols = [c[probe_idx] for c in page.cols]
        out_nulls = [x[probe_idx] for x in page.nulls]
        out_dicts = list(page.dictionaries)
        for (codes, clen, offsets, flat_vals, flat_null, edict), et in zip(
                per_chan, self.element_types):
            pos = torch.clamp(offsets[codes[probe_idx]] + within, 0,
                              flat_vals.shape[0] - 1)
            in_arr = within < clen[probe_idx]
            out_cols.append(flat_vals[pos].to(storage_dtype(et)))
            out_nulls.append(~in_arr | flat_null[pos])
            out_dicts.append(edict)
        if self.with_ordinality:
            out_cols.append(within + 1)
            out_nulls.append(torch.zeros(cap, dtype=torch.bool, device=dev))
            out_dicts.append(None)
        self._pending = DevicePage(self.output_types, out_cols, out_nulls,
                                   lane_valid, out_dicts)

    def get_output(self) -> Optional[DevicePage]:
        out, self._pending = self._pending, None
        if out is None and self._finishing:
            self._done = True
        return out

    def is_finished(self) -> bool:
        return self._done


def _expand_with_pos(counts, cap: int):
    """lane j -> (source row, position within that row's expansion,
    live); dead lanes point at a row in range."""
    off_end = torch.cumsum(counts, 0)
    j = torch.arange(cap, dtype=torch.int64, device=counts.device)
    row = torch.clamp(torch.searchsorted(off_end, j, right=True), 0,
                      counts.shape[0] - 1)
    within = j - (off_end[row] - counts[row])
    return row, within, j < off_end[-1]
