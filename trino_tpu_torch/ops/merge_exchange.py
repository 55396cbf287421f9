"""K-way merge exchange source: order-preserving distributed gather.

Reference analog: ``operator/MergeOperator.java`` +
``exchange/LocalMergeSourceOperator.java`` — the consumer of a merging
exchange k-way merges its producers' pre-sorted streams instead of
re-sorting the gathered whole.

The JAX engine's ``trino_tpu/ops/merge_exchange.py`` on torch. No
per-row heap: each round takes the HEAD page of every stream plus the
carry of the previous round, sorts that bounded window over the same
normalized sort operands the producers ordered by, and emits the prefix
whose keys are <= the watermark — the smallest "largest seen key" among
streams that may still deliver more rows (everything they send later is
>= it, so the prefix is globally final). Working set stays O(k pages),
not O(n), and output streams incrementally (blocked-token parking while
streams are empty).

Dictionary pools: producers encode strings against their own pools, so
pages re-encode into stable per-channel target pools before comparison
(same contract as ExchangeSourceOperator)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, Dictionary, Page, padded_size
from ..telemetry.device_reads import host_scalar
from .operator import SourceOperator
from .sort import _concat_pages
from .sortkeys import SortKey, lexsort_indices, sort_operands


def _lex_le(ops: Sequence, watermark: Sequence):
    """row_ops <= watermark, lexicographically, vectorized over rows."""
    res = torch.zeros(ops[0].shape, dtype=torch.bool, device=ops[0].device)
    tie = torch.ones(ops[0].shape, dtype=torch.bool, device=ops[0].device)
    for o, w in zip(ops, watermark):
        res = res | (tie & (o < w))
        tie = tie & (o == w)
    return res | tie


def _stream_max_key(ops: Sequence, valid):
    """Operands of the LARGEST valid row (pages are sorted, but the
    valid lanes need not be a prefix after wire transport), and the
    page's live-row count."""
    cap = valid.shape[0]
    idx = torch.arange(cap, device=valid.device)
    i_last = torch.max(torch.where(valid, idx, -1))
    safe = torch.clamp(i_last, 0, cap - 1)
    return [o[safe] for o in ops], valid.sum()


class _Stream:
    """One producer's page FIFO (channel = streaming poll/at_end, or a
    thunk revealing a prebuilt page list one page per poll)."""

    def __init__(self, source):
        self._chan = source if hasattr(source, "poll") else None
        self._thunk = None if self._chan is not None else source
        self._pages: Optional[List] = None if self._chan is None else []
        self.head: Optional[DevicePage] = None
        self.finished = False

    def _materialize(self):
        if self._thunk is not None and self._pages is None:
            self._pages = list(self._thunk())
            self._thunk = None

    def advance(self) -> bool:
        """Try to fill ``head``; True if state changed."""
        if self.head is not None or self.finished:
            return False
        if self._chan is None:
            self._materialize()
            if self._pages:
                self.head = self._pages.pop(0)
                return True
            self.finished = True
            return True
        item = self._chan.poll()
        if item is not None:
            self.head = item
            return True
        if self._chan.at_end():
            self.finished = True
            return True
        return False

    def blocked_token(self):
        if self._chan is not None and self.head is None \
                and not self.finished:
            token = self._chan.listen()
            if self._chan.at_end() or self._chan.has_page():
                return None
            return token
        return None


class MergeExchangeSourceOperator(SourceOperator):
    """Merges k sorted streams into one sorted stream of pages on
    ``device``."""

    def __init__(self, sources: Sequence, types_: Sequence[T.Type],
                 sort_keys: Sequence[SortKey], device):
        self.types = list(types_)
        self.sort_keys = list(sort_keys)
        self.device = device
        self.streams = [_Stream(s) for s in sources]
        self._carry: Optional[DevicePage] = None
        self._target_dicts: List[Optional[Dictionary]] = \
            [None] * len(self.types)
        self._done = False

    def add_split(self, split):
        raise AssertionError("merge exchange source has no splits")

    # -- pool unification (ExchangeSourceOperator contract) -------------

    def _unify(self, item) -> DevicePage:
        page = item.to_page() if isinstance(item, DevicePage) else item
        from ..block import Block

        blocks = []
        changed = False
        for c, t in enumerate(self.types):
            b = page.block(c).numpy()
            if not t.is_pooled or b.dictionary is None:
                blocks.append(b)
                continue
            tgt = self._target_dicts[c]
            if tgt is None:
                self._target_dicts[c] = b.dictionary
                blocks.append(b)
                continue
            if b.dictionary is tgt:
                blocks.append(b)
                continue
            remap = (np.asarray(tgt.encode(list(b.dictionary.values)),
                                dtype=np.int32)
                     if len(b.dictionary) else np.zeros(1, np.int32))
            blocks.append(Block(t, remap[b.data], b.nulls, tgt))
            changed = True
        host = Page(blocks, page.num_rows) if changed else page
        return DevicePage.from_page(host, self.device)

    # -- merge rounds ----------------------------------------------------

    def _ops_of(self, page: DevicePage):
        ops: List = []
        for k in self.sort_keys:
            ops.extend(sort_operands(
                page.cols[k.channel], page.nulls[k.channel],
                page.types[k.channel], page.dictionaries[k.channel],
                ascending=k.ascending, nulls_last=k.nulls_last))
        return ops

    def get_output(self) -> Optional[DevicePage]:
        if self._done:
            return None
        # fill heads; a round needs every unfinished stream to have one
        for s in self.streams:
            s.advance()
        if any(s.head is None and not s.finished for s in self.streams):
            return None  # parked on blocked_token
        batch: List[DevicePage] = []
        watermark = None  # lexicographic MIN over streams-with-more
        unconstrained = False  # an unfinished stream gave no key bound
        for s in self.streams:
            if s.head is None:
                continue
            page = self._unify(s.head)
            s.head = None
            more = bool(s._pages) if s._chan is None else not s.finished
            if page.count() == 0:
                # an unfinished stream revealing no rows bounds nothing:
                # emitting anything could race ahead of its future keys
                unconstrained = unconstrained or more
                continue
            batch.append(page)
            if more:
                key, cnt = _stream_max_key(self._ops_of(page), page.valid)
                if host_scalar(cnt, "merge_exchange.watermark") and (
                        watermark is None or host_scalar(_lex_le(
                            [k.reshape(1) for k in key], watermark)[0],
                            "merge_exchange.watermark")):
                    watermark = key
        if self._carry is not None:
            batch.insert(0, self._carry)
            self._carry = None
        if not batch:
            if all(s.finished and not (s._pages or s.head)
                   for s in self.streams):
                self._done = True
            return None

        cap = padded_size(sum(p.capacity for p in batch))
        merged = _concat_pages(batch, cap)
        ops = self._ops_of(merged)
        perm = lexsort_indices([(~merged.valid).to(torch.uint8)]
                               + list(ops))
        s_ops = [o[perm] for o in ops]
        s_cols = [c[perm] for c in merged.cols]
        s_nulls = [n[perm] for n in merged.nulls]
        s_valid = merged.valid[perm]
        if unconstrained:
            # hold everything until every live stream shows a key
            self._carry = DevicePage(list(merged.types),
                                     list(s_cols), list(s_nulls),
                                     s_valid, list(merged.dictionaries))
            return None
        if watermark is None:
            emit_valid = s_valid
            carry_valid = torch.zeros_like(s_valid)
        else:
            safe = _lex_le(s_ops, watermark)
            emit_valid = s_valid & safe
            carry_valid = s_valid & ~safe
        n_carry = int(host_scalar(carry_valid.sum(),
                                  "merge_exchange.rows"))
        if n_carry:
            self._carry = DevicePage(list(merged.types), s_cols,
                                     s_nulls, carry_valid,
                                     list(merged.dictionaries))
        n_emit = int(host_scalar(emit_valid.sum(), "merge_exchange.rows"))
        if n_emit == 0:
            return None  # watermark below every buffered row: wait
        return DevicePage(list(merged.types), s_cols, s_nulls,
                          emit_valid, list(merged.dictionaries))

    def metrics(self) -> Optional[dict]:
        """Aggregated per-stream channel stats (the merge consumes one
        channel per producer): flow counters plus the ack/replay
        machinery's reconnect counters when it engaged — the same
        surface ExchangeSourceOperator exposes for single channels."""
        out = {"kind": "merge-stream", "streams": len(self.streams)}
        rows = pages = reconnects = replayed = 0
        seen = False
        for s in self.streams:
            st = getattr(s._chan, "stats", None) if s._chan is not None \
                else None
            if not st:
                continue
            seen = True
            rows += st.get("rows", 0)
            pages += st.get("pages", 0)
            reconnects += st.get("reconnects", 0)
            replayed += st.get("replayed_frames", 0)
        if not seen:
            return None
        out["rows"] = rows
        out["pages"] = pages
        if reconnects:
            out["reconnects"] = reconnects
            out["replayed_frames"] = replayed
        return out

    def blocked_token(self):
        if self._done:
            return None
        toks = [t for t in (s.blocked_token() for s in self.streams)
                if t is not None]
        return toks[0] if toks else None

    def is_finished(self) -> bool:
        return self._done
