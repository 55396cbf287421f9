"""Page wire serde (the cross-process exchange format) and spill frames
(the disk tier's file format).

Reference analog: ``execution/buffer/PagesSerdeFactory.java:24`` +
``PageSerializer.java`` / ``PageDeserializer.java`` (block encodings in a
compressed, checksummed frame) and ``spiller/FileSingleStreamSpiller.java``
(a page stream in a compressed, checksummed file).

Both formats are the JAX engine's (``trino_tpu/exec/serde.py``), copied
byte for byte so the two engines write the same bytes for the same host
page and read each other's frames. A page frame holds dtype-tagged raw
buffers and a packed null bitmap per block; dictionary pools ship once
per (stream, channel, pool), later pages carrying only the pool id and
the pool's growth (a delta); zlib level 1; CRC-32 over the compressed
body. A spill frame holds a parked page's columns, null masks and valid
mask, written atomically.

``PageSerializer.serialize`` takes a host ``Page``. A ``DevicePage``
reaches it through ``DevicePage.to_page``, which compacts the live lanes
on the device before the one copy to the host.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..block import Block, Dictionary, Page

_MAGIC = 0x54505047  # "TPPG"
_SPILL_MAGIC = 0x54505350  # "TPSP"


def spill_frame(cols: List[np.ndarray], nulls: List[np.ndarray],
                valid: np.ndarray, compress: bool = True) -> bytes:
    """One disk-spill frame: dtype-tagged raw buffers in a compressed,
    CRC-checksummed envelope — the page-frame discipline applied to a
    parked SpilledPage's arrays (reference:
    ``spiller/FileSingleStreamSpiller``'s serialized page stream).
    Dictionaries do NOT ride along: spill files are read back by the
    process that wrote them, where pools are shared host objects.

    In-memory convenience over ``_write_spill_stream`` — the ONE
    encoder of the spill format (shared with ``write_spill_file``)."""
    buf = io.BytesIO()
    _write_spill_stream(buf, cols, nulls, valid, compress)
    return buf.getvalue()


def parse_spill_frame(frame: bytes):
    """Inverse of ``spill_frame``; raises on any corruption (bad magic,
    CRC mismatch, short frame) — a torn spill file must fail loudly,
    never yield partial rows. In-memory convenience over
    ``_read_spill_stream``, the ONE decoder of the spill format."""
    return _read_spill_stream(io.BytesIO(frame))


#: read/compress granularity for the streaming spill paths: bounds the
#: transient RAM of a spill write/read to one chunk + one array instead
#: of the whole frame (the ack-cursor "stream, don't materialize" shape
#: applied to the disk tier)
_SPILL_CHUNK = 1 << 20


def _write_spill_stream(f, cols, nulls, valid, compress: bool):
    """STREAMING spill encoder (the one writer of the format): arrays
    feed one compressobj in bounded chunks straight onto ``f`` (never
    the whole frame in RAM), CRC accumulates over the compressed body
    as written and is patched into the header afterwards. ``f`` must be
    positioned at 0 and seekable."""
    arrays = [np.ascontiguousarray(a) for a in [*cols, *nulls, valid]]
    raw_len = 2 + sum(1 + len(a.dtype.str.encode()) + 4 + a.nbytes
                      for a in arrays)
    comp = zlib.compressobj(1) if compress else None
    crc = 0
    # CRC placeholder: the body streams first, the header's crc field
    # is patched once the last byte is known
    f.write(struct.pack("<IBII", _SPILL_MAGIC,
                        1 if compress else 0, raw_len, 0))

    def emit(data):
        nonlocal crc
        out = comp.compress(data) if comp is not None else data
        if out:
            crc = zlib.crc32(out, crc)
            f.write(out)

    emit(struct.pack("<H", len(cols)))
    for a in arrays:
        tag = a.dtype.str.encode()
        emit(struct.pack("<B", len(tag)) + tag
             + struct.pack("<I", a.nbytes))
        mv = memoryview(a).cast("B")
        for off in range(0, len(mv), _SPILL_CHUNK):
            emit(mv[off:off + _SPILL_CHUNK])
    if comp is not None:
        tail = comp.flush()
        crc = zlib.crc32(tail, crc)
        f.write(tail)
    f.flush()
    f.seek(9)  # <IBII: crc sits after magic(4)+flag(1)+raw_len(4)
    f.write(struct.pack("<I", crc))
    f.flush()


def write_spill_file(path: str, cols, nulls, valid,
                     compress: bool = True) -> int:
    """Atomic streaming spill write: ``_write_spill_stream`` onto a
    sibling temp file, fsync, rename — a crash mid-write leaves no
    half-frame under the final name."""
    import os

    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        _write_spill_stream(f, cols, nulls, valid, compress)
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return os.path.getsize(path)


def _read_spill_stream(f):
    """STREAMING spill decoder (the one reader of the format):
    decompress + parse in bounded chunks (the unparsed tail never
    exceeds one array + one chunk). Arrays are handed back only after
    the whole body's CRC verified — corruption still fails loudly
    before any consumer sees rows."""
    head = f.read(13)
    if len(head) < 13:
        raise T.TrinoError("spill frame truncated",
                           "GENERIC_INTERNAL_ERROR")
    magic, compressed, raw_len, crc = struct.unpack("<IBII", head)
    if magic != _SPILL_MAGIC:
        raise T.TrinoError("bad spill frame magic",
                           "GENERIC_INTERNAL_ERROR")
    decomp = zlib.decompressobj() if compressed else None
    state = {"crc": 0, "raw": 0, "eof": False}
    buf = bytearray()

    def feed() -> bool:
        if state["eof"]:
            return False
        chunk = f.read(_SPILL_CHUNK)
        try:
            if not chunk:
                state["eof"] = True
                if decomp is not None:
                    tail = decomp.flush()
                    state["raw"] += len(tail)
                    buf.extend(tail)
                return False
            state["crc"] = zlib.crc32(chunk, state["crc"])
            out = decomp.decompress(chunk) if decomp is not None \
                else chunk
        except zlib.error as e:
            # zlib's own integrity check can fire before our CRC
            # comparison does — same loud-failure contract
            raise T.TrinoError(f"spill frame corrupt: {e}",
                               "GENERIC_INTERNAL_ERROR")
        state["raw"] += len(out)
        buf.extend(out)
        return True

    def take(n: int, writable: bool = False):
        while len(buf) < n:
            if not feed():
                raise T.TrinoError("spill frame truncated",
                                   "GENERIC_INTERNAL_ERROR")
        # a bytearray slice is already a fresh writable bytearray —
        # keeps the resulting ndarray writable (consumers re-upload
        # and may mutate) without a second copy; headers become bytes
        out = buf[:n] if writable else bytes(buf[:n])
        del buf[:n]
        return out

    try:
        (ncols,) = struct.unpack("<H", take(2))
        arrays: List[np.ndarray] = []
        for _ in range(2 * ncols + 1):
            (tlen,) = struct.unpack("<B", take(1))
            dtype = np.dtype(take(tlen).decode())
            (nbytes,) = struct.unpack("<I", take(4))
            arrays.append(np.frombuffer(take(nbytes, writable=True),
                                        dtype=dtype))
        while feed():
            pass
    except (ValueError, TypeError, UnicodeDecodeError,
            struct.error) as e:
        # parsing runs AHEAD of the full-body CRC check (the read
        # is incremental), so corrupted bytes can surface here
        # first — keep the loud typed-failure contract
        raise T.TrinoError(f"spill frame corrupt: {e}",
                           "GENERIC_INTERNAL_ERROR")
    if state["crc"] != crc:
        raise T.TrinoError("spill frame checksum mismatch",
                           "GENERIC_INTERNAL_ERROR")
    if state["raw"] != raw_len:
        raise T.TrinoError("spill frame length mismatch",
                           "GENERIC_INTERNAL_ERROR")
    return arrays[:ncols], arrays[ncols:2 * ncols], arrays[2 * ncols]


def read_spill_file(path: str):
    """Streaming spill read off disk (``_read_spill_stream`` over the
    open file: bounded chunks, CRC verified before rows are handed
    back)."""
    with open(path, "rb") as f:
        return _read_spill_stream(f)


def _jsonable(v):
    """Pool-entry -> JSON: tuples become tagged lists (nesting survives
    the round trip as tuples, not lists) and Decimals become tagged
    strings."""
    from decimal import Decimal

    if isinstance(v, tuple):
        return ["t", [_jsonable(x) for x in v]]
    if isinstance(v, Decimal):
        return ["d", str(v)]
    return ["v", v]


def _from_jsonable(doc):
    from decimal import Decimal

    tag, payload = doc
    if tag == "t":
        return tuple(_from_jsonable(x) for x in payload)
    if tag == "d":
        return Decimal(payload)
    return payload


def _wire_signature(t: T.Type) -> str:
    """Type -> wire string. TIMESTAMP WITH TIME ZONE carries its zone
    (case-sensitive) in brackets; ``parse_type`` alone would drop it."""
    if t.is_timestamp_tz:
        return f"timestamptz[{t.zone}]"
    return str(t)


def _parse_wire_signature(sig: str) -> T.Type:
    if sig.startswith("timestamptz[") and sig.endswith("]"):
        return T.timestamp_tz_type(sig[len("timestamptz["):-1])
    return T.parse_type(sig)


class PageSerializer:
    """One serializer per output stream (per consumer); tracks which
    dictionary pools were already shipped on each channel."""

    def __init__(self, compress: bool = True):
        self.compress = compress
        self._sent_pools: Dict[Tuple[int, int], int] = {}
        self._next_pool_id = 1

    def serialize(self, page: Page) -> bytes:
        parts: List[bytes] = [struct.pack("<IH", page.num_rows,
                                          page.channel_count)]
        for ch, b in enumerate(page.blocks):
            b = b.numpy()
            sig = _wire_signature(b.type).encode()
            flags = 0
            dict_payload = b""
            if b.dictionary is not None:
                key = (ch, id(b.dictionary))
                pool_id = self._sent_pools.get(key)
                if pool_id is None:
                    pool_id = self._next_pool_id
                    self._next_pool_id += 1
                    # pool contents ride along exactly once per stream;
                    # later pages reference the id only.  Pools are
                    # append-only, so ship the CURRENT length and send a
                    # delta if it grew (scan pools grow across pages).
                    self._sent_pools[key] = pool_id
                    sent_len = 0
                else:
                    sent_len = self._sent_pools.get((ch, -pool_id), 0)
                values = b.dictionary.values
                delta = list(values[sent_len:])
                # record what was ACTUALLY sent: the pool may grow
                # concurrently (Dictionary.code is thread-safe growth),
                # and len(values) re-read here could exceed the slice
                self._sent_pools[(ch, -pool_id)] = sent_len + len(delta)
                if b.type.is_pooled and not b.type.is_string:
                    # composite pool entries (tuples) ship as JSON;
                    # flag bit 4 tells the reader to decode them back
                    enc = [json.dumps(_jsonable(v)).encode()
                           for v in delta]
                    flags |= 4
                else:
                    enc = [v.encode() for v in delta]
                dict_payload = struct.pack("<III", pool_id, sent_len,
                                           len(enc))
                dict_payload += b"".join(
                    struct.pack("<I", len(e)) + e for e in enc)
                flags |= 2
            data = np.ascontiguousarray(b.data).tobytes()
            if b.nulls is not None:
                flags |= 1
                nulls = np.packbits(b.nulls.astype(np.uint8)).tobytes()
            else:
                nulls = b""
            parts.append(struct.pack("<BH", flags, len(sig)))
            parts.append(sig)
            parts.append(dict_payload)
            parts.append(struct.pack("<I", len(data)))
            parts.append(data)
            parts.append(struct.pack("<I", len(nulls)))
            parts.append(nulls)
        raw = b"".join(parts)
        body = zlib.compress(raw, 1) if self.compress else raw
        header = struct.pack("<IBII", _MAGIC, 1 if self.compress else 0,
                             len(raw), zlib.crc32(body))
        return header + body


class PageDeserializer:
    """One per input stream; reconstructs dictionary pools by id."""

    def __init__(self):
        self._pools: Dict[Tuple[int, int], Dictionary] = {}

    def deserialize(self, frame: bytes) -> Page:
        magic, compressed, raw_len, crc = struct.unpack_from("<IBII",
                                                             frame, 0)
        if magic != _MAGIC:
            raise T.TrinoError("bad page frame magic",
                               "GENERIC_INTERNAL_ERROR")
        body = frame[13:]
        if zlib.crc32(body) != crc:
            raise T.TrinoError("page frame checksum mismatch",
                               "GENERIC_INTERNAL_ERROR")
        raw = zlib.decompress(body) if compressed else body
        if len(raw) != raw_len:
            raise T.TrinoError("page frame length mismatch",
                               "GENERIC_INTERNAL_ERROR")
        off = 0
        num_rows, nch = struct.unpack_from("<IH", raw, off)
        off += 6
        blocks = []
        for ch in range(nch):
            flags, sig_len = struct.unpack_from("<BH", raw, off)
            off += 3
            sig = raw[off:off + sig_len].decode()
            off += sig_len
            type_ = _parse_wire_signature(sig)
            dictionary: Optional[Dictionary] = None
            if flags & 2:
                pool_id, sent_len, n_delta = struct.unpack_from(
                    "<III", raw, off)
                off += 12
                values = []
                for _ in range(n_delta):
                    (vlen,) = struct.unpack_from("<I", raw, off)
                    off += 4
                    text = raw[off:off + vlen].decode()
                    values.append(_from_jsonable(json.loads(text))
                                  if flags & 4 else text)
                    off += vlen
                dictionary = self._pools.get((ch, pool_id))
                if dictionary is None:
                    dictionary = Dictionary()
                    self._pools[(ch, pool_id)] = dictionary
                if len(dictionary) < sent_len + len(values):
                    # append the delta POSITIONALLY (pools may repeat
                    # values — Dictionary.aligned — so dedup via code()
                    # would misalign codes)
                    for v in values[len(dictionary) - sent_len:]:
                        dictionary._index.setdefault(
                            v, len(dictionary.values))
                        dictionary.values.append(v)
                    dictionary._sort_rank = None
            (dlen,) = struct.unpack_from("<I", raw, off)
            off += 4
            data = np.frombuffer(raw, dtype=type_.storage, count=num_rows,
                                 offset=off).copy()
            off += dlen
            (nlen,) = struct.unpack_from("<I", raw, off)
            off += 4
            nulls = None
            if flags & 1:
                bits = np.frombuffer(raw, dtype=np.uint8, count=nlen,
                                     offset=off)
                nulls = np.unpackbits(bits, count=num_rows).astype(bool)
            off += nlen
            blocks.append(Block(type_, data, nulls, dictionary))
        return Page(blocks, num_rows)
