"""Spill frames: the disk tier's file format.

Reference analog: ``spiller/FileSingleStreamSpiller.java`` (a page stream
in a compressed, checksummed frame). This is the JAX engine's spill frame
(``trino_tpu/exec/serde.py``), copied byte for byte so a parked page
writes the same bytes in both engines: dtype-tagged raw buffers of the
page's columns, null masks and valid mask, zlib level 1, CRC-32 over the
compressed body, written atomically. The exchange page serde of that
module comes with the multi-process runner (the one-card distributed
runner hands pages between its tasks in memory).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List

import numpy as np

from .. import types as T

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
