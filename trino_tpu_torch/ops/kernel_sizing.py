"""Per-kernel-shape sizing history: remembered capacities so repeat
shapes land on the same sizes.

The JAX engine's ``trino_tpu/ops/kernel_sizing.py``, copied. There it
keeps jit'd programs at a stable STATIC capacity; in this engine it
sizes the batched executor's unified per-lane capacities (the burst's
aggregation merge and join expansion) and the hybrid hash join's
pool-derived fan-out, so both engines round the same observations to
the same powers of two. Grow IMMEDIATELY on a larger observation (an
undersized capacity means a lane overflow or an extra pass; an
oversized one only pads lanes), decay by EWMA so a transient spike
doesn't pin the capacity forever, and always emit through
``padded_size``.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..block import padded_size


class ShapeSizingHistory:
    """Process-wide remembered capacity per kernel shape key."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._ewma: Dict[tuple, float] = {}

    def suggest(self, key: tuple, need: int, minimum: int = 16) -> int:
        """The pow2-bucketed capacity for this shape: at least ``need``
        (exactness first), grown to the remembered level so a repeat
        shape whose need shrank a little keeps its compiled program.
        Records the observation."""
        with self._lock:
            prev = self._ewma.get(key)
            if prev is None or need >= prev:
                self._ewma[key] = float(need)
            else:
                self._ewma[key] = (self.alpha * need
                                   + (1 - self.alpha) * prev)
            remembered = int(round(self._ewma[key]))
        return padded_size(max(need, remembered, minimum))

    def reset(self) -> None:
        with self._lock:
            self._ewma.clear()


#: one history per process
KERNEL_SIZING = ShapeSizingHistory()
