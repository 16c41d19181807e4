"""TraceBackend: intersection backends as (table tensors + functions)
(port of ``raytracer3_tpu/ops/backend.py``).

- ``arrays`` — a dict of tensors (the acceleration-structure tables).
- ``intersect_fn(arrays, o, d) -> Hit`` and
  ``occluded_fn(arrays, o, d, t_max) -> bool[N]``.

The reference passes ``arrays`` through the jit boundary; PyTorch runs
eagerly, so ``bind`` simply closes over them."""

from __future__ import annotations

from typing import Any, Callable


class TraceBackend:
    def __init__(
        self,
        arrays: Any,
        intersect_fn: Callable,
        occluded_fn: Callable,
        meta: Any = None,
        capped_fn: Callable | None = None,
    ):
        self.arrays = arrays
        self.intersect_fn = intersect_fn
        self.occluded_fn = occluded_fn
        self.meta = meta  # backend-specific (e.g. PacketTables shape info)
        # Optional closest-hit trace with a PER-RAY t cap
        # ``(arrays, o, d, t_max[N], anyhit=None) -> Hit``.
        self.capped_fn = capped_fn

    def intersect(self, o, d):
        return self.intersect_fn(self.arrays, o, d)

    def occluded(self, o, d, t_max):
        return self.occluded_fn(self.arrays, o, d, t_max)

    def bind(self, arrays):
        """(isect, occl) closures over ``arrays``."""
        return (
            lambda o, d: self.intersect_fn(arrays, o, d),
            lambda o, d, t: self.occluded_fn(arrays, o, d, t),
        )
