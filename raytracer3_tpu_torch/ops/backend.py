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
        self_sorting: bool = False,
        primary_fn: Callable | None = None,
        capped_fn: Callable | None = None,
    ):
        self.arrays = arrays
        self.intersect_fn = intersect_fn
        self.occluded_fn = occluded_fn
        self.meta = meta  # backend-specific (e.g. PacketTables shape info)
        # True when the backend coherence-sorts rays itself (treelets):
        # callers then pass sort_rays=False to the wavefront, since an outer
        # sorted_trace would repeat the sort and its gathers.
        self.self_sorting = self_sorting
        # Optional trace for tile-ordered primary rays, which are coherent
        # already: it skips the backend's own sort.
        self.primary_fn = primary_fn
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

    def bind_primary(self, arrays):
        """Closure for the primary trace (``intersect_fn`` when the backend
        has no primary trace of its own)."""
        fn = self.primary_fn or self.intersect_fn
        return lambda o, d: fn(arrays, o, d)

    def bind_capped(self, arrays):
        """Closure for the per-ray-capped closest-hit trace, or None when the
        backend has none. The optional ``anyhit`` ([N] bool) flags lanes that
        may retire on their first accepted hit (shadow lanes of a mixed
        launch)."""
        if self.capped_fn is None:
            return None
        return lambda o, d, t, anyhit=None: self.capped_fn(arrays, o, d, t, anyhit)
