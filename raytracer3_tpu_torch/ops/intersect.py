"""Brute-force ray/triangle intersection and the ``Hit`` record (port of
``raytracer3_tpu/ops/intersect.py``).

Dense all-pairs Möller–Trumbore: the Cornell-box backend and the oracle that
BVH traversal is checked against. Hit records mirror the reference
``RayPayload``: (t, barycentric u/v, primitive id), ``t = BACKGROUND_DEPTH``
on a miss."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytracer3_tpu_torch.ops import mathx

BACKGROUND_DEPTH = mathx.BACKGROUND_DEPTH
_EPS = 1e-7


class Hit(NamedTuple):
    """Batched hit record."""

    t: torch.Tensor  # [N] distance, BACKGROUND_DEPTH on miss
    uv: torch.Tensor  # [N, 2] barycentric (u, v)
    prim_id: torch.Tensor  # [N] int32 triangle index, -1 on miss
    hit: torch.Tensor  # [N] bool
    # Two-level (TLAS) backends: hit instance, -1 on miss; None otherwise.
    inst: Optional[torch.Tensor] = None  # [N] int32

    @staticmethod
    def miss(shape, *, device) -> "Hit":
        shape = tuple(shape)
        return Hit(
            t=torch.full(shape, BACKGROUND_DEPTH, dtype=torch.float32, device=device),
            uv=torch.zeros(shape + (2,), dtype=torch.float32, device=device),
            prim_id=torch.full(shape, -1, dtype=torch.int32, device=device),
            hit=torch.zeros(shape, dtype=torch.bool, device=device),
        )


def ray_triangle(origin, direction, v0, v1, v2, t_min=1e-4, t_max=BACKGROUND_DEPTH):
    """Möller–Trumbore, broadcast over matching leading shapes. Returns
    (t, u, v, hit_mask); t = t_max where there is no hit. Two-sided."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = mathx.cross(direction, e2)
    det = mathx.dot(e1, pvec, keepdims=False)
    inv_det = torch.where(det.abs() > _EPS, 1.0 / det, 0.0)
    tvec = origin - v0
    u = mathx.dot(tvec, pvec, keepdims=False) * inv_det
    qvec = mathx.cross(tvec, e1)
    v = mathx.dot(direction, qvec, keepdims=False) * inv_det
    t = mathx.dot(e2, qvec, keepdims=False) * inv_det
    hit = (
        (det.abs() > _EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return torch.where(hit, t, t_max), u, v, hit


def ray_sphere(origin, direction, center, radius, t_min=1e-4, t_max=BACKGROUND_DEPTH):
    """Analytic sphere intersection (nearest positive root) → (t, hit)."""
    oc = origin - center
    b = mathx.dot(oc, direction, keepdims=False)
    c = mathx.dot(oc, oc, keepdims=False) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min, t0, t1)
    hit = (disc > 0.0) & (t > t_min) & (t < t_max)
    return torch.where(hit, t, t_max), hit


def ray_aabb(origin, inv_direction, box_min, box_max, t_min=0.0, t_max=BACKGROUND_DEPTH):
    """Slab test, ``inv_direction = 1/d`` (inf for zero components) →
    (t_near, intersects)."""
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    t_near = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    t_far = torch.clamp_max(torch.maximum(t0, t1).amin(dim=-1), t_max)
    return t_near, t_near <= t_far


def _closest(origins, directions, v0, v1, v2, t_min, t_max):
    """Closest hit over all triangles → (index [N,1], t, found, u, v); the
    first triangle wins exact t ties (the reference's argmin)."""
    t, u, v, hit = ray_triangle(
        origins[:, None, :], directions[:, None, :], v0[None], v1[None], v2[None],
        t_min, t_max,
    )
    best = torch.argmin(t, dim=1, keepdim=True)
    best_t = t.gather(1, best)[:, 0]
    found = hit.gather(1, best)[:, 0]
    return best, best_t, found, u.gather(1, best)[:, 0], v.gather(1, best)[:, 0]


def intersect_bruteforce(
    origins, directions, tri_v0, tri_v1, tri_v2, t_min=1e-4, t_max=BACKGROUND_DEPTH,
) -> Hit:
    """All-pairs closest hit: rays [N,3] × triangles [T,3] → Hit [N]."""
    best, best_t, found, u, v = _closest(
        origins, directions, tri_v0, tri_v1, tri_v2, t_min, t_max
    )
    found = found & (best_t < t_max)
    return Hit(
        t=torch.where(found, best_t, BACKGROUND_DEPTH),
        uv=torch.stack([u, v], dim=-1),
        prim_id=torch.where(found, best[:, 0], -1).to(torch.int32),
        hit=found,
    )


def occluded_bruteforce(
    origins, directions, tri_v0, tri_v1, tri_v2, t_min=1e-4, t_max=BACKGROUND_DEPTH,
) -> torch.Tensor:
    """Any-hit shadow query: True where the segment [t_min, t_max] is
    blocked. t_max may be scalar or per-ray [N]."""
    if isinstance(t_max, torch.Tensor) and t_max.ndim == 1:
        t_max = t_max[:, None]
    _, _, _, hit = ray_triangle(
        origins[:, None, :], directions[:, None, :],
        tri_v0[None], tri_v1[None], tri_v2[None], t_min, t_max,
    )
    return hit.any(dim=1)


def brute_backend(scene=None, tris=None, *, device):
    """Brute-force TraceBackend over a Scene's triangles or explicit
    ``tris=(v0, v1, v2)``, numpy arrays or tensors, put on ``device``."""
    from raytracer3_tpu_torch.ops.backend import TraceBackend

    if tris is None:
        tris = scene.tri_vertices()
    v0, v1, v2 = (torch.as_tensor(t, dtype=torch.float32, device=device) for t in tris)

    def isect_fn(arrays, o, d):
        return intersect_bruteforce(o, d, arrays["v0"], arrays["v1"], arrays["v2"])

    def occl_fn(arrays, o, d, tmax):
        return occluded_bruteforce(o, d, arrays["v0"], arrays["v1"], arrays["v2"], t_max=tmax)

    def capped_fn(arrays, o, d, tmax, anyhit=None):
        # Per-ray-capped closest hit; ``anyhit`` is an optimization hint the
        # dense oracle ignores (ops/backend.py capped_fn contract).
        tm = tmax[:, None] if isinstance(tmax, torch.Tensor) and tmax.ndim == 1 else tmax
        best, best_t, found, u, v = _closest(
            o, d, arrays["v0"], arrays["v1"], arrays["v2"], 1e-4, tm
        )
        return Hit(
            t=torch.where(found, best_t, BACKGROUND_DEPTH),
            uv=torch.stack([u, v], dim=-1),
            prim_id=torch.where(found, best[:, 0], -1).to(torch.int32),
            hit=found,
        )

    return TraceBackend(
        {"v0": v0, "v1": v1, "v2": v2}, isect_fn, occl_fn, capped_fn=capped_fn
    )
