"""The reference's own traversal: a binary BVH over the triangles in Morton
order, built on the host, and a stack walk per ray in plain PyTorch.

Independent of every tree and table of the program. The build sorts the
triangles by the 30-bit Morton code of their centroid, puts four to a leaf
and builds the complete binary tree over the leaves (node i has children 2i
and 2i + 1; the leaves are nodes n_leaves .. 2·n_leaves − 1), each box the
union of its children, widened by a small margin so that rounding in the
slab test never culls a triangle the exact test would accept; empty
nodes (the padding of the leaf count to a power of two) are never entered. The triangle
test is Möller–Trumbore with the program's accept rules and operation order
(|det| > 1e-9, t in (t_min, cap), two-sided; the first slot of a leaf wins
an exact tie), so a hit agrees with the program's to the bit unless two
triangles tie."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LEAF = 4
T_MIN = 1e-4
BACKGROUND_DEPTH = 100000.0
UNROLL = 8


class Bvh(NamedTuple):
    lo: torch.Tensor  # [2·L, 3] node boxes (node 0 unused)
    hi: torch.Tensor  # [2·L, 3]
    real: torch.Tensor  # [2·L] bool: the node holds a triangle
    tri: torch.Tensor  # [L·LEAF, 9] v0, e1, e2 of each slot (zeros in empty slots)
    tid: torch.Tensor  # [L·LEAF] triangle id, -1 in empty slots
    n_leaves: int
    depth: int


def _explode3(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def build(positions: np.ndarray, indices: np.ndarray, *, device) -> Bvh:
    """The tree over the triangles ``positions[indices]`` (host numpy)."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices, np.int64)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    n = idx.shape[0]
    cen = (v0.astype(np.float64) + v1 + v2) / 3.0
    lo, hi = cen.min(axis=0), cen.max(axis=0)
    q = np.clip((cen - lo) / np.maximum(hi - lo, 1e-12) * 1024.0, 0, 1023).astype(np.int64)
    code = (_explode3(q[:, 0]) << 2) | (_explode3(q[:, 1]) << 1) | _explode3(q[:, 2])
    order = np.argsort(code, kind="stable")

    n_leaves = 1
    while n_leaves * LEAF < n:
        n_leaves *= 2
    depth = int(np.log2(n_leaves))
    tid = np.full(n_leaves * LEAF, -1, np.int64)
    tid[:n] = order
    real = tid >= 0
    tri = np.zeros((n_leaves * LEAF, 9), np.float32)
    tri[real, 0:3] = v0[tid[real]]
    tri[real, 3:6] = v1[tid[real]] - v0[tid[real]]
    tri[real, 6:9] = v2[tid[real]] - v0[tid[real]]

    # Leaf boxes over their real slots; empty leaves get an inverted box.
    s_lo = np.full((n_leaves * LEAF, 3), np.inf)
    s_hi = np.full((n_leaves * LEAF, 3), -np.inf)
    s_lo[real] = np.minimum(np.minimum(v0[tid[real]], v1[tid[real]]), v2[tid[real]])
    s_hi[real] = np.maximum(np.maximum(v0[tid[real]], v1[tid[real]]), v2[tid[real]])
    box_lo = np.full((2 * n_leaves, 3), np.inf)
    box_hi = np.full((2 * n_leaves, 3), -np.inf)
    box_lo[n_leaves:] = s_lo.reshape(n_leaves, LEAF, 3).min(axis=1)
    box_hi[n_leaves:] = s_hi.reshape(n_leaves, LEAF, 3).max(axis=1)
    level = n_leaves
    while level > 1:
        parents = np.arange(level // 2, level)
        box_lo[parents] = np.minimum(box_lo[2 * parents], box_lo[2 * parents + 1])
        box_hi[parents] = np.maximum(box_hi[2 * parents], box_hi[2 * parents + 1])
        level //= 2
    # Widen every real box by a margin of the scene's scale.
    scale = float(np.abs(pos).max()) if pos.size else 1.0
    pad = 1e-5 * max(scale, 1.0)
    ok = np.isfinite(box_lo).all(axis=1)
    box_lo[ok] -= pad
    box_hi[ok] += pad

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    box_lo[~ok] = 0.0
    box_hi[~ok] = 0.0
    return Bvh(lo=up(box_lo, torch.float32), hi=up(box_hi, torch.float32), real=up(ok, torch.bool),
               tri=up(tri, torch.float32),
               tid=up(tid, torch.int64), n_leaves=n_leaves, depth=depth)


def _inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-12 taken as 1e-12 (a ray parallel to a slab
    sees it at ±1e12·distance)."""
    return 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)


def _slab(lo, hi, o, inv_d, t_cap):
    """(t_near, hit) of boxes [M, 3] against rays [M, 3] on (t_min, t_cap)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return t_near, (t_near <= t_far) & (t_far >= 0.0) & (t_near <= t_cap)


def _leaf_test(bvh: Bvh, leaf, o, d, t_cap):
    """Closest accepted slot of each ray's leaf: (found, t, u, v, tid)."""
    slots = (leaf - bvh.n_leaves)[:, None] * LEAF + torch.arange(LEAF, device=leaf.device)
    tri = bvh.tri[slots]  # [M, LEAF, 9]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[..., k] for k in range(9))
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-9
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > T_MIN) & (tt < t_cap[:, None])
          & (bvh.tid[slots] >= 0))
    tm = torch.where(ok, tt, torch.inf)
    best = torch.argmin(tm, dim=1, keepdim=True)
    found = ok.gather(1, best)[:, 0]
    return (found, tm.gather(1, best)[:, 0], uu.gather(1, best)[:, 0], vv.gather(1, best)[:, 0],
            bvh.tid[slots.gather(1, best)[:, 0]])


def trace(bvh: Bvh, origins, directions, t_max=None, any_hit: bool = False):
    """Closest hit (or, with ``any_hit``, whether any triangle lies on
    (t_min, t_max)) of rays [N, 3]. Returns (hit [N] bool, t, u, v, prim
    id int64); a miss holds (False, BACKGROUND_DEPTH, 0, 0, -1).

    Every ray still walking pops one node a step: a leaf's four slots are
    tested, an inner node's two children are slab-tested and pushed far
    first. The walking rays are compacted every ``UNROLL`` steps (the only
    reads of the device from the host)."""
    n = origins.shape[0]
    dev = origins.device
    cap = torch.full((n,), BACKGROUND_DEPTH, dtype=torch.float32, device=dev)
    if t_max is not None:
        cap = torch.minimum(cap, t_max.to(torch.float32))
    out_t, out_u = cap.clone(), torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v, out_id = torch.zeros_like(out_u), torch.full((n,), -1, dtype=torch.int64, device=dev)
    rays = torch.nonzero(torch.isfinite(origins).all(dim=1) & (origins.abs() < 1e29).all(dim=1))[:, 0]
    o, d = origins[rays], directions[rays]
    inv_d = _inv(d)
    best_t, best_u, best_v, best_id = cap[rays], out_u[rays], out_v[rays], out_id[rays]
    stack = torch.zeros((rays.shape[0], bvh.depth + 2), dtype=torch.int64, device=dev)
    stack[:, 0] = 1
    sp = torch.ones((rays.shape[0],), dtype=torch.int64, device=dev)
    row = torch.arange(rays.shape[0], device=dev)
    while rays.numel():
        for _ in range(UNROLL):
            act = sp > 0
            node = stack[row, (sp - 1).clamp_min(0)]
            sp = torch.where(act, sp - 1, sp)
            leaf = act & (node >= bvh.n_leaves)
            inner = act & (node < bvh.n_leaves)
            found, t, u, v, tid = _leaf_test(bvh, torch.where(leaf, node, bvh.n_leaves), o, d, best_t)
            found = found & leaf
            best_t = torch.where(found, t, best_t)
            best_u = torch.where(found, u, best_u)
            best_v = torch.where(found, v, best_v)
            best_id = torch.where(found, tid, best_id)
            if any_hit:
                sp = torch.where(found, 0, sp)
            c0 = 2 * torch.where(inner, node, 1)
            n0, h0 = _slab(bvh.lo[c0], bvh.hi[c0], o, inv_d, best_t)
            n1, h1 = _slab(bvh.lo[c0 + 1], bvh.hi[c0 + 1], o, inv_d, best_t)
            h0 = h0 & inner & bvh.real[c0]
            h1 = h1 & inner & bvh.real[c0 + 1]
            # Push the far child first, so the near one is popped next.
            near_first = n0 <= n1
            stack[row, sp] = torch.where(near_first, c0 + 1, c0)
            sp = sp + torch.where(near_first, h1, h0).to(torch.int64)
            stack[row, sp] = torch.where(near_first, c0, c0 + 1)
            sp = sp + torch.where(near_first, h0, h1).to(torch.int64)
        walking = sp > 0
        fin = ~walking
        out_t[rays[fin]], out_u[rays[fin]], out_v[rays[fin]], out_id[rays[fin]] = (
            best_t[fin], best_u[fin], best_v[fin], best_id[fin])
        rays, o, d, inv_d = rays[walking], o[walking], d[walking], inv_d[walking]
        best_t, best_u, best_v, best_id = best_t[walking], best_u[walking], best_v[walking], best_id[walking]
        stack, sp = stack[walking], sp[walking]
        row = torch.arange(rays.shape[0], device=dev)
    hit = out_id >= 0
    return hit, torch.where(hit, out_t, BACKGROUND_DEPTH), out_u, out_v, out_id
