"""LBVH traversal on tensors (port of ``raytracer3_tpu/ops/traverse.py``):
batched closest-hit and any-hit (shadow) queries over ``ops/bvh.BVH``.

The ray batch advances in lockstep: each turn every live ray pops one
entry of its own near-first stack and either tests the leaf's triangle or
tests both children's boxes and pushes the hit ones, far first. Plain
PyTorch, as the reference's ``while_loop`` is plain jnp.

The reference's edges are kept exactly:
- a push at or above ``STACK_DEPTH`` is dropped (its ``mode="drop"``
  scatter) while the stack pointer still counts it; the stack has one
  spare column that takes the dropped writes;
- a pop above the stack reads its top entry (a JAX gather clamps an
  out-of-range index);
- an any-hit ray stops at its first accepted hit.
A ray whose stack is empty never changes again, so finished rays are
dropped from the working set (written back to the output) whenever fewer
than half of it are live; the turn count is unchanged (``LOOP_TURNS``).
"""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.ops import bvh as bvh_mod
from raytracer3_tpu_torch.ops import intersect, mathx

STACK_DEPTH = 64

# Turns of the last query's loop (the reference's while_loop iterations).
LOOP_TURNS = {"turns": 0}


def _prep(directions: torch.Tensor) -> torch.Tensor:
    d = torch.where(directions.abs() < 1e-12, 1e-12, directions)
    return 1.0 / d


def _compact(keep, out, state):
    """Write every working lane's result back, then keep ``keep`` lanes."""
    lane = state["lane"]
    for k in ("best_t", "best_u", "best_v", "best_id"):
        out[k][lane] = state[k]
    return {k: v[keep] for k, v in state.items()}


def bvh_intersect(bvh: bvh_mod.BVH, v0, v1, v2, origins, directions, t_min: float = 1e-4,
                  t_max=mathx.BACKGROUND_DEPTH, any_hit: bool = False) -> intersect.Hit:
    """Closest hit of rays [N, 3] against the LBVH; ``any_hit=True`` makes it
    an occlusion query that retires a ray on its first accepted hit."""
    n = origins.shape[0]
    dev = origins.device
    t_internal = bvh.num_internal
    t_tris = bvh.num_tris
    node_left, node_right = bvh.node_left.long(), bvh.node_right.long()
    leaf_tri = bvh.leaf_tri.long()
    t_max_arr = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).contiguous()

    out = {
        "best_t": t_max_arr.clone(),
        "best_u": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_v": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_id": torch.full((n,), -1, dtype=torch.int64, device=dev),
    }
    st = {k: v.clone() for k, v in out.items()}
    st.update(
        lane=torch.arange(n, device=dev), o=origins, d=directions, inv_d=_prep(directions),
        # Root (node 0) pushed; column STACK_DEPTH takes the dropped pushes.
        stack=torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=dev),
        sp=torch.ones(n, dtype=torch.int64, device=dev),
    )
    turns = 0
    while True:
        running = st["sp"] > 0
        n_live = int(running.sum())
        if n_live == 0:
            break
        if 2 * n_live < running.shape[0]:
            st = _compact(running, out, st)
            running = st["sp"] > 0
        sp = st["sp"]
        o, d, stack = st["o"], st["d"], st["stack"]
        sp_pop = torch.clamp_min(sp - 1, 0)
        node = stack.gather(1, sp_pop.clamp_max(STACK_DEPTH - 1)[:, None])[:, 0]
        sp = torch.where(running, sp_pop, sp)

        is_leaf = node >= t_internal
        node_i = node.clamp(0, t_internal - 1)

        # --- Leaf: the triangle -----------------------------------------
        tri = leaf_tri[(node - t_internal).clamp(0, t_tris - 1)]
        best_t = st["best_t"]
        tt, uu, vv, hh = intersect.ray_triangle(o, d, v0[tri], v1[tri], v2[tri], t_min, best_t)
        take = running & is_leaf & hh & (tt < best_t)
        best_t = torch.where(take, tt, best_t)
        st["best_u"] = torch.where(take, uu, st["best_u"])
        st["best_v"] = torch.where(take, vv, st["best_v"])
        best_id = torch.where(take, tri, st["best_id"])

        # --- Internal: both children's boxes, near first -----------------
        lchild = node_left[node_i]
        rchild = node_right[node_i]
        tl, hl = intersect.ray_aabb(o, st["inv_d"], bvh.node_min[lchild], bvh.node_max[lchild], t_min, best_t)
        tr, hr = intersect.ray_aabb(o, st["inv_d"], bvh.node_min[rchild], bvh.node_max[rchild], t_min, best_t)
        descend = running & ~is_leaf
        l_first = tl <= tr
        near = torch.where(l_first, lchild, rchild)
        far = torch.where(l_first, rchild, lchild)
        push_near = descend & torch.where(l_first, hl, hr)
        push_far = descend & torch.where(l_first, hr, hl)

        # Far first so near pops first; a push at or above the depth drops.
        stack.scatter_(1, torch.where(push_far & (sp < STACK_DEPTH), sp, STACK_DEPTH)[:, None], far[:, None])
        sp = sp + push_far
        stack.scatter_(1, torch.where(push_near & (sp < STACK_DEPTH), sp, STACK_DEPTH)[:, None], near[:, None])
        sp = sp + push_near
        if any_hit:
            sp = torch.where(best_id >= 0, 0, sp)
        st.update(sp=sp, best_t=best_t, best_id=best_id)
        turns += 1
    LOOP_TURNS["turns"] = turns
    _compact(slice(0, 0), out, st)

    found = out["best_id"] >= 0
    return intersect.Hit(
        t=torch.where(found, out["best_t"], mathx.BACKGROUND_DEPTH),
        uv=torch.stack([out["best_u"], out["best_v"]], dim=-1),
        prim_id=out["best_id"].to(torch.int32),
        hit=found,
    )


def bvh_occluded(bvh: bvh_mod.BVH, v0, v1, v2, origins, directions, t_max,
                 t_min: float = 1e-4) -> torch.Tensor:
    """Shadow query: True where the segment is blocked."""
    return bvh_intersect(bvh, v0, v1, v2, origins, directions, t_min, t_max, any_hit=True).hit


def make_bvh_backend(scene):
    """LBVH over a Scene's triangles on the scene's device →
    (intersect_fn, occluded_fn, BVH), the renderer's injected-backend
    signature."""
    v0, v1, v2 = scene.tri_vertices()
    bvh = build_lbvh_cached(v0, v1, v2)

    def isect(o, d):
        return bvh_intersect(bvh, v0, v1, v2, o, d)

    def occl(o, d, tmax):
        return bvh_occluded(bvh, v0, v1, v2, o, d, tmax)

    return isect, occl, bvh


def build_lbvh_cached(v0, v1, v2) -> bvh_mod.BVH:
    """The LBVH build, finished on the device before it returns (the
    reference's one jitted build program, waited on)."""
    bvh = bvh_mod.build_lbvh(v0, v1, v2)
    if bvh.node_min.is_cuda:
        torch.cuda.synchronize(bvh.node_min.device)
    return bvh
