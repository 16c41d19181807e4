"""LBVH traversal on tensors (port of ``raytracer3_tpu/ops/traverse.py``):
batched closest-hit and any-hit (shadow) queries over ``ops/bvh.BVH``.

On CUDA tensors ``bvh_intersect`` launches kernel C of
``csrc/oracle_bvh.cu`` (``lbvh_walk_kernel<AnyHit>``: one thread per ray,
a 64-entry stack of its own; ``ops/oracle_kernels.py``) or raises; it
reads nothing back, so a captured CUDA graph can hold it. On CPU tensors it
runs the plain version, ``bvh_intersect_plain``: the ray batch advances in
lockstep, each turn every live ray pops one entry of its own near-first
stack and either tests the leaf's triangle or tests both children's boxes
and pushes the hit ones, far first; plain PyTorch, as the reference's
``while_loop`` is plain jnp.

Both keep the reference's edges exactly:
- a push at or above ``STACK_DEPTH`` is dropped (its ``mode="drop"``
  scatter) while the stack pointer still counts it; the plain stack has
  one spare column that takes the dropped writes;
- a pop above the stack reads its top entry (a JAX gather clamps an
  out-of-range index);
- the near child is taken first on ``tl <= tr``;
- an any-hit ray stops at its first accepted hit.
In the plain version a ray whose stack is empty never changes again, so
finished rays are dropped from the working set (written back to the
output) whenever fewer than half of it are live; the turn count is
unchanged (``LOOP_TURNS``).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer3_tpu_torch.ops import bvh as bvh_mod
from raytracer3_tpu_torch.ops import intersect, mathx

STACK_DEPTH = 64

# Turns of the last plain query's loop (the reference's while_loop
# iterations).
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


def t_caps(t_max, n: int, device) -> torch.Tensor:
    """``t_max`` (a scalar or [N]) as a float32 [N] tensor on ``device``; a
    Python number is filled on the device, so that no copy from the host
    syncs a captured step."""
    if not isinstance(t_max, torch.Tensor) and np.ndim(t_max) == 0:
        return torch.full((n,), float(t_max), dtype=torch.float32, device=device)
    return torch.as_tensor(t_max, dtype=torch.float32, device=device).expand(n).contiguous()


def finish(best_t, best_u, best_v, best_id) -> intersect.Hit:
    """The walks' per-ray bests as a ``Hit``: t is BACKGROUND_DEPTH on a
    miss, where the best id is -1."""
    found = best_id >= 0
    return intersect.Hit(
        t=torch.where(found, best_t, mathx.BACKGROUND_DEPTH),
        uv=torch.stack([best_u, best_v], dim=-1),
        prim_id=best_id.to(torch.int32),
        hit=found,
    )


def bvh_intersect(bvh: bvh_mod.BVH, v0, v1, v2, origins, directions, t_min: float = 1e-4,
                  t_max=mathx.BACKGROUND_DEPTH, any_hit: bool = False) -> intersect.Hit:
    """Closest hit of rays [N, 3] against the LBVH; ``any_hit=True`` makes it
    an occlusion query that retires a ray on its first accepted hit.
    ``t_max`` is a scalar or [N]. CUDA tensors launch kernel C (counted in
    ``traverse_kernel.LAUNCHES`` as ``lbvh_closest``/``lbvh_any``) or
    raise; CPU tensors run ``bvh_intersect_plain``."""
    dev = origins.device
    if dev.type == "cpu":
        return bvh_intersect_plain(bvh, v0, v1, v2, origins, directions, t_min, t_max, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"bvh_intersect runs on cpu or cuda tensors, not {dev}")
    from raytracer3_tpu_torch.ops import oracle_kernels as ok
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    n = origins.shape[0]
    if n == 0:
        return intersect.Hit.miss((0,), device=dev)
    lib = ok.load_kernels()
    with torch.cuda.device(dev):
        out = ok.lbvh_walk(lib, bvh, v0, v1, v2, origins, directions, t_caps(t_max, n, dev), t_min, any_hit,
                           torch.cuda.current_stream(dev).cuda_stream)
    tk.LAUNCHES["lbvh_any" if any_hit else "lbvh_closest"] += 1
    return finish(*out)


def bvh_intersect_plain(bvh: bvh_mod.BVH, v0, v1, v2, origins, directions, t_min: float = 1e-4,
                        t_max=mathx.BACKGROUND_DEPTH, any_hit: bool = False, counts=None,
                        visited=None) -> intersect.Hit:
    """The plain version of ``bvh_intersect`` on any device: the lockstep
    loop, one host read a turn. For the kernel's bound: ``counts``, an int64
    [N, 2] tensor on the rays' device, gets each ray's internal-node and
    leaf pops added; ``visited``, a bool [2T-1] tensor, is set True at every
    node any ray pops."""
    n = origins.shape[0]
    dev = origins.device
    t_internal = bvh.num_internal
    t_tris = bvh.num_tris
    node_left, node_right = bvh.node_left.long(), bvh.node_right.long()
    leaf_tri = bvh.leaf_tri.long()
    out = {
        "best_t": t_caps(t_max, n, dev).clone(),
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
        if counts is not None:
            counts.index_add_(0, st["lane"], torch.stack([running & ~is_leaf, running & is_leaf], 1).long())
        if visited is not None:
            visited[node[running]] = True

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
    return finish(out["best_t"], out["best_u"], out["best_v"], out["best_id"])


def bvh_occluded(bvh: bvh_mod.BVH, v0, v1, v2, origins, directions, t_max,
                 t_min: float = 1e-4) -> torch.Tensor:
    """Shadow query: True where the segment is blocked."""
    return bvh_intersect(bvh, v0, v1, v2, origins, directions, t_min, t_max, any_hit=True).hit


def make_bvh_backend(scene):
    """LBVH over a Scene's triangles on the scene's device →
    (intersect_fn, occluded_fn, BVH), the renderer's injected-backend
    signature; on the card kernels A and B build it and kernel C walks it."""
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
