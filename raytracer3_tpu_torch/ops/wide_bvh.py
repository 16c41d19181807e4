"""Wide BVH (port of ``raytracer3_tpu/ops/wide_bvh.py``): the binary →
wide collapse, host-side numpy (``_binary_ranges``, ``collapse``), the
LBVH-plus-collapse build (``build_wide``) and the wide traversal
(``wbvh_intersect``, ``make_wide_backend``).

On CUDA tensors ``wbvh_intersect`` launches kernel E of
``csrc/oracle_bvh.cu`` (``wide_walk_kernel<AnyHit>``: one thread per ray, a
48-entry stack of its own; ``ops/oracle_kernels.py``) or raises; it reads
nothing back, so a captured CUDA graph can hold it. On CPU tensors it runs
the plain version, ``wbvh_intersect_plain``: the reference's lockstep loop
in plain PyTorch, one host read a turn.

The collapse must equal the reference's exactly: the cluster-BVH tables
built from it are compared bit for bit. It takes the triangles only when
the caller traverses the result (``tris=``); the cluster build passes none,
so its tables do not change."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch.ops import bvh as bvh_mod
from raytracer3_tpu_torch.ops import intersect, mathx
from raytracer3_tpu_torch.ops.traverse import _compact, finish, t_caps

WIDTH = 8
STACK_DEPTH = 48
_LEAF_COUNT_BITS = 4
_LEAF_COUNT_MAX = (1 << _LEAF_COUNT_BITS) - 1


class WideBVH(NamedTuple):
    child_min: np.ndarray  # [W, width, 3] f32 (+inf for empty slots)
    child_max: np.ndarray  # [W, width, 3] f32 (-inf for empty slots)
    # empty → -1; internal → wide node id (>= 0);
    # leaf → -(start << 4 | count) - 2  (count in [1, 15])
    child_code: np.ndarray  # [W, width] int32
    tri_order: np.ndarray  # [T] int32 leaf order of the primitives
    # The triangles in leaf order, for traversal (None from a collapse
    # without ``tris``, as the cluster build's).
    tri_v0: np.ndarray | None = None  # [T, 3] f32
    tri_v1: np.ndarray | None = None
    tri_v2: np.ndarray | None = None


def _binary_ranges(left: np.ndarray, right: np.ndarray, t: int):
    """Leaf-range [lo, hi] per binary internal node (iterative postorder)."""
    lo = np.full(t - 1, -1, np.int64)
    hi = np.full(t - 1, -1, np.int64)

    def leaf_range(c):
        if c >= t - 1:
            k = c - (t - 1)
            return k, k
        return None

    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        l, r = left[node], right[node]
        if processed:
            llo, lhi = (leaf_range(l) or (lo[l], hi[l]))
            rlo, rhi = (leaf_range(r) or (lo[r], hi[r]))
            lo[node] = min(llo, rlo)
            hi[node] = max(lhi, rhi)
        else:
            stack.append((node, True))
            for c in (l, r):
                if c < t - 1:
                    stack.append((int(c), False))
    return lo, hi


def collapse(bvh, leaf_size: int = 4, width: int = WIDTH, tris=None) -> WideBVH:
    """Collapse a binary BVH (``node_min/max [2T-1,3]``, ``node_left/right
    [T-1]``, ``leaf_tri [T]``) into a ``width``-ary BVH; with ``tris=(v0,
    v1, v2)`` the result also carries them in leaf order."""
    if not 1 <= leaf_size <= _LEAF_COUNT_MAX:
        raise ValueError(f"leaf_size must be in [1, {_LEAF_COUNT_MAX}], got {leaf_size}")
    t = len(bvh.leaf_tri)
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    lo, hi = _binary_ranges(left, right, t)

    def subtree_size(b):
        if b >= t - 1:
            return 1
        return int(hi[b] - lo[b] + 1)

    def subtree_range(b):
        if b >= t - 1:
            k = b - (t - 1)
            return k, k
        return int(lo[b]), int(hi[b])

    wide_children: list = [None]  # per wide node: list of binary ids
    # Build wide nodes breadth-first; each entry is a binary node id to expand.
    pending = [0]
    wide_of_binary = {0: 0}
    while pending:
        b = pending.pop(0)
        w = wide_of_binary[b]
        # Gather up to `width` slots by splitting the largest internal child.
        slots = [left[b], right[b]] if b < t - 1 else [b]
        while len(slots) < width:
            best = -1
            best_sz = 0
            for si, sb in enumerate(slots):
                if sb < t - 1:
                    sz = subtree_size(sb)
                    if sz > leaf_size and sz > best_sz:
                        best, best_sz = si, sz
            if best < 0:
                break
            sb = slots.pop(best)
            slots.extend([left[sb], right[sb]])
        wide_children[w] = list(slots)
        # Children that stay internal become new wide nodes.
        for sb in slots:
            sb = int(sb)
            if sb < t - 1 and subtree_size(sb) > leaf_size:
                if sb not in wide_of_binary:
                    wide_of_binary[sb] = len(wide_children)
                    wide_children.append(None)
                    pending.append(sb)

    wn = len(wide_children)
    child_min = np.full((wn, width, 3), np.inf, np.float32)
    child_max = np.full((wn, width, 3), -np.inf, np.float32)
    child_code = np.full((wn, width), -1, np.int32)

    for b, w in wide_of_binary.items():
        for si, sb in enumerate(wide_children[w]):
            sb = int(sb)
            if sb >= t - 1:  # single-primitive binary leaf
                start = sb - (t - 1)
                code = -((start << _LEAF_COUNT_BITS) | 1) - 2
            elif subtree_size(sb) <= leaf_size:  # multi-primitive leaf range
                start, end = subtree_range(sb)
                code = -((start << _LEAF_COUNT_BITS) | (end - start + 1)) - 2
            else:  # internal
                code = wide_of_binary[sb]
            child_min[w, si] = nmin[sb]
            child_max[w, si] = nmax[sb]
            child_code[w, si] = code

    order = np.asarray(bvh.leaf_tri).astype(np.int32)
    sorted_tris = (None, None, None) if tris is None else tuple(np.asarray(v)[order] for v in tris)
    return WideBVH(child_min, child_max, child_code, order, *sorted_tris)


def build_wide(v0, v1, v2, leaf_size: int = 4) -> WideBVH:
    """LBVH build on the vertices' device + collapse (host) + one upload of
    the tables to that device."""
    bvh = bvh_mod.build_lbvh(v0, v1, v2)
    host = bvh_mod.BVH(*(x.cpu().numpy() for x in bvh))
    wb = collapse(host, leaf_size, tris=tuple(v.detach().cpu().numpy() for v in (v0, v1, v2)))
    return WideBVH(*(torch.as_tensor(a, device=v0.device) for a in wb))


def wbvh_intersect(wb: WideBVH, origins, directions, t_min: float = 1e-4, t_max=mathx.BACKGROUND_DEPTH,
                   any_hit: bool = False, leaf_size: int = 4) -> intersect.Hit:
    """Closest hit of rays [N, 3] through the wide BVH (``any_hit=True``:
    an occlusion query that retires a ray on its first accepted hit);
    ``t_max`` a scalar or [N]. CUDA tensors launch kernel E (counted in
    ``traverse_kernel.LAUNCHES`` as ``wide_closest``/``wide_any``) or raise;
    CPU tensors run ``wbvh_intersect_plain``."""
    dev = origins.device
    if dev.type == "cpu":
        return wbvh_intersect_plain(wb, origins, directions, t_min, t_max, any_hit, leaf_size)
    if dev.type != "cuda":
        raise ValueError(f"wbvh_intersect runs on cpu or cuda tensors, not {dev}")
    from raytracer3_tpu_torch.ops import oracle_kernels as ok
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    n = origins.shape[0]
    if n == 0:
        return intersect.Hit.miss((0,), device=dev)
    lib = ok.load_kernels()
    with torch.cuda.device(dev):
        out = ok.wide_walk(lib, wb, leaf_size, origins, directions, t_caps(t_max, n, dev), t_min, any_hit,
                           torch.cuda.current_stream(dev).cuda_stream)
    tk.LAUNCHES["wide_any" if any_hit else "wide_closest"] += 1
    return finish(*out)


def wbvh_intersect_plain(wb: WideBVH, origins, directions, t_min: float = 1e-4, t_max=mathx.BACKGROUND_DEPTH,
                         any_hit: bool = False, leaf_size: int = 4, counts=None, visited=None) -> intersect.Hit:
    """The plain version of ``wbvh_intersect`` on any device: the lockstep
    wide traversal. Stack entries reuse the child-code encoding (internal
    id ≥ 0, leaf ranges < -1, empty -1). As in ``ops/traverse``: a push at
    the full stack drops (here the pointer stays at the depth), finished
    rays leave the working set when fewer than half are live. For kernel
    E's bound: ``counts``, an int64 [N, 4] tensor on the rays' device, gets
    each ray's node pops, triangle tests, real (non-empty) slots of the
    popped nodes and the compares of kernel E's insertion sort of their hit
    children added; ``visited``, a bool [W + T] tensor, is set True at
    every wide node popped and every triangle (leaf order) tested."""
    n = origins.shape[0]
    dev = origins.device
    width = wb.child_code.shape[1]
    n_nodes = wb.child_code.shape[0]
    n_tris = wb.tri_order.shape[0]
    tri_order = wb.tri_order.long()
    d = torch.where(directions.abs() < 1e-12, 1e-12, directions)
    out = {
        "best_t": t_caps(t_max, n, dev).clone(),
        "best_u": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_v": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_id": torch.full((n,), -1, dtype=torch.int64, device=dev),
    }
    st = {k: v.clone() for k, v in out.items()}
    st.update(
        lane=torch.arange(n, device=dev), o=origins, d=directions, inv_d=1.0 / d,
        # Wide node 0 pushed; column STACK_DEPTH takes the dropped pushes.
        stack=torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=dev),
        sp=torch.ones(n, dtype=torch.int64, device=dev),
    )
    while True:
        running = st["sp"] > 0
        n_live = int(running.sum())
        if n_live == 0:
            break
        if 2 * n_live < running.shape[0]:
            st = _compact(running, out, st)
            running = st["sp"] > 0
        sp, o, dirs, stack = st["sp"], st["o"], st["d"], st["stack"]
        sp_pop = torch.clamp_min(sp - 1, 0)
        entry = stack.gather(1, sp_pop[:, None])[:, 0]
        sp = torch.where(running, sp_pop, sp)
        is_leaf = entry < -1
        is_node = running & (entry >= 0)
        if visited is not None:
            visited[entry[is_node].clamp_max(n_nodes - 1)] = True

        # --- Leaf: up to leaf_size contiguous triangles --------------------
        leaf_bits = -(entry + 2)
        start = leaf_bits >> _LEAF_COUNT_BITS
        count = leaf_bits & _LEAF_COUNT_MAX
        best_t, best_u, best_v, best_id = st["best_t"], st["best_u"], st["best_v"], st["best_id"]
        for j in range(leaf_size):
            ti = (start + j).clamp(0, n_tris - 1)
            tt, uu, vv, hh = intersect.ray_triangle(o, dirs, wb.tri_v0[ti], wb.tri_v1[ti], wb.tri_v2[ti],
                                                    t_min, best_t)
            take = running & is_leaf & (j < count) & hh & (tt < best_t)
            if visited is not None:
                visited[n_nodes + ti[running & is_leaf & (j < count)]] = True
            best_t = torch.where(take, tt, best_t)
            best_u = torch.where(take, uu, best_u)
            best_v = torch.where(take, vv, best_v)
            best_id = torch.where(take, tri_order[ti], best_id)

        # --- Internal: test the children, push far to near ------------------
        node = entry.clamp(0, wb.child_code.shape[0] - 1)
        codes = wb.child_code[node].long()  # [N, width]
        tn, hit_w = intersect.ray_aabb(o[:, None, :], st["inv_d"][:, None, :], wb.child_min[node],
                                       wb.child_max[node], t_min, best_t[:, None])
        valid = hit_w & (codes != -1) & is_node[:, None]
        if counts is not None:
            # Kernel E inserts the hit children in slot order, each moving
            # past the m earlier ones with a strictly smaller key: m compares,
            # one more where it stops at a larger or equal one.
            earlier = valid[:, None, :] & torch.ones(width, width, dtype=torch.bool, device=dev).tril(-1)
            before = earlier.sum(2)
            moved = (earlier & (tn[:, None, :] < tn[:, :, None])).sum(2)
            compares = torch.where(valid, moved + (moved < before).long(), 0).sum(1)
            real = ((codes != -1) & is_node[:, None]).sum(1)
            tested = torch.where(running & is_leaf, torch.clamp_max(leaf_bits & _LEAF_COUNT_MAX, leaf_size), 0)
            counts.index_add_(0, st["lane"], torch.stack([is_node.long(), tested, real, compares], 1))
        key = torch.where(valid, tn, float("-inf"))
        order = torch.argsort(-key, dim=1, stable=True)  # far → near
        codes_s = codes.gather(1, order)
        valid_s = valid.gather(1, order)
        for c in range(width):
            push = valid_s[:, c]
            stack.scatter_(1, torch.where(push & (sp < STACK_DEPTH), sp, STACK_DEPTH)[:, None],
                           codes_s[:, c:c + 1])
            # The pointer stops at the depth: an overflowing push drops its
            # entry instead of letting later pops read out of range.
            sp = torch.clamp_max(sp + push, STACK_DEPTH)
        if any_hit:
            sp = torch.where(best_id >= 0, 0, sp)
        st.update(sp=sp, best_t=best_t, best_u=best_u, best_v=best_v, best_id=best_id)
    _compact(slice(0, 0), out, st)
    return finish(out["best_t"], out["best_u"], out["best_v"], out["best_id"])


def make_wide_backend(scene, leaf_size: int = 4):
    """Scene → (intersect_fn, occluded_fn, WideBVH) on the scene's device;
    on the card kernels A and B build the LBVH, the host collapses it, and
    kernel E walks it."""
    v0, v1, v2 = scene.tri_vertices()
    wb = build_wide(v0, v1, v2, leaf_size)

    def isect(o, d):
        return wbvh_intersect(wb, o, d, leaf_size=leaf_size)

    def occl(o, d, tmax):
        return wbvh_intersect(wb, o, d, t_max=tmax, any_hit=True, leaf_size=leaf_size).hit

    return isect, occl, wb
