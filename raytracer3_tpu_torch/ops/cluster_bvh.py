"""Cluster BVH (port of ``raytracer3_tpu/ops/cluster_bvh.py``): the host
build and the ``cluster`` trace backend.

Build: triangles → clusters of ≤ leaf_size (native SAH clustering) →
binned-SAH binary BVH over the cluster boxes (native) → wide collapse →
packed node and cluster tables, all numpy; ``build_cluster_bvh`` uploads
them to a device. The tables must equal the reference's bit for bit, so the
build runs the same native source (``native/rt3native.cpp``, built and bound
by the port's own ``raytracer3_tpu_torch.native``) and raises when it is
unavailable: the reference's Morton and device-LBVH fallbacks give other
trees and are not ported.

Traversal (``cbvh_intersect``, ``cluster_backend``, ``make_cluster_backend``):
on CUDA tensors kernel D of ``csrc/oracle_bvh.cu``
(``cluster_walk_kernel<AnyHit, Cap>``: one thread per ray,
``ops/oracle_kernels.py``) or a raise, with no host read, so a captured
CUDA graph can hold it; on CPU tensors the plain version,
``cbvh_intersect_plain``: the reference's lockstep walk over the 8-wide
tree in plain PyTorch, as its ``while_loop`` is plain jnp. Its one-hot MXU
fetches are TPU mechanics and become ordinary gathers; what they compute
is kept: child boxes rounded outwards (``_round_table_conservative``) then
to bfloat16 (the one-hot dot in bf16 with f32 accumulation has one non-zero
term, so it returns the bf16 value exactly), codes and triangles exact.
``walk_boxes`` makes that box table; ``build_cluster_bvh`` makes it once
with the upload (``ClusterBVH.boxes``), and both versions read it. Stack
entries are float32 codes (node m ≥ 0, leaf cluster −c−2), children are
pushed far first by the same 19-pair sort network, so exact-t ties resolve
as in the reference; the stack holds ``stack_entries(cb)`` =
``max(32, 7·depth + 1)`` entries and a push beyond it is dropped. In the
plain version a ray whose stack is empty never changes again, so finished
rays are dropped from the working set (written back to the output)
whenever fewer than half of it are live, as ``ops/traverse`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch import native
from raytracer3_tpu_torch.ops import intersect, mathx, traverse
from raytracer3_tpu_torch.ops import wide_bvh as wb_mod

WIDTH = 8  # children per node row of the traversal (the 64-lane layout)
STACK_DEPTH = 32


class ClusterBVH(NamedTuple):
    # Wide-node rows: cmin(3w) | cmax(3w) | codes(w), padded to 64 (w=8) or
    # a multiple of 128 lanes. Codes: node id ≥ 0, empty -1, cluster c at
    # -(c)-2.
    node_table: np.ndarray  # [M, 64|128] f32
    # Per-cluster packed triangles L × (v0 e1 e2), padded to 128 lanes.
    cluster_table: np.ndarray  # [C, ceil(9L/128)*128] f32
    tri_id: np.ndarray  # [C, L] int32 original triangle ids (-1 padding)
    leaf_size: int
    num_nodes: int
    num_clusters: int
    width: int = 8
    depth: int = 1  # exact tree depth (root = 1); sizes traversal stacks
    # The walk's child boxes [M, 48] f32 (``walk_boxes``), made once with
    # the device upload; None in a host build, which the walks refuse.
    boxes: object = None


def _host_tree_depth(codes: np.ndarray) -> int:
    """BFS depth of the wide tree from its child-code table.
    codes [M, width]: internal child = node id ≥ 0, leaf < -1, empty = -1."""
    depth = 1
    frontier = np.array([0], np.int64)
    while frontier.size:
        ch = codes[frontier].reshape(-1)
        nxt = np.unique(ch[ch >= 0].astype(np.int64))
        if nxt.size == 0:
            break
        frontier = nxt
        depth += 1
        if depth > 64:
            raise ValueError("BVH deeper than 64 levels — build produced a cycle?")
    return depth


def _build_clusters(v0, v1, v2, leaf_size: int, cluster_mode: str = "median", split_budget: float = 0.0):
    """Group triangles into clusters of ≤ leaf_size with the native library
    ("median": balanced full clusters; "sah": tighter, underfull clusters).

    ``split_budget`` > 0 clusters up to (1 + budget)·T axis-clipped
    fragments (``native.split_fragments``) in place of whole triangles: a
    fragment's row still packs its whole triangle, so hits do not change; a
    triangle may be found from any cluster holding one of its fragments.
    Returns (packed rows [C, lanes], tri_id [C, L], cmin [C,3], cmax [C,3])."""
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    # A primitive is a fragment (spatial splits) or a whole triangle.
    prim_tri = None  # fragment -> its triangle; None: the identity
    prim_min, prim_max = tri_min, tri_max
    if split_budget > 0:
        prim_tri, prim_min, prim_max = native.split_fragments(v0, v1, v2, budget=1.0 + split_budget)
        prim_tri = prim_tri.astype(np.int64)
    cluster_of, c = native.build_clusters(prim_min, prim_max, leaf_size, mode=cluster_mode)
    # Group primitive ids by cluster, pad each cluster to leaf_size.
    order = np.argsort(cluster_of, kind="stable").astype(np.int64)
    sizes = np.bincount(cluster_of, minlength=c)
    order_p = np.full((c, leaf_size), -1, np.int64)
    pos = 0
    for ci in range(c):
        k = sizes[ci]
        order_p[ci, :k] = order[pos : pos + k]
        pos += k
    order_p = order_p.reshape(-1)
    tri_of = order_p if prim_tri is None else np.where(order_p >= 0, prim_tri[np.maximum(order_p, 0)], -1)
    tri_id = tri_of.reshape(c, leaf_size).astype(np.int32)

    # Packed per-cluster triangle data (v0, e1, e2), degenerate for padding.
    safe = np.maximum(tri_of, 0)
    pv0 = v0[safe]
    pe1 = v1[safe] - pv0
    pe2 = v2[safe] - pv0
    dead = (order_p < 0)[:, None]
    pv0 = np.where(dead, 1e30, pv0)
    pe1 = np.where(dead, 0.0, pe1)
    pe2 = np.where(dead, 0.0, pe2)
    packed = np.concatenate([pv0, pe1, pe2], axis=-1).reshape(c, leaf_size * 9)
    lanes = ((leaf_size * 9 + 127) // 128) * 128
    packed = np.pad(packed, ((0, 0), (0, lanes - leaf_size * 9)))

    # Cluster boxes from the primitive boxes (the clipped ones under splits).
    psafe = np.maximum(order_p, 0)
    cmin = np.where(order_p[:, None] < 0, np.inf, prim_min[psafe]).reshape(c, leaf_size, 3).min(1)
    cmax = np.where(order_p[:, None] < 0, -np.inf, prim_max[psafe]).reshape(c, leaf_size, 3).max(1)
    return packed.astype(np.float32), tri_id, cmin.astype(np.float32), cmax.astype(np.float32)


def build_cluster_bvh_host(
    v0, v1, v2, leaf_size: int = 8, width: int = 8, cluster_mode: str = "median",
    split_budget: float = 0.0,
) -> ClusterBVH:
    """Clusters → SAH BVH over cluster boxes → wide collapse → tables (numpy)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    packed, tri_id, cmin, cmax = _build_clusters(v0, v1, v2, leaf_size, cluster_mode, split_budget)
    c = cmin.shape[0]

    if c == 1:
        # Single cluster: trivial one-node tree (root's first child = leaf 0).
        node = np.full((1, 64), 0.0, np.float32)
        node[0, 0:3] = cmin[0]
        node[0, 24:27] = cmax[0]
        node[0, 48] = -2.0  # leaf code for cluster 0
        for s in range(1, 8):
            node[0, 48 + s] = -1.0
            node[0, s * 3 : s * 3 + 3] = 1e30  # inverted finite box: no hit
            node[0, 24 + s * 3 : 24 + s * 3 + 3] = -1e30
        return ClusterBVH(
            node_table=node, cluster_table=packed, tri_id=tri_id,
            leaf_size=leaf_size, num_nodes=1, num_clusters=1,
            width=8,  # single-node trees always use the 8-slot layout
            depth=1,
        )

    wb = wb_mod.collapse(native.build_sah_bvh(cmin, cmax), leaf_size=1, width=width)
    m = wb.child_min.shape[0]
    # Collapse leaf codes encode -(start<<4|1)-2 with start indexing the
    # leaf order; translate to plain cluster ids: -(cluster)-2.
    codes = wb.child_code.astype(np.float64).copy()
    leaf_mask = wb.child_code < -1
    if leaf_mask.any():
        start = (-(wb.child_code[leaf_mask].astype(np.int64) + 2)) >> 4
        codes[leaf_mask] = -(wb.tri_order[start].astype(np.float64)) - 2.0

    row_len = 64 if width == 8 else ((7 * width + 127) // 128) * 128
    table = np.zeros((m, row_len), np.float32)
    # Empty slots keep an inverted big-finite box (no inf in the tables).
    big = np.float32(1e30)
    table[:, 0 : 3 * width] = np.clip(wb.child_min.reshape(m, 3 * width), -big, big)
    table[:, 3 * width : 6 * width] = np.clip(wb.child_max.reshape(m, 3 * width), -big, big)
    table[:, 6 * width : 7 * width] = codes.astype(np.float32)
    return ClusterBVH(
        node_table=table, cluster_table=packed, tri_id=tri_id,
        leaf_size=leaf_size, num_nodes=m, num_clusters=c, width=width,
        depth=_host_tree_depth(codes.reshape(m, width)),
    )


def build_cluster_bvh(v0, v1, v2, leaf_size: int = 8, width: int = 8, *, device) -> ClusterBVH:
    """``build_cluster_bvh_host`` + one upload of the tables to ``device``,
    with the walk's box table of an 8-wide tree (``boxes``)."""
    host = tuple(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for v in (v0, v1, v2))
    cb = build_cluster_bvh_host(*host, leaf_size, width)
    cb = cb._replace(**{k: torch.as_tensor(getattr(cb, k), device=device)
                        for k in ("node_table", "cluster_table", "tri_id")})
    return cb._replace(boxes=walk_boxes(cb.node_table)) if cb.width == WIDTH else cb


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def _round_table_conservative(table: torch.Tensor) -> torch.Tensor:
    """Expand child boxes outward so bf16 rounding can't cull true hits."""
    eps = 0.008  # > 2^-7 relative (bf16 mantissa)
    cmin = table[:, 0:24]
    cmax = table[:, 24:48]
    out = table.clone()
    out[:, 0:24] = cmin - (cmin.abs() * eps + 1e-6)
    out[:, 24:48] = cmax + (cmax.abs() * eps + 1e-6)
    return out


def walk_boxes(node_table: torch.Tensor) -> torch.Tensor:
    """The walk's child boxes [M, 48] (cmin 24 | cmax 24) of an 8-wide node
    table: rounded outwards, then to bfloat16 and back, as the reference's
    one-hot fetch returns them."""
    return _round_table_conservative(node_table)[:, :48].to(torch.bfloat16).to(torch.float32).contiguous()


def stack_entries(cb: ClusterBVH) -> int:
    """The walk's stack: max(``STACK_DEPTH``, (width − 1)·depth + 1) entries."""
    return max(STACK_DEPTH, (cb.width - 1) * cb.depth + 1)


_SORT8_PAIRS = [
    (0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
    (2, 4), (3, 5), (3, 4),
]


def _sort8_desc(codes: torch.Tensor, key: torch.Tensor, valid: torch.Tensor):
    """Sort 8 (code, key, valid) columns by key descending (far first, so
    the nearest child pops first) with the reference's compare-swap
    network; invalid entries take key −inf and sort to the end."""
    ks = [torch.where(valid[:, i], key[:, i], -torch.inf) for i in range(8)]
    cs = [codes[:, i] for i in range(8)]
    vs = [valid[:, i] for i in range(8)]
    for i, j in _SORT8_PAIRS:
        swap = ks[i] < ks[j]
        ks[i], ks[j] = torch.where(swap, ks[j], ks[i]), torch.where(swap, ks[i], ks[j])
        cs[i], cs[j] = torch.where(swap, cs[j], cs[i]), torch.where(swap, cs[i], cs[j])
        vs[i], vs[j] = torch.where(swap, vs[j], vs[i]), torch.where(swap, vs[i], vs[j])
    return torch.stack(cs, dim=1), torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def _check_walkable(cb: ClusterBVH) -> None:
    if cb.width != WIDTH:
        raise ValueError(f"cbvh_intersect walks {WIDTH}-wide trees, not width {cb.width}")
    if cb.boxes is None:
        raise ValueError("the walk reads ClusterBVH.boxes: build with build_cluster_bvh, or set "
                         "boxes=walk_boxes(node_table)")


def cbvh_intersect(cb: ClusterBVH, origins, directions, t_min: float = 1e-4, t_max=mathx.BACKGROUND_DEPTH,
                   any_hit: bool = False) -> intersect.Hit:
    """Closest hit of rays [N, 3] through the cluster BVH's tables (on the
    rays' device); ``any_hit=True`` retires a ray on its first accepted hit
    (an occlusion query: read ``Hit.hit``). ``t_max`` is a scalar or [N].
    CUDA tensors launch kernel D (counted in ``traverse_kernel.LAUNCHES`` as
    ``cluster_closest``/``cluster_any``) or raise; CPU tensors run
    ``cbvh_intersect_plain``."""
    _check_walkable(cb)
    dev = origins.device
    if dev.type == "cpu":
        return cbvh_intersect_plain(cb, origins, directions, t_min, t_max, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"cbvh_intersect runs on cpu or cuda tensors, not {dev}")
    from raytracer3_tpu_torch.ops import oracle_kernels as ok
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    n = origins.shape[0]
    if n == 0:
        return intersect.Hit.miss((0,), device=dev)
    lib = ok.load_kernels()
    with torch.cuda.device(dev):
        out = ok.cluster_walk(lib, cb, cb.boxes, stack_entries(cb), origins, directions, traverse.t_caps(t_max, n, dev),
                              t_min, any_hit, torch.cuda.current_stream(dev).cuda_stream)
    tk.LAUNCHES["cluster_any" if any_hit else "cluster_closest"] += 1
    return traverse.finish(*out)


def cbvh_intersect_plain(cb: ClusterBVH, origins, directions, t_min: float = 1e-4, t_max=mathx.BACKGROUND_DEPTH,
                         any_hit: bool = False, counts=None, visited=None) -> intersect.Hit:
    """The plain version of ``cbvh_intersect`` on any device: the lockstep
    walk, one host read a turn. For the kernel's bound: ``counts``, an int64
    [N, 2] tensor on the rays' device, gets each ray's node and leaf
    (cluster) pops added; ``visited``, a bool [num_nodes + num_clusters]
    tensor, is set True at every node m (at m) and cluster c (at
    num_nodes + c) any ray pops."""
    _check_walkable(cb)
    n = origins.shape[0]
    dev = origins.device
    ls = cb.leaf_size
    d_all = torch.where(directions.abs() < 1e-12, 1e-12, directions)
    boxes = cb.boxes
    node_codes = cb.node_table[:, 48:56]
    tri_id = cb.tri_id.long()
    depth = stack_entries(cb)

    out = {
        "best_t": traverse.t_caps(t_max, n, dev).clone(),
        "best_u": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_v": torch.zeros(n, dtype=torch.float32, device=dev),
        "best_id": torch.full((n,), -1, dtype=torch.int64, device=dev),
    }
    st = {k: v.clone() for k, v in out.items()}
    st.update(
        lane=torch.arange(n, device=dev), o=origins, d=d_all, inv_d=1.0 / d_all,
        # Root (code 0.0) pushed; column ``depth`` takes the dropped pushes.
        stack=torch.zeros((n, depth + 1), dtype=torch.float32, device=dev),
        sp=torch.ones(n, dtype=torch.int64, device=dev),
    )
    while True:
        running = st["sp"] > 0
        n_live = int(running.sum())
        if n_live == 0:
            break
        if 2 * n_live < running.shape[0]:
            st = traverse._compact(running, out, st)
            running = st["sp"] > 0
        m = running.shape[0]
        o, d, sp, stack = st["o"], st["d"], st["sp"], st["stack"]
        entry = torch.where(running, stack.gather(1, (sp - 1).clamp_min(0)[:, None])[:, 0], 0.0)
        sp = torch.where(running, (sp - 1).clamp_min(0), sp)
        is_leaf = entry < -1.0
        is_node = running & (entry >= 0.0)
        if counts is not None:
            counts.index_add_(0, st["lane"], torch.stack([is_node, running & is_leaf], 1).long())

        # Leaf: up to L triangle tests from the cluster's packed rows.
        cluster = (-entry - 2.0).to(torch.int64).clamp(0, cb.num_clusters - 1)
        rows = cb.cluster_table[cluster]
        tids = tri_id[cluster]
        best_t, best_u, best_v, best_id = st["best_t"], st["best_u"], st["best_v"], st["best_id"]
        take_leaf = running & is_leaf
        for j in range(ls):
            tv0 = rows[:, 9 * j: 9 * j + 3]
            te1 = rows[:, 9 * j + 3: 9 * j + 6]
            te2 = rows[:, 9 * j + 6: 9 * j + 9]
            pvec = mathx.cross(d, te2)
            det = mathx.dot(te1, pvec, keepdims=False)
            ok = det.abs() > 1e-9
            inv_det = torch.where(ok, 1.0 / det, 0.0)
            tvec = o - tv0
            uu = mathx.dot(tvec, pvec, keepdims=False) * inv_det
            qvec = mathx.cross(tvec, te1)
            vv = mathx.dot(d, qvec, keepdims=False) * inv_det
            tt = mathx.dot(te2, qvec, keepdims=False) * inv_det
            take = (take_leaf & ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > t_min) & (tt < best_t)
                    & (tids[:, j] >= 0))
            best_t = torch.where(take, tt, best_t)
            best_u = torch.where(take, uu, best_u)
            best_v = torch.where(take, vv, best_v)
            best_id = torch.where(take, tids[:, j], best_id)

        # Internal: 8 children, pushed far → near.
        node = entry.to(torch.int64).clamp(0, cb.num_nodes - 1)
        if visited is not None:
            visited[torch.where(is_leaf, cb.num_nodes + cluster, node)[running]] = True
        nb = boxes[node]
        codes = node_codes[node]
        tn, hit8 = intersect.ray_aabb(o[:, None, :], st["inv_d"][:, None, :], nb[:, 0:24].reshape(m, 8, 3),
                                      nb[:, 24:48].reshape(m, 8, 3), t_min, best_t[:, None])
        # Empty slots carry code -1.0 exactly.
        valid8 = hit8 & ((codes + 1.0).abs() > 0.25) & is_node[:, None]
        code_s, _, valid_s = _sort8_desc(codes, torch.where(valid8, tn, torch.inf), valid8)
        for c in range(WIDTH):
            push = valid_s[:, c]
            stack.scatter_(1, torch.where(push & (sp < depth), sp, depth)[:, None], code_s[:, c, None])
            sp = torch.clamp_max(sp + push, depth)
        if any_hit:
            sp = torch.where(best_id >= 0, 0, sp)
        st.update(sp=sp, best_t=best_t, best_u=best_u, best_v=best_v, best_id=best_id)
    traverse._compact(slice(0, 0), out, st)
    return traverse.finish(out["best_t"], out["best_u"], out["best_v"], out["best_id"])


def _host_tris(scene, host_tris):
    return host_tris if host_tris is not None else scene.tri_vertices()


def cluster_backend(scene=None, leaf_size: int = 8, host_tris=None, *, device):
    """TraceBackend over the cluster-BVH walk on ``device``: the tables are
    its ``arrays`` (``nodes``, ``clusters``, ``tids``, and the walk's box
    table ``boxes``), so the walk reads nothing else."""
    from raytracer3_tpu_torch.ops.backend import TraceBackend

    cb = build_cluster_bvh(*_host_tris(scene, host_tris), leaf_size, device=device)
    arrays = {"nodes": cb.node_table, "clusters": cb.cluster_table, "tids": cb.tri_id, "boxes": cb.boxes}

    def _rebind(arrays):
        return cb._replace(node_table=arrays["nodes"], cluster_table=arrays["clusters"], tri_id=arrays["tids"],
                           boxes=arrays["boxes"])

    def isect_fn(arrays, o, d):
        return cbvh_intersect(_rebind(arrays), o, d)

    def occl_fn(arrays, o, d, tmax):
        return cbvh_intersect(_rebind(arrays), o, d, t_max=tmax, any_hit=True).hit

    return TraceBackend(arrays, isect_fn, occl_fn, meta=cb)


def make_cluster_backend(scene=None, leaf_size: int = 8, host_tris=None, *, device):
    """Scene (or numpy ``host_tris``) → (intersect_fn, occluded_fn,
    ClusterBVH on ``device``)."""
    cb = build_cluster_bvh(*_host_tris(scene, host_tris), leaf_size, device=device)

    def isect(o, d):
        return cbvh_intersect(cb, o, d)

    def occl(o, d, tmax):
        return cbvh_intersect(cb, o, d, t_max=tmax, any_hit=True).hit

    return isect, occl, cb
