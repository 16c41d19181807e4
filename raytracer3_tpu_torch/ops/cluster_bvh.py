"""Host-side cluster-BVH build (port of the build half of
``raytracer3_tpu/ops/cluster_bvh.py``): triangles → clusters of ≤ leaf_size
(native SAH clustering) → binned-SAH binary BVH over the cluster boxes
(native) → wide collapse → packed node and cluster tables, all numpy;
``build_cluster_bvh`` uploads them to a device.

The tables must equal the reference's bit for bit, so the build runs the same
native source (``native/rt3native.cpp``, built and bound by the port's own
``raytracer3_tpu_torch.native``) and raises when it is unavailable: the
reference's Morton and device-LBVH fallbacks give other trees and are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch import native
from raytracer3_tpu_torch.ops import wide_bvh as wb_mod


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
    """``build_cluster_bvh_host`` + one upload of the tables to ``device``."""
    host = tuple(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for v in (v0, v1, v2))
    cb = build_cluster_bvh_host(*host, leaf_size, width)
    return cb._replace(**{k: torch.as_tensor(getattr(cb, k), device=device)
                          for k in ("node_table", "cluster_table", "tri_id")})
