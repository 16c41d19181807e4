"""Two-level acceleration structure: per-mesh BLAS + instance TLAS (port of
``raytracer3_tpu/ops/tlas.py``; the builds are host numpy).

- Every mesh gets a cluster BVH once, in object space.
- All BLAS node tables go behind the TLAS rows in one table (node ids and
  cluster leaf codes offset into global id spaces).
- The TLAS is a small wide BVH over the instances' world AABBs whose leaf
  codes name instances (code = -(C_total + instance) - 2).
- The instance table carries the world→object 3×4 (rays are mapped into
  object space at a TLAS leaf; t is affine-invariant, so world-space best t
  needs no rescaling) and the BLAS root; ``normal_mats`` carries the
  object→world normal matrices for shading.

A transform edit rebuilds only the TLAS rows and the instance table
(O(instances)); with a ``blas_cache`` no BLAS is rebuilt and the device
cluster table is reused. Traversal is K4 (``traverse_kernel.packet_intersect``
on these tables).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch.ops import cluster_bvh as cb_mod
from raytracer3_tpu_torch.ops import traverse_kernel as tk
from raytracer3_tpu_torch.ops.backend import TraceBackend

INST_ROW = 32  # instance-table lanes: invM(12) | blas_root(1) | pad


class TwoLevelTables(NamedTuple):
    """Packed two-level tables (host numpy until upload)."""

    node_table: np.ndarray  # [Mt + Mb, row_len] f32 — TLAS rows first
    cluster_table: np.ndarray  # [C_total, 128] f32 (kernel layout, tri ids mesh-global)
    inst_table: np.ndarray  # [I, INST_ROW] f32
    normal_mats: np.ndarray  # [I, 9] f32 object→world normal matrices
    leaf_size: int
    width: int
    depth: int  # tlas depth + max blas depth (the reference's stack sizing)
    stack_need: int  # worst-case traversal stack, marker included (traverse_kernel.stack_need_of)
    num_clusters: int  # C_total: codes ≥ this are instance leaves
    num_nodes: int
    tlas_nodes: int
    mesh_of_instance: np.ndarray  # [I] int32


class _MeshBLAS(NamedTuple):
    nodes: np.ndarray  # local node table [m, row_len]
    clusters: np.ndarray  # packed kernel cluster rows [c, 128]
    root_min: np.ndarray  # [3]
    root_max: np.ndarray  # [3]
    depth: int
    tri_count: int


def build_mesh_blas(v0, v1, v2, leaf_size: int = 12, width: int = 16) -> _MeshBLAS:
    """Object-space BLAS for one mesh (built once per mesh)."""
    cb = cb_mod.build_cluster_bvh_host(v0, v1, v2, leaf_size, width=width)
    pt = tk.pack_tables_host(cb)
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    return _MeshBLAS(
        nodes=np.asarray(pt.node_table),
        clusters=np.asarray(pt.cluster_table),
        root_min=lo.astype(np.float32),
        root_max=hi.astype(np.float32),
        depth=pt.depth,
        tri_count=int(v0.shape[0]),
    )


def _remap_codes(codes: np.ndarray, node_base: int, cluster_base: int):
    """Shift a BLAS row's child codes into the global id spaces."""
    out = codes.copy()
    internal = codes >= 0
    leaf = codes < -1
    out[internal] = codes[internal] + node_base
    out[leaf] = -((-codes[leaf] - 2) + cluster_base) - 2
    return out


def _instance_world_aabb(blas: _MeshBLAS, transform: np.ndarray):
    """World AABB of an instance: transform the 8 BLAS root corners."""
    lo, hi = blas.root_min, blas.root_max
    cs = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
        np.float32,
    )
    r = transform[:3, :3]
    t = transform[:3, 3]
    wc = cs @ r.T + t
    return wc.min(0), wc.max(0)


def _build_tlas_rows(inst_min: np.ndarray, inst_max: np.ndarray, width: int, row_len: int,
                     num_clusters: int):
    """Wide TLAS over instance AABBs [I, 3]; leaf code = -(C_total + inst) - 2,
    internal codes index TLAS rows. Returns (rows [Mt, row_len], depth)."""
    i_count = inst_min.shape[0]
    big = np.float32(1e30)

    def make_row(children):
        """children: list of (cmin, cmax, code)."""
        row = np.zeros(row_len, np.float32)
        for s in range(width):
            if s < len(children):
                cmin, cmax, code = children[s]
            else:
                cmin, cmax, code = (np.full(3, big), np.full(3, -big), -1.0)
            row[s * 3 : s * 3 + 3] = np.clip(cmin, -big, big)
            row[3 * width + s * 3 : 3 * width + s * 3 + 3] = np.clip(cmax, -big, big)
            row[6 * width + s] = code
        return row

    if i_count <= width:
        children = [(inst_min[i], inst_max[i], -(num_clusters + i) - 2.0) for i in range(i_count)]
        return np.stack([make_row(children)]), 1

    # Median-split wide build over instance centroids (host, I is small).
    cent = (inst_min + inst_max) * 0.5

    def build(ids):
        # Split ids into `width` groups along the longest axis, always
        # splitting the largest group.
        groups = [ids]
        while len(groups) < width:
            gi = max(range(len(groups)), key=lambda k: len(groups[k]))
            g = groups[gi]
            if len(g) <= 1:
                break
            lo = cent[g].min(0)
            hi = cent[g].max(0)
            ax = int(np.argmax(hi - lo))
            order = g[np.argsort(cent[g, ax], kind="stable")]
            half = len(order) // 2
            groups[gi : gi + 1] = [order[:half], order[half:]]
        children = []
        pending = []
        for g in groups:
            if len(g) == 0:
                continue
            gmin = inst_min[g].min(0)
            gmax = inst_max[g].max(0)
            if len(g) == 1:
                children.append((gmin, gmax, -(num_clusters + int(g[0])) - 2.0))
            else:
                pending.append(g)
                children.append((gmin, gmax, 0.0))  # patched below
        return children, pending

    # Breadth-first build, then internal child ids in BFS order.
    rows_children = []
    queue = [np.arange(i_count)]
    while queue:
        children, pending = build(queue.pop(0))
        rows_children.append(children)
        queue.extend(pending)
    next_id = 1
    final_rows = []
    for children in rows_children:
        fixed = []
        for cmin, cmax, code in children:
            if code == 0.0 and not (cmin[0] > cmax[0]):
                fixed.append((cmin, cmax, float(next_id)))
                next_id += 1
            else:
                fixed.append((cmin, cmax, code))
        final_rows.append(make_row(fixed))
    rows = np.stack(final_rows)
    depth = cb_mod._host_tree_depth(rows[:, 6 * width : 7 * width].reshape(len(rows), width))
    return rows, depth


def build_two_level(meshes: list, instances: list, leaf_size: int = 12, width: int = 16,
                    blas_cache: dict | None = None) -> TwoLevelTables:
    """Full two-level build. ``meshes``: dicts with object-space
    ``positions``/``indices``; ``instances``: (mesh index, transform [4, 4]).
    ``blas_cache`` (mesh index → BLAS) lets transform-only edits skip every
    BLAS build."""
    blas_cache = blas_cache if blas_cache is not None else {}
    blases = []
    for mi, m in enumerate(meshes):
        if mi not in blas_cache:
            pos, idx = m["positions"], m["indices"]
            blas_cache[mi] = build_mesh_blas(pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]], leaf_size, width)
        blases.append(blas_cache[mi])

    row_len = blases[0].nodes.shape[1]

    # Concatenate cluster tables; kernel-row triangle ids become mesh-global
    # (the shading tables are mesh-concatenated).
    cluster_tables = []
    cluster_base = []
    cbase = 0
    tbase = 0
    ls = leaf_size
    for b in blases:
        ct = b.clusters.copy()
        tids = ct[:, 9 * ls : 10 * ls]
        ct[:, 9 * ls : 10 * ls] = np.where(tids >= 0, tids + tbase, tids)
        cluster_tables.append(ct)
        cluster_base.append(cbase)
        cbase += ct.shape[0]
        tbase += b.tri_count
    cluster_table = np.concatenate(cluster_tables)
    num_clusters = cbase

    # Instance table and world AABBs.
    i_count = len(instances)
    inst_table = np.zeros((i_count, INST_ROW), np.float32)
    normal_mats = np.zeros((i_count, 9), np.float32)
    inst_min = np.zeros((i_count, 3), np.float32)
    inst_max = np.zeros((i_count, 3), np.float32)
    mesh_of_instance = np.zeros(i_count, np.int32)
    for k, (mi, transform) in enumerate(instances):
        b = blases[mi]
        mesh_of_instance[k] = mi
        inst_min[k], inst_max[k] = _instance_world_aabb(b, transform)
        inv = np.linalg.inv(transform)
        inst_table[k, 0:12] = inv[:3, :].reshape(-1)  # rows: [R | t]
        r = transform[:3, :3]
        nmat = np.linalg.inv(r).T if abs(np.linalg.det(r)) > 1e-12 else r
        normal_mats[k] = nmat.reshape(-1)

    tlas_rows, tlas_depth = _build_tlas_rows(inst_min, inst_max, width, row_len, num_clusters)
    mt = tlas_rows.shape[0]

    # BLAS node tables go after the TLAS rows, codes remapped.
    node_parts = [tlas_rows]
    node_base_of_mesh = {}
    nbase = mt
    for mi, b in enumerate(blases):
        node_base_of_mesh[mi] = nbase
        nt = b.nodes.copy()
        nt[:, 6 * width : 7 * width] = _remap_codes(nt[:, 6 * width : 7 * width], nbase, cluster_base[mi])
        node_parts.append(nt)
        nbase += nt.shape[0]
    node_table = np.concatenate(node_parts)

    for k, (mi, _t) in enumerate(instances):
        inst_table[k, 12] = float(node_base_of_mesh[mi])  # BLAS root id

    return TwoLevelTables(
        node_table=node_table.astype(np.float32),
        cluster_table=cluster_table.astype(np.float32),
        inst_table=inst_table,
        normal_mats=normal_mats,
        leaf_size=leaf_size,
        width=width,
        depth=int(tlas_depth + max(b.depth for b in blases)),
        stack_need=tk.stack_need_of(node_table, width, inst_table),
        num_clusters=num_clusters,
        num_nodes=node_table.shape[0],
        tlas_nodes=mt,
        mesh_of_instance=mesh_of_instance,
    )


def two_level_backend(meshes: list, instances: list, leaf_size: int = 12, width: int = 16,
                      blas_cache: dict | None = None, *, device) -> TraceBackend:
    """TraceBackend over K4 on ``device``. Rebinding after a transform edit
    with the same ``blas_cache`` rebuilds no BLAS and reuses the device
    cluster table (the same tensor), uploading only the node and instance
    tables. ``meta`` is (PacketTables on the device, TwoLevelTables)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("two_level_backend: a CUDA device was asked for but none is available")
        tk.load_kernels()
    tl = build_two_level(meshes, instances, leaf_size=leaf_size, width=width, blas_cache=blas_cache)
    host = tk.pack_two_level(tl)
    cached = None if blas_cache is None else blas_cache.get("__device_clusters__")
    if (cached is not None and tuple(cached.shape) == host.cluster_table.shape
            and cached.device == device):
        clusters = cached
    else:
        clusters = tk._upload(host.cluster_table, device)
        if blas_cache is not None:
            blas_cache["__device_clusters__"] = clusters
    pt = host._replace(node_table=tk._upload(host.node_table, device), cluster_table=clusters,
                       inst_table=tk._upload(host.inst_table, device))
    meta = pt._replace(node_table=None, cluster_table=None, inst_table=None)
    arrays = {"nodes": pt.node_table, "clusters": pt.cluster_table, "insts": pt.inst_table}

    def _tables(arrays) -> tk.PacketTables:
        return meta._replace(node_table=arrays["nodes"], cluster_table=arrays["clusters"],
                             inst_table=arrays["insts"])

    def isect_fn(arrays, o, d):
        return tk.packet_intersect(_tables(arrays), o.contiguous(), d.contiguous())

    def occl_fn(arrays, o, d, tmax):
        if isinstance(tmax, torch.Tensor):
            tmax = tmax.contiguous()
        return tk.packet_intersect(_tables(arrays), o.contiguous(), d.contiguous(), t_max=tmax,
                                   any_hit=True).hit

    return TraceBackend(arrays, isect_fn, occl_fn, meta=(pt, tl))
