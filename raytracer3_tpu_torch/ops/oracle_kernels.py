"""The oracle backends' kernels (``csrc/oracle_bvh.cu``): build, binding and
one launch of each, on tensors of any device the library was built for.

- A ``lbvh_topology_kernel`` and B ``lbvh_fit_kernel``: the LBVH build's
  Karras topology and bottom-up fit (``ops/bvh.build_lbvh_aabbs``);
- C ``lbvh_walk_kernel<AnyHit>``: the LBVH walk (``ops/traverse.bvh_intersect``);
- D ``cluster_walk_kernel<AnyHit, Cap>``: the cluster-BVH walk
  (``ops/cluster_bvh.cbvh_intersect``);
- E ``wide_walk_kernel<AnyHit>``: the wide-BVH walk
  (``ops/wide_bvh.wbvh_intersect``);
- F1 ``rounds_pick_kernel`` and F2 ``rounds_merge_kernel``: a round of
  K3's rounds driver before its sort and after its K3 launch
  (``ops/treelets.rounds_on_device``).

The wrappers in those modules launch these on CUDA tensors (or raise) and
count each launch in ``traverse_kernel.LAUNCHES`` (``ORACLE_KEYS``); a CPU
tensor takes their plain versions. The launchers here count nothing: the
tests call them with ``load_host_kernels()``, the source built with g++
under ``csrc/host_shim.h``, on CPU tensors, and hold each kernel to its
plain version to the bit. ``load_kernels()`` builds the source with nvcc
for sm_90a (``traverse_kernel.NVCC_FLAGS``, ``--fmad=false``) into
``build/kernels/`` at first use.
"""

from __future__ import annotations

import ctypes
import os

import torch

from raytracer3_tpu_torch.ops import traverse_kernel as tk

_SRC = os.path.join(os.path.dirname(tk._SRC), "oracle_bvh.cu")
CLUSTER_STACK_CAPACITY = 512  # kClusterDeepStackCap: the cluster walk's largest stack


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rt3_lbvh_topology.argtypes = [vp, ci, vp, vp, vp, vp]  # codes, T, left, right, parent, stream
    lib.rt3_lbvh_fit.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp]  # T, left, right, parent, arrivals, min, max, stream
    lib.rt3_lbvh_walk.argtypes = [
        ci, vp, vp, vp, vp, vp, ci,  # any_hit, node_min, node_max, left, right, leaf_tri, T
        vp, vp, vp,  # v0, v1, v2
        vp, vp, vp, cll, cf,  # origins, directions, t_cap, n, t_min
        vp, vp, vp, vp, vp,  # out t, u, v, id, stream
    ]
    lib.rt3_cluster_walk.argtypes = [
        ci, vp, vp, ci, ci,  # any_hit, boxes, nodes, node row, nodes
        vp, ci, vp, ci, ci, ci,  # clusters, cluster row, tri_id, clusters, leaf size, stack entries
        vp, vp, vp, cll, cf,  # origins, directions, t_cap, n, t_min
        vp, vp, vp, vp, vp,  # out t, u, v, id, stream
    ]
    lib.rt3_wide_walk.argtypes = [
        ci, vp, vp, vp, ci, ci,  # any_hit, child_min, child_max, child_code, nodes, width
        vp, vp, vp, vp, ci, ci,  # tri_order, v0, v1, v2, T, leaf size
        vp, vp, vp, cll, cf,  # origins, directions, t_cap, n, t_min
        vp, vp, vp, vp, vp,  # out t, u, v, id, stream
    ]
    lib.rt3_rounds_pick.argtypes = [
        vp, vp, ci,  # pending, next pending, words
        vp, vp, vp, vp, vp, ci,  # origins, directions, inverse directions, best t, best id, any_hit
        vp, ci, vp, vp, cll, cf,  # aabb, K, scene lo, hi, n, t_min
        vp, vp, vp, vp, vp,  # out has, tid, key, cap, stream
    ]
    lib.rt3_rounds_merge.argtypes = [
        vp, vp, vp, vp, cll,  # order, has, K3 rows, K3 counts or null, n
        vp, vp, vp, vp, vp, vp,  # best t, u, v, id, counts or null, stream
    ]
    for fn in (lib.rt3_lbvh_topology, lib.rt3_lbvh_fit, lib.rt3_lbvh_walk, lib.rt3_cluster_walk,
               lib.rt3_wide_walk, lib.rt3_rounds_pick, lib.rt3_rounds_merge):
        fn.restype = ci
    return lib


def load_kernels():
    """``csrc/oracle_bvh.cu`` built with nvcc for sm_90a at first use and
    bound once."""
    return tk.load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/oracle_bvh.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (every thread of a launch run in turn), for the
    tests; no wrapper takes it."""
    return tk.load_library(_SRC, _bind, "cpu")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def lbvh_topology(lib, codes_sorted: torch.Tensor, stream):
    """Kernel A over the stably sorted int64 Morton codes [T]: (left, right)
    [T-1] and parent [2T-1] int32 (-1 at the root)."""
    t = codes_sorted.shape[0]
    dev = codes_sorted.device
    left = torch.empty((t - 1,), dtype=torch.int32, device=dev)
    right = torch.empty((t - 1,), dtype=torch.int32, device=dev)
    parent = torch.empty((2 * t - 1,), dtype=torch.int32, device=dev)
    codes = codes_sorted.to(torch.int64).contiguous()
    _check(lib.rt3_lbvh_topology(codes.data_ptr(), t, left.data_ptr(), right.data_ptr(), parent.data_ptr(),
                                 stream), "lbvh_topology_kernel")
    return left, right, parent


def lbvh_fit(lib, left, right, parent, node_min: torch.Tensor, node_max: torch.Tensor, stream) -> None:
    """Kernel B: writes the internal rows [0, T-1) of node_min / node_max
    ([2T-1, 3] float32, contiguous) from their leaf rows, in place; the
    arrival counters are zeroed here."""
    t = left.shape[0] + 1
    if node_min.dtype != torch.float32 or not (node_min.is_contiguous() and node_max.is_contiguous()):
        raise ValueError("node_min / node_max must be contiguous float32 [2T-1, 3]")
    arrivals = torch.zeros((t - 1,), dtype=torch.int32, device=left.device)
    _check(lib.rt3_lbvh_fit(t, left.data_ptr(), right.data_ptr(), parent.data_ptr(), arrivals.data_ptr(),
                            node_min.data_ptr(), node_max.data_ptr(), stream), "lbvh_fit_kernel")


def _outs(n: int, dev):
    return (torch.empty((n,), dtype=torch.float32, device=dev), torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev), torch.empty((n,), dtype=torch.int32, device=dev))


def lbvh_walk(lib, bvh, v0, v1, v2, origins, directions, t_cap, t_min: float, any_hit: bool, stream):
    """Kernel C on rays [N, 3] (N >= 1) with caps [N]: (best t, u, v, id),
    id -1 (and t the cap) on a miss."""
    n = origins.shape[0]
    tabs = [_f32(bvh.node_min), _f32(bvh.node_max), _i32(bvh.node_left), _i32(bvh.node_right), _i32(bvh.leaf_tri)]
    tris = [_f32(v) for v in (v0, v1, v2)]
    rays = [_f32(origins), _f32(directions), _f32(t_cap)]
    out = _outs(n, origins.device)
    _check(lib.rt3_lbvh_walk(int(any_hit), *(x.data_ptr() for x in tabs), bvh.leaf_tri.shape[0],
                             *(x.data_ptr() for x in tris), *(x.data_ptr() for x in rays), n, float(t_min),
                             *(x.data_ptr() for x in out), stream), "lbvh_walk_kernel")
    return out


def cluster_walk(lib, cb, boxes, entries: int, origins, directions, t_cap, t_min: float, any_hit: bool, stream):
    """Kernel D on rays [N, 3] (N >= 1) with caps [N] through the cluster
    BVH ``cb`` and its walk boxes [M, 48] (``cluster_bvh.walk_boxes``), a
    stack of ``entries``: (best t, u, v, id)."""
    if entries > CLUSTER_STACK_CAPACITY:
        raise ValueError(f"the cluster walk needs {entries} stack entries; the kernel holds at most "
                         f"{CLUSTER_STACK_CAPACITY}")
    n = origins.shape[0]
    nodes, clusters, tids = _f32(cb.node_table), _f32(cb.cluster_table), _i32(cb.tri_id)
    if nodes.ndim != 2 or nodes.shape[1] < 56 or clusters.shape[1] < 9 * cb.leaf_size:
        raise ValueError("cluster tables are narrower than an 8-wide node row / the leaf size imply")
    if tids.shape != (cb.num_clusters, cb.leaf_size):
        raise ValueError(f"tri_id must be [{cb.num_clusters}, {cb.leaf_size}], got {tuple(tids.shape)}")
    if nodes.shape[0] != cb.num_nodes or clusters.shape[0] != cb.num_clusters:
        raise ValueError(f"the tables hold {nodes.shape[0]} nodes and {clusters.shape[0]} clusters; the tree "
                         f"has {cb.num_nodes} and {cb.num_clusters}")
    boxes = _f32(boxes)
    if boxes.shape != (cb.num_nodes, 48):
        raise ValueError(f"the walk boxes must be [{cb.num_nodes}, 48], got {tuple(boxes.shape)}")
    rays = [_f32(origins), _f32(directions), _f32(t_cap)]
    out = _outs(n, origins.device)
    _check(lib.rt3_cluster_walk(int(any_hit), boxes.data_ptr(), nodes.data_ptr(), nodes.shape[1],
                                cb.num_nodes, clusters.data_ptr(), clusters.shape[1], tids.data_ptr(),
                                cb.num_clusters, cb.leaf_size, entries, *(x.data_ptr() for x in rays), n,
                                float(t_min), *(x.data_ptr() for x in out), stream), "cluster_walk_kernel")
    return out


def wide_walk(lib, wb, leaf_size: int, origins, directions, t_cap, t_min: float, any_hit: bool, stream):
    """Kernel E on rays [N, 3] (N >= 1) with caps [N] through the wide BVH
    ``wb`` (its triangles in leaf order), leaves of at most ``leaf_size``
    triangles tested: (best t, u, v, id)."""
    n = origins.shape[0]
    cmin, cmax, codes = _f32(wb.child_min), _f32(wb.child_max), _i32(wb.child_code)
    if codes.ndim != 2 or cmin.shape != (*codes.shape, 3) or cmax.shape != cmin.shape:
        raise ValueError("child_min / child_max must be [W, width, 3] and child_code [W, width]")
    if wb.tri_v0 is None:
        raise ValueError("the wide BVH carries no triangles (collapse without tris=)")
    order = _i32(wb.tri_order)
    tris = [_f32(v) for v in (wb.tri_v0, wb.tri_v1, wb.tri_v2)]
    if any(v.shape != (order.shape[0], 3) for v in tris):
        raise ValueError("the leaf-order triangles must be [T, 3], T = len(tri_order)")
    rays = [_f32(origins), _f32(directions), _f32(t_cap)]
    out = _outs(n, origins.device)
    _check(lib.rt3_wide_walk(int(any_hit), cmin.data_ptr(), cmax.data_ptr(), codes.data_ptr(), codes.shape[0],
                             codes.shape[1], order.data_ptr(), *(x.data_ptr() for x in tris), order.shape[0],
                             int(leaf_size), *(x.data_ptr() for x in rays), n, float(t_min),
                             *(x.data_ptr() for x in out), stream), "wide_walk_kernel")
    return out


def rounds_pick(lib, pending, origins, directions, inv_dir, best_t, best_id, any_hit: bool, aabb, lo, hi,
                t_min: float, stream):
    """Kernel F1 on padded rays [N, 3] and their pending words [N, ⌈K/32⌉]
    (int32): (has bool [N], tid int32 [N], key int32 [N], the round's cap
    float32 [N], the next round's pending words)."""
    n, k = origins.shape[0], aabb.shape[0]
    dev = origins.device
    if pending.dtype != torch.int32 or pending.shape != (n, (k + 31) // 32):
        raise ValueError(f"pending must be int32 [{n}, {(k + 31) // 32}]")
    pending = pending.contiguous()
    pending_out = torch.empty_like(pending)
    if best_id.dtype != torch.int32 or not best_id.is_contiguous():
        raise ValueError("best_id must be contiguous int32")
    has = torch.empty((n,), dtype=torch.bool, device=dev)
    tid = torch.empty((n,), dtype=torch.int32, device=dev)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    cap = torch.empty((n,), dtype=torch.float32, device=dev)
    ins = [_f32(origins), _f32(directions), _f32(inv_dir), _f32(best_t)]
    box = [_f32(aabb), _f32(lo), _f32(hi)]
    _check(lib.rt3_rounds_pick(pending.data_ptr(), pending_out.data_ptr(), pending.shape[1],
                               *(x.data_ptr() for x in ins), best_id.data_ptr(), int(any_hit), box[0].data_ptr(), k,
                               box[1].data_ptr(), box[2].data_ptr(), n, float(t_min), has.data_ptr(), tid.data_ptr(),
                               key.data_ptr(), cap.data_ptr(), stream), "rounds_pick_kernel")
    return has, tid, key, cap, pending_out


def rounds_merge(lib, order, has, out_s, counts_s, best_t, best_u, best_v, best_id, counts, stream) -> None:
    """Kernel F2: for sorted slot j, ray ``order[j]`` takes K3's t, u, v and
    id from ``out_s`` [4, N] where ``has`` and the id is >= 0; with
    ``counts`` [N, 5] int32, adds ``counts_s`` [N, 5]. The bests (float32,
    int32 ids) and counts are updated in place."""
    n = order.shape[0]
    bests = (best_t, best_u, best_v, best_id)
    if any(not x.is_contiguous() or x.shape != (n,) for x in bests) or best_id.dtype != torch.int32 \
            or any(x.dtype != torch.float32 for x in bests[:3]):
        raise ValueError(f"the bests must be contiguous float32 [{n}] and int32 [{n}] ids")
    if counts is not None and (counts.dtype != torch.int32 or not counts.is_contiguous()
                               or counts.shape != (n, 5)):
        raise ValueError(f"counts must be contiguous int32 [{n}, 5]")
    order = order.to(torch.int64).contiguous()
    out_s = _f32(out_s)
    cs = None if counts is None else _i32(counts_s)
    _check(lib.rt3_rounds_merge(order.data_ptr(), has.contiguous().data_ptr(), out_s.data_ptr(),
                                None if cs is None else cs.data_ptr(), n, *(x.data_ptr() for x in bests),
                                None if counts is None else counts.data_ptr(), stream), "rounds_merge_kernel")
