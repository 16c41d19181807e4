"""Wide cluster-BVH traversal: the K1 (closest-hit), K2 (any-hit), K3
(treelet segment grid) and K4 (two-level TLAS→BLAS) kernels and their
counting form K5 (port of ``raytracer3_tpu/ops/pallas/traverse_kernel.py``).

- ``PacketTables``/``pack_tables_host``/``pack_two_level`` keep the
  reference's row layout.
- ``packet_intersect`` is the K1/K2 wrapper, and the K4 wrapper on
  two-level tables (``inst_table`` set); ``packet_intersect_segments`` is
  the K3 wrapper. On CUDA tensors each launches its hand-written kernel of
  ``csrc/traverse.cu`` (built with nvcc for sm_90a at first use and bound
  with ctypes) or raises; on CPU tensors each runs its plain version
  (``packet_intersect_plain``, ``packet_intersect_segments_plain``), the same
  tests as a dense brute force over the packed cluster rows.
- Every kernel, both hit kinds, has two loops in the source: the walks
  written for this card (K1/K2 ``traverse_walk_kernel``/
  ``traverse_walk_any_kernel``, K3 ``segment_walk_kernel``/
  ``segment_walk_any_kernel``, K4 ``tlas_walk_kernel``/
  ``tlas_walk_any_kernel``: rows read as 16-byte words, width and leaf size
  fixed when they are compiled) for the shapes the backends build, and the
  general loop for every other shape. The any-hit walk has no rank: an
  any-hit answer needs no child order, so it pushes the taken children in
  slot order, as the general loop does. ``trace_loop`` is the dispatch;
  ``LAUNCHES`` counts the loops apart.
- The traversal stack is sized from the built tables: ``tree_stack_need``
  walks the node codes once, when the tables are packed, and the tables
  carry the worst case as ``stack_need``. The kernels hold 128 entries; the
  general loop has a second instantiation with 512 for deeper trees
  (``"deep"``), and past 512 the wrappers raise.
- ``stats=True`` on either wrapper is K5: the same kernel with per-ray
  visit counters (``STAT_COLUMNS``). Its plain version is a traversal, not a
  brute force: ``traverse_plain`` and ``segments_traverse_plain`` walk each
  ray through the tree in the kernel's order with the kernel's tests,
  vectorised over rays, and give the kernel's hits and counts to the bit.
- ``packet_backend`` routes as the reference does: a scene whose estimated
  cluster table exceeds ``TREELET_ROUTE_BYTES`` (the reference's 6 MiB
  ``CLUSTERS_VMEM_LIMIT``) goes to ``treelets.treelet_backend``; a smaller
  one gets single-level tables and K1/K2 in a ``TraceBackend``.
  ``make_packet_backend`` returns the single-level tables, unrouted, as
  the reference's ``(intersect_fn, occluded_fn, tables)`` triple.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch.ops import cluster_bvh as cb_mod
from raytracer3_tpu_torch.ops.backend import TraceBackend
from raytracer3_tpu_torch.ops.intersect import Hit
from raytracer3_tpu_torch.ops import mathx

_BG = mathx.BACKGROUND_DEPTH
STACK = 64  # the reference's minimum stack depth
STACK_CAPACITY = 128  # kStackCap in csrc/traverse.cu: the walks, and the general loop
DEEP_STACK_CAPACITY = 512  # kDeepStackCap: the general loop's second instantiation

# Kernel launches, counted where the CUDA kernel is launched and nowhere
# else (CPU calls run the plain version and are not counted). The K5
# (stats) launches of each shape count under their own "_stats" key.
# "closest"/"any" (K1/K2), "seg_*" (K3) and "tlas_*" (K4) count launches
# of the walk kernels, "*_general" launches on the general loop (a shape
# the walk is not compiled for), and "*_deep" launches of the general
# loop's 512-entry instantiation (a tree whose stack need exceeds 128).
_HITS = ("closest", "any", "seg_closest", "seg_any", "tlas_closest", "tlas_any")
_SHAPES = _HITS + tuple(f"{s}_general" for s in _HITS) + tuple(f"{s}_deep" for s in _HITS)
# The oracle backends' kernels (csrc/oracle_bvh.cu, ops/oracle_kernels.py)
# count here too, so that a replayed CUDA graph adds theirs
# (graph.capture_step): "lbvh_topology" and "lbvh_fit" (the LBVH build),
# "lbvh_closest"/"lbvh_any" (its walk), "cluster_closest"/"cluster_any",
# "wide_closest"/"wide_any" (the wide-BVH walk) and "rounds_pick"/
# "rounds_merge" (K3's rounds driver on the device, once each a round).
ORACLE_KEYS = ("lbvh_topology", "lbvh_fit", "lbvh_closest", "lbvh_any", "cluster_closest", "cluster_any",
               "wide_closest", "wide_any", "rounds_pick", "rounds_merge")
# The wavefront's shade pass (csrc/shade.cu, ops/shade_kernel.py) counts
# here as well, one key a form: "shade_deferred", "shade_split_a",
# "shade_split_b".
SHADE_KEYS = ("shade_deferred", "shade_split_a", "shade_split_b")
# The treelet driver's passes around K3 (csrc/treelet_driver.cu,
# ops/treelet_driver_kernel.py), one key a pass: "treelet_key" (the caps and
# sort keys) and "treelet_meta" (the sorted rays and segment metadata).
TREELET_DRIVER_KEYS = ("treelet_key", "treelet_meta")
# The sorted launch IO of the wavefront's coherence-sorted launches
# (csrc/sorted_io.cu, ops/sorted_io_kernel.py), one key a pass: "launch_key"
# (the sort key), "launch_in" (the rays in sorted order) and "launch_out"
# (the results back in lane order).
SORTED_IO_KEYS = ("launch_key", "launch_in", "launch_out")
# The probe resolve of the probe-GI frame (csrc/probe_resolve.cu,
# ops/probe_resolve_kernel.py), one key a pass: "probe_sis", "probe_sh" and
# "probe_interpolate".
PROBE_RESOLVE_KEYS = ("probe_sis", "probe_sh", "probe_interpolate")
LAUNCHES = {k: 0 for k in _SHAPES + tuple(f"{s}_stats" for s in _SHAPES) + ORACLE_KEYS + SHADE_KEYS
            + TREELET_DRIVER_KEYS + SORTED_IO_KEYS + PROBE_RESOLVE_KEYS}
# Pass-order boundaries ``pass_mark`` can mark (kPassMarks in csrc/traverse.cu).
PASS_MARKS = 16
# Columns of the K5 per-ray counts [N, 5] (int32, launch order).
STAT_COLUMNS = ("node_pops", "leaf_pops", "slab_tests", "tri_tests", "steps_or_hops")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "traverse.cu")
_SHIM = os.path.join(_PKG_DIR, "csrc", "host_shim.h")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # Keep the reference's rounding: no contracted multiply-adds.
    "--fmad=false",
)

# The walk kernels' compiled shapes (width, leaf size) and block size
# (csrc/traverse.cu: rt3_walk_*, rt3_walk_segments_*, rt3_walk_tlas_*).
WALK_SHAPES_PACKET = ((16, 12),)
WALK_SHAPES_SEGMENTS = ((16, 12), (16, 24))
WALK_SHAPES_TLAS = ((16, 12),)
WALK_BLOCK = 128
HOST_FLAGS = ("-std=c++17", "-O1", "-ffp-contract=off", "-x", "c++", "-DRT3_HOST_SHIM", "-shared", "-fPIC")

_lib_lock = threading.Lock()
_libs = {}  # build tag → bound library
_tag_locks = {}  # build tag → the lock its build holds


class PacketTables(NamedTuple):
    node_table: object  # [M, 64|128] f32 (cmin 3w | cmax 3w | codes w | pad)
    cluster_table: object  # [C, 128] f32 (9L tri data | L tri ids | AABB | pad)
    leaf_size: int
    num_nodes: int
    num_clusters: int
    width: int = 8
    depth: int = 1  # tree depth (root = 1) — sizes the traversal stack
    # Two-level (TLAS/BLAS) tables: the instance table (ops/tlas.py layout)
    # and the TLAS row count; None/0 for single-level tables.
    inst_table: object = None  # [I, 32] f32 (inverse 3×4 | BLAS root | pad)
    tlas_nodes: int = 0
    # Cluster rows carry the cluster AABB in lanes [10L, 10L+6).
    leaf_aabb: bool = False
    # Worst-case traversal stack (``tree_stack_need``), set when the tables
    # are packed; 0 = not known.
    stack_need: int = 0


def tree_stack_need(codes, root: int = 0) -> int:
    """Worst-case traversal stack of the tree under node ``root``, from the
    child codes [M, w] of its node rows (numpy): the most, over the paths
    from ``root`` down, of Σ (real children of a node − 1) + 1, the entries
    a depth-first walk holds once it has pushed the children of the last
    node on the path. A code ≤ −2 (a cluster, or a TLAS's instance) ends a
    path; −1 is an empty slot. One pass per tree level, bottom up."""
    codes = np.asarray(codes, np.float32)
    real = np.abs(codes + 1.0) > 0.25
    levels = [np.array([root], np.int64)]
    while True:
        ch = codes[levels[-1]]
        nxt = np.unique(ch[ch >= 0].astype(np.int64))
        if nxt.size == 0:
            break
        if len(levels) > codes.shape[0]:
            raise ValueError("node codes form a cycle")
        levels.append(nxt)
    need = np.ones(codes.shape[0], np.int64)
    for lvl in reversed(levels):
        ch = codes[lvl]
        inner = ch >= 0
        below = np.where(inner, need[np.where(inner, ch, 0).astype(np.int64)], 1)
        need[lvl] = real[lvl].sum(axis=1) - 1 + below.max(axis=1)
    return int(need[root])


def stack_need_of(node_table, width: int, inst_table=None) -> int:
    """``tree_stack_need`` of a node table [M, ≥ 7w] (numpy or a tensor),
    from row 0. Two-level tables (``inst_table`` [I, ≥ 13], BLAS roots in
    lane 12): the TLAS's need and the deepest BLAS's added. A thread holds
    the TLAS path's entries below an instance it pops (the TLAS need − 1),
    the walk's ``kLeaveInstance`` marker, and the BLAS walk above them."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    codes = host(node_table)[:, 6 * width : 7 * width]
    need = tree_stack_need(codes)
    if inst_table is not None:
        roots = np.unique(host(inst_table)[:, 12].astype(np.int64))
        need += max((tree_stack_need(codes, int(r)) for r in roots), default=0)
    return need


def pack_tables_host(cb: cb_mod.ClusterBVH) -> PacketTables:
    """Repack ClusterBVH for the kernel: cluster rows append the L triangle
    ids (as floats) and the padded cluster AABB. numpy in, numpy out."""
    ls = cb.leaf_size
    row_len = ((9 * ls + ls + 6 + 127) // 128) * 128
    ct = np.asarray(cb.cluster_table)
    tids = np.asarray(cb.tri_id).astype(np.float32)
    rows = np.zeros((ct.shape[0], row_len), np.float32)
    tri = ct[:, : 9 * ls].reshape(ct.shape[0], ls, 9)
    v0 = tri[:, :, 0:3]
    e1 = tri[:, :, 3:6]
    e2 = tri[:, :, 6:9]
    rows[:, : 9 * ls] = ct[:, : 9 * ls]
    rows[:, 9 * ls : 10 * ls] = tids
    # Cluster AABB over valid tris (v0, v0+e1, v0+e2), padded by an epsilon.
    p1 = v0 + e1
    p2 = v0 + e2
    valid = (tids >= 0)[:, :, None]
    big = np.float32(1e30)
    pts_lo = np.minimum(np.minimum(
        np.where(valid, v0, big), np.where(valid, p1, big)),
        np.where(valid, p2, big)).min(axis=1)
    pts_hi = np.maximum(np.maximum(
        np.where(valid, v0, -big), np.where(valid, p1, -big)),
        np.where(valid, p2, -big)).max(axis=1)
    eps = 1e-4 * (np.linalg.norm(pts_hi - pts_lo, axis=1, keepdims=True) + 1e-3)
    ab0 = 10 * ls
    rows[:, ab0 : ab0 + 3] = pts_lo - eps
    rows[:, ab0 + 3 : ab0 + 6] = pts_hi + eps
    return PacketTables(
        node_table=np.asarray(cb.node_table),
        cluster_table=rows,
        leaf_size=ls,
        num_nodes=cb.num_nodes,
        num_clusters=cb.num_clusters,
        width=cb.width,
        depth=cb.depth,
        leaf_aabb=True,
        stack_need=stack_need_of(cb.node_table, cb.width),
    )


def pack_two_level(tl) -> PacketTables:
    """``ops/tlas.TwoLevelTables`` → kernel tables (numpy; the cluster rows
    are in kernel layout already, from ``pack_tables_host``)."""
    return PacketTables(
        node_table=tl.node_table,
        cluster_table=tl.cluster_table,
        leaf_size=tl.leaf_size,
        num_nodes=tl.num_nodes,
        num_clusters=tl.num_clusters,
        width=tl.width,
        depth=tl.depth,
        inst_table=tl.inst_table,
        tlas_nodes=tl.tlas_nodes,
        leaf_aabb=True,
        stack_need=tl.stack_need,
    )


def _upload(table, device) -> torch.Tensor:
    if isinstance(table, torch.Tensor):
        return table.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.array(table, np.float32), device=device)


def pack_tables(cb: cb_mod.ClusterBVH, *, device) -> PacketTables:
    """``pack_tables_host`` + one upload of the two tables to ``device``."""
    return tables_from_numpy(pack_tables_host(cb), device)


def tables_from_numpy(pt, device) -> PacketTables:
    """Upload tables (the port's, or the reference's ``PacketTables`` with
    its fields pulled as numpy) to ``device``. The reference's tables carry
    no stack need: it is computed here, before the upload (two-level tables
    with their instance table; that table itself is not uploaded)."""
    need = getattr(pt, "stack_need", 0) or stack_need_of(pt.node_table, int(pt.width), pt.inst_table)
    return PacketTables(
        node_table=_upload(pt.node_table, device),
        cluster_table=_upload(pt.cluster_table, device),
        leaf_size=int(pt.leaf_size),
        num_nodes=int(pt.num_nodes),
        num_clusters=int(pt.num_clusters),
        width=int(pt.width),
        depth=int(pt.depth),
        leaf_aabb=bool(pt.leaf_aabb),
        stack_need=int(need),
    )


def stack_depth(tables) -> int:
    """The traversal stack that tables (``PacketTables`` or
    ``treelets.TreeletTables``) need: the worst case their packing computed
    from the node codes (``tree_stack_need``), carried as ``stack_need``."""
    if tables.stack_need < 1:
        raise ValueError("the tables carry no stack need: pack them with pack_tables_host, pack_two_level or "
                         "build_treelets_host, or set stack_need from stack_need_of")
    return int(tables.stack_need)


def reference_stack_depth(tables) -> int:
    """The reference's stack for these tables, sized from the depth alone
    (``max(STACK, (width − 1)·depth + 1 + depth)``,
    ``raytracer3_tpu/ops/pallas/traverse_kernel.py:1306``): the bound the
    port's wrappers held against 128 entries before the need was computed
    from the tables. Kept for the record (``chip_smoke.py``, the tests)."""
    return max(STACK, (tables.width - 1) * tables.depth + 1 + tables.depth)


# ---------------------------------------------------------------------------
# Kernel build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc")
    toolkit_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if path is None and os.path.exists(toolkit_nvcc):
        path = toolkit_nvcc
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels of csrc/")
    return path


def _build(compiler: str, flags, tag: str, source: str = _SRC) -> str:
    """Compile ``source`` (a file of ``csrc/``, ``csrc/traverse.cu`` unless
    given) into ``build/kernels`` (keyed on a hash of the source, the host
    shim and the flags, so an edited source rebuilds); returns the
    library's path."""
    with open(source, "rb") as f:
        src = f.read()
    with open(_SHIM, "rb") as f:
        src += f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"{tag}_{key}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([compiler, *flags, "-o", tmp, source], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed to build {source} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, so_path)
    return so_path


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    packet = [
        vp, vp, vp, ci,  # origins, directions, t_cap, n
        vp, ci, vp, ci,  # nodes, node row length, clusters, cluster row length
        ci, ci, cf, ci,  # width, leaf size, t_min, stack need
    ]
    outs = [vp, vp, vp, vp, vp, vp]  # out t, u, v, prim, out stats [n, 5] or null, stream
    for name in ("rt3_traverse_closest", "rt3_traverse_any", "rt3_walk_closest", "rt3_walk_any"):
        getattr(lib, name).argtypes = packet + outs
        getattr(lib, name).restype = ci
    for name in ("rt3_traverse_tlas_closest", "rt3_traverse_tlas_any", "rt3_walk_tlas_closest",
                 "rt3_walk_tlas_any"):
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, vp, vp, ci,  # origins, directions, t_cap, n
            vp, ci, vp, ci,  # nodes, node row length, clusters, cluster row length
            ci, ci, cf,  # width, leaf size, t_min
            vp, ci, ci, ci,  # instances, instance row length, number of clusters, stack need
            vp, vp, vp, vp, vp,  # out t, u, v, prim, instance
            vp, vp,  # out stats [n, 5] or null, stream
        ]
        fn.restype = ci
    segments = [
        vp, vp, vp, ci, ci,  # seg_list, seg_entry, seg_gmask, steps, mask words
        vp, vp, vp, vp, ctypes.c_longlong,  # origins, directions, t_cap, anyhit_row, n
        vp, ci, ci, vp, ci, ci,  # nodes, max nodes, node row, clusters, max clusters, cluster row
        ci, ci, cf, ci, ci, ci,  # width, leaf size, t_min, segment rays, group rays, step_cull
        ci, vp, vp, vp,  # stack need, out [4, n], out stats [n, 5] or null, stream
    ]
    lib.rt3_traverse_segments.argtypes = [ci] + segments  # any_hit first
    lib.rt3_traverse_segments.restype = ci
    for name in ("rt3_walk_segments_closest", "rt3_walk_segments_any"):
        getattr(lib, name).argtypes = segments
        getattr(lib, name).restype = ci
    lib.rt3_pass_mark.argtypes = [ci, vp]  # boundary, stream
    lib.rt3_pass_mark.restype = ci
    return lib


def load_library(source: str, bind, device_type: str = "cuda"):
    """``source`` (a file of ``csrc/``) built at first use and bound once by
    ``bind(so_path)``: with nvcc for sm_90a (``device_type`` "cuda") or with
    g++ under ``csrc/host_shim.h`` ("cpu": every thread of a launch run in
    turn, on CPU tensors). The library carries its ``rt3_device_type``; two
    sources build at once."""
    name = os.path.basename(source)
    tag = os.path.splitext(name)[0] + ("" if device_type == "cuda" else "_host")
    with _lib_lock:
        lock = _tag_locks.setdefault(tag, threading.Lock())
    with lock:
        if tag not in _libs:
            if device_type == "cuda":
                compiler, flags = _nvcc(), NVCC_FLAGS
            else:
                compiler, flags = shutil.which("g++"), HOST_FLAGS
                if compiler is None:
                    raise RuntimeError(f"g++ not found: it builds csrc/{name} for the CPU")
            lib = bind(_build(compiler, flags, tag, source))
            lib.rt3_device_type = device_type
            _libs[tag] = lib
        return _libs[tag]


def c_ptr(x) -> int:
    """A tensor's data pointer for a C entry point of ``csrc/`` (0 for None)."""
    return 0 if x is None else x.data_ptr()


def c_arg(x, name: str, shape, dtype, dev) -> torch.Tensor:
    """``x`` made contiguous, or a ValueError unless it is a ``dtype`` tensor
    of ``shape`` on ``dev``."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev:
        got = f"{x.dtype} {list(x.shape)} on {x.device}" if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}, got {got}")
    return x.contiguous()


def c_launch(lib, name: str, dev, *args) -> None:
    """Call ``rt3_<name>`` of a library from ``load_library`` with ``args``
    and the current stream of ``dev`` (no stream for the host build); a
    nonzero return raises. A launch of the CUDA build counts in
    ``LAUNCHES[name]``, so that a replayed CUDA graph adds it too."""
    cuda = lib.rt3_device_type == "cuda"
    if cuda:
        with torch.cuda.device(dev):
            rc = getattr(lib, "rt3_" + name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        rc = getattr(lib, "rt3_" + name)(*args, None)
    if rc != 0:
        raise RuntimeError(f"{name}_kernel launch failed: cudaError {rc}")
    if cuda:
        LAUNCHES[name] += 1


def load_kernels():
    """``csrc/traverse.cu`` built with nvcc for sm_90a at first use and
    bound once."""
    return load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/traverse.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (every thread of a launch run in turn). The tests
    run the kernels' own source through it; no wrapper does: a CPU tensor
    takes the plain version."""
    return load_library(_SRC, _bind, "cpu")


def pass_mark(boundary: int, device) -> None:
    """Launch ``pass_mark_kernel<boundary>`` (``csrc/traverse.cu``) on the
    current stream of a CUDA ``device``: an empty one-thread kernel whose
    name marks a boundary of a frame graph's pass order in a device trace
    (``graph.FrameGraph``). Nothing on another device. Counts no launch."""
    if torch.device(device).type != "cuda":
        return
    if not 0 <= boundary < PASS_MARKS:
        raise ValueError(f"pass boundary {boundary} outside [0, {PASS_MARKS})")
    rc = load_kernels().rt3_pass_mark(boundary, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pass marker launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# K1/K2: the single-level wrapper and its plain version
# ---------------------------------------------------------------------------


def _t_cap(t_max, n: int, device) -> torch.Tensor:
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        if t_max.shape != (n,) or t_max.dtype != torch.float32:
            raise ValueError(f"t_max must be float32 [{n}], got {t_max.dtype} {tuple(t_max.shape)}")
        if t_max.device != device or not t_max.is_contiguous():
            raise ValueError("t_max must be contiguous and on the rays' device")
        return t_max
    return torch.full((n,), float(t_max), dtype=torch.float32, device=device)


def trace_loop(width: int, leaf_size: int, two_level: bool = False, group_rays=None,
               stack_need: int = 1, single_level: bool = False) -> str:
    """Which loop of csrc/traverse.cu a launch of either hit kind takes on
    tables of this shape and stack need (``stack_depth``; on two-level
    tables it counts the walk's marker): K1/K2 with ``single_level``, K4
    with ``two_level``, else K3. ``"walk"``, the loop written for this
    card, for the shapes it is compiled for (K1/K2: ``WALK_SHAPES_PACKET``;
    K3: ``WALK_SHAPES_SEGMENTS``, with groups of whole blocks; K4:
    ``WALK_SHAPES_TLAS``) and a need of at most ``STACK_CAPACITY``;
    ``"deep"``, the general loop's ``DEEP_STACK_CAPACITY`` instantiation,
    for a larger need (past it the wrappers raise on the card); else
    ``"general"``, the loop that takes width and leaf size at run time."""
    if stack_need > STACK_CAPACITY:
        return "deep"
    shapes = WALK_SHAPES_TLAS if two_level else WALK_SHAPES_PACKET if single_level else WALK_SHAPES_SEGMENTS
    if (int(width), int(leaf_size)) not in shapes:
        return "general"
    if group_rays is not None and group_rays % WALK_BLOCK != 0:
        return "general"
    return "walk"


def _check_stack(tables) -> int:
    """The tables' stack need, where a kernel can hold it (on the card)."""
    need = stack_depth(tables)
    if need > DEEP_STACK_CAPACITY:
        raise ValueError(
            f"the tables need a {need}-entry traversal stack (depth {tables.depth}, width "
            f"{tables.width}); the kernels hold at most {DEEP_STACK_CAPACITY}")
    return need


def _launch_key(base: str, loop: str, stats: bool) -> str:
    """``LAUNCHES`` key of a launch of ``base`` (``_HITS``) on ``loop``."""
    if loop in ("deep", "general"):
        base += "_" + loop
    return base + ("_stats" if stats else "")


def _check_walk_tables(tables) -> None:
    """What the walk's 16-byte row loads assume of (name, tensor) tables."""
    for name, tab in tables:
        if tab.shape[-1] % 4 != 0:
            raise ValueError(f"{name} rows of {tab.shape[-1]} floats are not whole 16-byte words")
        if tab.data_ptr() % 16 != 0:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _check(pt: PacketTables, origins: torch.Tensor, directions: torch.Tensor):
    for name, a in (("origins", origins), ("directions", directions)):
        if a.dtype != torch.float32 or a.ndim != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be float32 [N, 3], got {a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origins.shape != directions.shape:
        raise ValueError("origins and directions differ in shape")
    tables = [("node_table", pt.node_table), ("cluster_table", pt.cluster_table)]
    if pt.inst_table is not None:
        tables.append(("inst_table", pt.inst_table))
        if pt.inst_table.ndim != 2 or pt.inst_table.shape[1] < 13:
            raise ValueError("inst_table must be [I, >= 13] (inverse 3x4 | BLAS root)")
    for name, tab in tables:
        if not isinstance(tab, torch.Tensor) or tab.dtype != torch.float32 or tab.ndim != 2:
            raise ValueError(f"{name} must be a float32 2-D tensor")
        if tab.device != origins.device or directions.device != origins.device:
            raise ValueError(
                f"rays on {origins.device}/{directions.device} but {name} on {tab.device}"
            )
        if not tab.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pt.node_table.shape[1] < 7 * pt.width or pt.cluster_table.shape[1] < 10 * pt.leaf_size:
        raise ValueError("table rows are shorter than width/leaf_size imply")


def _cluster_slots(cluster_rows: torch.Tensor, leaf_size: int):
    """(triangles [T, 9] as v0 e1 e2, global ids [T]) of the real triangle
    slots of packed cluster rows [C, lanes]."""
    ls = leaf_size
    tri = cluster_rows[:, : 9 * ls].reshape(-1, 9)
    tid = cluster_rows[:, 9 * ls : 10 * ls].reshape(-1)
    keep = tid >= 0
    return tri[keep], tid[keep]


def _brute_closest(tri, tid, origins, directions, t_min, t_cap):
    """Closest accepted slot of ``tri`` for each ray, with the kernel's
    Möller–Trumbore floats and accept rules (``|det| > 1e-9``, t in
    (t_min, t_cap)); the first slot wins exact t ties. Chunked over rays.
    Returns (found, t, u, v, prim int32); misses hold (BG, 0, 0, -1)."""
    n = origins.shape[0]
    dev = origins.device
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[:, k] for k in range(9))
    slots = max(int(tid.shape[0]), 1)
    budget = (1 << 26) if dev.type == "cuda" else (1 << 22)
    chunk = max(1, budget // slots)

    out_t = torch.full((n,), _BG, dtype=torch.float32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        o = origins[s : s + chunk]
        d = directions[s : s + chunk]
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
        ok = (
            det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > t_min) & (tt < t_cap[s : s + chunk, None])
        )
        tm = torch.where(ok, tt, torch.inf)
        best = torch.argmin(tm, dim=1, keepdim=True)
        found = ok.gather(1, best)[:, 0]
        out_t[s : s + chunk] = torch.where(found, tm.gather(1, best)[:, 0], _BG)
        out_u[s : s + chunk] = torch.where(found, uu.gather(1, best)[:, 0], 0.0)
        out_v[s : s + chunk] = torch.where(found, vv.gather(1, best)[:, 0], 0.0)
        out_prim[s : s + chunk] = torch.where(found, tid[best[:, 0]].to(torch.int32), -1)
    return out_prim >= 0, out_t, out_u, out_v, out_prim


def _subtree_clusters(pt: PacketTables, root: int) -> torch.Tensor:
    """Cluster ids of the leaves under node ``root`` (a BLAS), breadth first
    over the child codes."""
    w = pt.width
    codes = pt.node_table[:, 6 * w : 7 * w]
    frontier = torch.tensor([root], dtype=torch.int64, device=codes.device)
    leaves = []
    while frontier.numel():
        ch = codes[frontier].reshape(-1)
        leaves.append(ch[ch < -1])
        frontier = ch[ch >= 0].to(torch.int64)
    return (-torch.cat(leaves) - 2).to(torch.int64)


def _object_rays(m, origins, directions):
    """Rays through one instance's world→object 3×4 ``m`` [12], in the
    kernel's operation order."""
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = directions[:, 0], directions[:, 1], directions[:, 2]
    o = torch.stack([
        m[0] * ox + m[1] * oy + m[2] * oz + m[3],
        m[4] * ox + m[5] * oy + m[6] * oz + m[7],
        m[8] * ox + m[9] * oy + m[10] * oz + m[11],
    ], dim=1)
    d = torch.stack([
        m[0] * dx + m[1] * dy + m[2] * dz,
        m[4] * dx + m[5] * dy + m[6] * dz,
        m[8] * dx + m[9] * dy + m[10] * dz,
    ], dim=1)
    return o, d


def _two_level_plain(pt: PacketTables, origins, directions, t_min, t_cap) -> Hit:
    """K4's plain version: for each instance, the rays go through its
    world→object transform and brute-force its mesh's cluster rows (the
    leaves of its BLAS, in object space; t is affine-invariant), keeping the
    nearest hit with its mesh-global prim id and instance id. An earlier
    instance wins exact t ties."""
    n = origins.shape[0]
    dev = origins.device
    best_t = t_cap.clone()
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    insts = pt.inst_table
    slots = {}
    for k in range(insts.shape[0]):
        root = int(insts[k, 12])
        if root not in slots:
            slots[root] = _cluster_slots(pt.cluster_table[_subtree_clusters(pt, root)], pt.leaf_size)
        o, d = _object_rays(insts[k, :12], origins, directions)
        found, t, u, v, prim = _brute_closest(*slots[root], o, d, t_min, best_t)
        best_t = torch.where(found, t, best_t)
        best_u = torch.where(found, u, best_u)
        best_v = torch.where(found, v, best_v)
        best_id = torch.where(found, prim, best_id)
        best_inst = torch.where(found, k, best_inst)
    found = best_id >= 0
    return Hit(t=torch.where(found, best_t, _BG), uv=torch.stack([best_u, best_v], dim=-1),
               prim_id=best_id, hit=found, inst=best_inst)


def packet_intersect_plain(
    pt: PacketTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False,
) -> Hit:
    """The kernel's plain PyTorch version: the same Möller–Trumbore tests
    (same floats, ``|det| > 1e-9``, same accept rules) over EVERY triangle
    slot of the packed cluster rows, chunked over rays (two-level tables:
    per instance, over its mesh's rows in object space). Closest hit takes
    the smallest t and the first slot on exact ties; the kernel may pick
    another slot only on exact-t ties (shared edges) or grazing rays. Any
    hit answers with the closest hit."""
    t_cap = _t_cap(t_max, origins.shape[0], origins.device)
    if pt.inst_table is not None:
        return _two_level_plain(pt, origins, directions, t_min, t_cap)
    tri, tid = _cluster_slots(pt.cluster_table, pt.leaf_size)
    found, t, u, v, prim = _brute_closest(tri, tid, origins, directions, t_min, t_cap)
    return Hit(t=t, uv=torch.stack([u, v], dim=-1), prim_id=prim, hit=found)


def _launch_packet(lib, pt: PacketTables, origins, directions, t_cap, t_min: float, any_hit: bool,
                   stats: bool, loop: str, stream):
    """One launch of K1/K2/K4 from ``lib`` on tensors of any device (the
    CPU build of the source takes CPU tensors): (t, u, v, prim, inst or
    None, counts or None) as the kernel wrote them. ``loop`` picks the entry
    point (``"walk"``, else the general loop, whose entry point picks its
    stack from the tables' ``stack_need``); the wrapper passes
    ``trace_loop``'s answer, the checks that hold the loops against each
    other pass either. Counts no launch."""
    n = origins.shape[0]
    dev = origins.device
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_u = torch.empty((n,), dtype=torch.float32, device=dev)
    out_v = torch.empty((n,), dtype=torch.float32, device=dev)
    out_prim = torch.empty((n,), dtype=torch.int32, device=dev)
    rays = (origins.data_ptr(), directions.data_ptr(), t_cap.data_ptr(), n,
            pt.node_table.data_ptr(), pt.node_table.shape[1],
            pt.cluster_table.data_ptr(), pt.cluster_table.shape[1],
            pt.width, pt.leaf_size, float(t_min))
    outs = (out_t.data_ptr(), out_u.data_ptr(), out_v.data_ptr(), out_prim.data_ptr())
    counts = torch.empty((n, 5), dtype=torch.int32, device=dev) if stats else None
    stats_ptr = counts.data_ptr() if stats else None
    need = stack_depth(pt)
    out_inst = None
    if pt.inst_table is not None:
        out_inst = torch.empty((n,), dtype=torch.int32, device=dev)
        hit = "any" if any_hit else "closest"
        fn = getattr(lib, f"rt3_walk_tlas_{hit}" if loop == "walk" else f"rt3_traverse_tlas_{hit}")
        rc = fn(*rays, pt.inst_table.data_ptr(), pt.inst_table.shape[1], pt.num_clusters, need,
                *outs, out_inst.data_ptr(), stats_ptr, stream)
    else:
        hit = "any" if any_hit else "closest"
        fn = getattr(lib, f"rt3_walk_{hit}" if loop == "walk" else f"rt3_traverse_{hit}")
        rc = fn(*rays, need, *outs, stats_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed: cudaError {rc}")
    return out_t, out_u, out_v, out_prim, out_inst, counts


def packet_intersect(
    pt: PacketTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, stats: bool = False,
):
    """Trace rays [N, 3] through the wide cluster BVH. ``t_max`` is a scalar
    or a per-ray float32 [N] cap (0 parks a ray). Closest hit (K1) returns
    the nearest (t, uv, prim_id); any hit (K2) answers ``Hit.hit`` only.
    Two-level tables (``pt.inst_table`` set) take K4 for both, and the
    result carries ``Hit.inst``. Each runs the walk kernels where
    ``trace_loop`` says so, else the general loop. Tables whose stack need
    (``stack_depth``) exceeds 512 entries raise on CUDA.

    ``stats=True`` launches the K5 form of the same kernel and returns
    ``(Hit, counts)``: int32 [N, 5] per-ray visit counts in launch order
    (``STAT_COLUMNS``; column 4 counts K4's instance hops, 0 single-level).

    CUDA tensors launch the kernel or raise; CPU tensors run the plain
    version (``traverse_plain`` when ``stats``)."""
    _check(pt, origins, directions)
    two_level = pt.inst_table is not None
    loop = trace_loop(pt.width, pt.leaf_size, two_level=two_level, single_level=not two_level,
                      stack_need=stack_depth(pt))
    if loop == "walk":
        tables = (("node_table", pt.node_table), ("cluster_table", pt.cluster_table))
        _check_walk_tables(tables + ((("inst_table", pt.inst_table),) if two_level else ()))
        if two_level and pt.inst_table.shape[1] < 16:
            raise ValueError("inst_table rows must hold four 16-byte words")
    n = origins.shape[0]
    dev = origins.device
    t_cap = _t_cap(t_max, n, dev)
    if dev.type == "cpu":
        if stats:
            return traverse_plain(pt, origins, directions, t_min, t_cap, any_hit, stats=True)
        return packet_intersect_plain(pt, origins, directions, t_min, t_cap, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"packet_intersect runs on cpu or cuda tensors, not {dev}")
    _check_stack(pt)
    lib = load_kernels()
    with torch.cuda.device(dev):
        out_t, out_u, out_v, out_prim, out_inst, counts = _launch_packet(
            lib, pt, origins, directions, t_cap, t_min, any_hit, stats, loop,
            torch.cuda.current_stream(dev).cuda_stream)
    if n > 0:
        LAUNCHES[_launch_key(("tlas_" if two_level else "") + ("any" if any_hit else "closest"), loop, stats)] += 1
    found = out_prim >= 0
    hit = Hit(
        t=torch.where(found, out_t, _BG),
        uv=torch.stack([out_u, out_v], dim=-1),
        prim_id=out_prim,
        hit=found,
        inst=out_inst,
    )
    return (hit, counts) if stats else hit


# ---------------------------------------------------------------------------
# K3: the treelet segment grid
# ---------------------------------------------------------------------------


def _segment_groups(sublanes: int, max_groups: int):
    """(rays per segment, rays per group, group-mask words) of the reference's
    segment layout: ``sublanes``·128 rays per segment cut into at most
    ``max_groups`` groups of whole 8-row (1,024-ray) blocks."""
    groups = max(1, min(max_groups, sublanes // 8))
    p = sublanes * 128
    return p, p // groups, (groups + 31) // 32


def _check_segments(tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap,
                    anyhit_row, sublanes, max_groups) -> torch.Tensor:
    """Validate K3's inputs; returns seg_gmask as [S, E, W]."""
    p, _, n_words = _segment_groups(sublanes, max_groups)
    if seg_list.dtype != torch.int32 or seg_list.ndim != 2:
        raise ValueError(f"seg_list must be int32 [S, E], got {seg_list.dtype} {tuple(seg_list.shape)}")
    s_count, e_count = seg_list.shape
    n = origins.shape[0]
    if n != s_count * p:
        raise ValueError(f"{n} rays do not fill {s_count} segments of {p}")
    if seg_entry.dtype != torch.float32 or tuple(seg_entry.shape) != (s_count, e_count):
        raise ValueError("seg_entry must be float32 [S, E]")
    if seg_gmask.dtype != torch.int32 or seg_gmask.numel() != s_count * e_count * n_words:
        raise ValueError(f"seg_gmask must be int32 [S, E, {n_words}]")
    seg_gmask = seg_gmask.reshape(s_count, e_count, n_words)
    for name, a, shape in (
        ("origins", origins, (n, 3)), ("directions", directions, (n, 3)), ("t_cap", t_cap, (n,)),
        ("anyhit_row", anyhit_row, (n,)),
    ):
        if a is None:
            continue
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got {a.dtype} {tuple(a.shape)}")
    tables = (("node_tables", tt.node_tables), ("cluster_tables", tt.cluster_tables))
    for name, a in (("seg_list", seg_list), ("seg_entry", seg_entry), ("seg_gmask", seg_gmask),
                    ("origins", origins), ("directions", directions), ("t_cap", t_cap),
                    ("anyhit_row", anyhit_row)) + tables:
        if a is None:
            continue
        if not isinstance(a, torch.Tensor) or a.device != origins.device:
            raise ValueError(f"{name} must be a tensor on the rays' device {origins.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, a in tables:
        if a.dtype != torch.float32 or a.ndim != 3:
            raise ValueError(f"{name} must be float32 [K, rows, lanes]")
    if tt.node_tables.shape[2] < 7 * tt.width or tt.cluster_tables.shape[2] < 10 * tt.leaf_size:
        raise ValueError("table rows are shorter than width/leaf_size imply")
    return seg_gmask


def packet_intersect_segments_plain(
    tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap,
    t_min: float = 1e-4, any_hit: bool = False, anyhit_row=None,
    step_cull: bool = False, sublanes: int = 512, max_groups: int = 32,
) -> torch.Tensor:
    """K3's plain PyTorch version, a dense brute force over the segment
    grid: step e tests the rays of the step's active groups against every
    triangle slot of treelet ``seg_list[s, e]`` (``packet_intersect_plain``'s
    floats and accept rules) and carries each ray's best t to the next step.
    A ray skips a step as the kernel does: group bit clear, any-hit lane
    already resolved, or (``step_cull``, after step 0) best t at or below
    the step's entry distance. Any-hit and flagged lanes record t = 0 on
    their first accepted step."""
    s_count, e_count = seg_list.shape
    n = origins.shape[0]
    dev = origins.device
    p, group_rays, n_words = _segment_groups(sublanes, max_groups)
    gm = seg_gmask.reshape(s_count, e_count, n_words)
    ray = torch.arange(n, device=dev)
    seg = ray // p
    grp = (ray % p) // group_rays
    word, bit = grp // 32, grp % 32
    if any_hit:
        flag = torch.ones((n,), dtype=torch.bool, device=dev)
    elif anyhit_row is not None:
        flag = anyhit_row > 0.5
    else:
        flag = torch.zeros((n,), dtype=torch.bool, device=dev)
    best_t = t_cap.clone()
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    retired = torch.zeros((n,), dtype=torch.bool, device=dev)
    slots = [_cluster_slots(tt.cluster_tables[k], tt.leaf_size) for k in range(tt.cluster_tables.shape[0])]
    for e in range(e_count):
        active = (((gm[seg, e, word] >> bit) & 1) == 1) & ~retired
        if any_hit:
            active &= t_cap > t_min
        if step_cull and e > 0:
            active &= best_t > seg_entry[seg, e]
        tid_e = seg_list[seg, e]
        for k, (tri, tid) in enumerate(slots):
            idx = torch.nonzero(active & (tid_e == k)).squeeze(1)
            if idx.numel() == 0:
                continue
            found, t, u, v, prim = _brute_closest(tri, tid, origins[idx], directions[idx], t_min, best_t[idx])
            fi = idx[found]
            best_t[fi] = torch.where(flag[fi], 0.0, t[found])
            best_u[fi] = u[found]
            best_v[fi] = v[found]
            best_id[fi] = prim[found]
            retired[fi] = flag[fi]
    return torch.stack([best_t, best_u, best_v, best_id.to(torch.float32)])


def _launch_segments(lib, tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, anyhit_row,
                     t_min: float, any_hit: bool, step_cull: bool, sublanes: int, max_groups: int,
                     stats: bool, loop: str, stream):
    """One launch of K3 from ``lib`` on tensors of any device: ([4, S·p]
    rows, counts or None) as the kernel wrote them. ``loop`` as in
    ``_launch_packet``. Counts no launch."""
    p, group_rays, n_words = _segment_groups(sublanes, max_groups)
    n = origins.shape[0]
    dev = origins.device
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    counts = torch.empty((n, 5), dtype=torch.int32, device=dev) if stats else None
    nodes, clusters = tt.node_tables, tt.cluster_tables
    args = (
        seg_list.data_ptr(), seg_entry.data_ptr(), seg_gmask.data_ptr(), seg_list.shape[1], n_words,
        origins.data_ptr(), directions.data_ptr(), t_cap.data_ptr(),
        None if anyhit_row is None else anyhit_row.data_ptr(), n,
        nodes.data_ptr(), nodes.shape[1], nodes.shape[2],
        clusters.data_ptr(), clusters.shape[1], clusters.shape[2],
        tt.width, tt.leaf_size, float(t_min), p, group_rays, int(step_cull), stack_depth(tt),
        out.data_ptr(), counts.data_ptr() if stats else None, stream,
    )
    if loop == "walk":
        rc = (lib.rt3_walk_segments_any if any_hit else lib.rt3_walk_segments_closest)(*args)
    else:
        rc = lib.rt3_traverse_segments(int(any_hit), *args)
    if rc != 0:
        raise RuntimeError(f"segment traverse kernel launch failed: cudaError {rc}")
    return out, counts


def packet_intersect_segments(
    tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap,
    t_min: float = 1e-4, any_hit: bool = False, anyhit_row=None,
    step_cull: bool = False, sublanes: int = 512, max_groups: int = 32,
    stats: bool = False,
):
    """Segment-grid traversal over stacked treelet tables (the driver is
    ``treelets.treelet_intersect``). Rays [S·p, 3] come in segment order,
    p = ``sublanes``·128 rays per segment, cut into at most ``max_groups``
    groups. Step e of segment s traverses treelet ``seg_list[s, e]`` for the
    rays whose group bit is set in ``seg_gmask[s, e]``, carrying best t.
    ``anyhit_row`` ([S·p] f32, > 0.5 = flagged) marks lanes that retire on
    their first accepted hit. Returns [4, S·p] rows (t, u, v, prim id as
    float) in the callers' ray order: a miss holds its t_cap and prim -1,
    an any-hit or flagged lane that hit holds t = 0. ``stats=True``
    launches the K5 form and returns ``(out, counts)``: int32 [S·p, 5]
    per-ray visit counts (``STAT_COLUMNS``; column 4 the steps the ray
    traversed). Both hit kinds run the walk kernels where ``trace_loop``
    says so, else the general loop; tables whose stack need exceeds 512
    entries raise on CUDA.

    CUDA tensors launch the kernel or raise; CPU tensors run the plain
    version (``segments_traverse_plain`` when ``stats``)."""
    seg_gmask = _check_segments(tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap,
                                anyhit_row, sublanes, max_groups)
    loop = trace_loop(tt.width, tt.leaf_size, group_rays=_segment_groups(sublanes, max_groups)[1],
                      stack_need=stack_depth(tt))
    if loop == "walk":
        _check_walk_tables((("node_tables", tt.node_tables), ("cluster_tables", tt.cluster_tables)))
    kw = dict(t_min=t_min, any_hit=any_hit, anyhit_row=anyhit_row, step_cull=step_cull,
              sublanes=sublanes, max_groups=max_groups)
    dev = origins.device
    if dev.type == "cpu":
        if stats:
            return segments_traverse_plain(
                tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, stats=True, **kw)
        return packet_intersect_segments_plain(
            tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, **kw)
    if dev.type != "cuda":
        raise ValueError(f"packet_intersect_segments runs on cpu or cuda tensors, not {dev}")
    _check_stack(tt)
    lib = load_kernels()
    with torch.cuda.device(dev):
        out, counts = _launch_segments(
            lib, tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, anyhit_row, t_min,
            any_hit, step_cull, sublanes, max_groups, stats, loop,
            torch.cuda.current_stream(dev).cuda_stream)
    if origins.shape[0] > 0:
        LAUNCHES[_launch_key("seg_any" if any_hit else "seg_closest", loop, stats)] += 1
    return (out, counts) if stats else out


# ---------------------------------------------------------------------------
# K5: the visit counts' plain version, a per-ray traversal
# ---------------------------------------------------------------------------


def _clamped_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / where(|d| < 1e-12, 1e-12, d), the kernel's ray inverse."""
    return 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)


def _walk(nodes, clusters, width: int, leaf_size: int, t_min: float, o, d, best: dict, any_hit: bool,
          retire, counts, cap: int, node_base=None, cluster_base=None, insts=None, num_clusters: int = 0):
    """Walk every ray of ``o``/``d`` [M, 3] through one tree from node row 0
    (plus ``node_base``/``cluster_base`` [M], the rows of a ray's treelet),
    as csrc/traverse.cu's loop walks it: one pop per live ray per
    iteration, the same slab and Möller–Trumbore floats, the same child
    order (near-first: pushed far-first, later slots first among equal keys;
    ``any_hit``: pushed in slot order), the same empty-slot, miss and accept
    rules, and retirement on the first accepted hit where ``retire`` [M].
    With ``insts`` the tree is a TLAS: a negative entry at its level is an
    instance, whose BLAS (root in lane 12) the ray walks in object space on
    the stack above its TLAS entries. ``cap`` is the stack's size, the
    tables' ``stack_need``: a push beyond it raises.

    Updates ``best`` (t, u, v, id, inst: [M] tensors) and ``counts``
    [M, 5] (``STAT_COLUMNS``) in place; returns the rays that retired."""
    m = o.shape[0]
    dev = o.device
    w, ls = width, leaf_size
    lanes = torch.arange(w, device=dev)
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)
    inv = _clamped_inv(d)
    stack = torch.zeros((m, cap), dtype=torch.int64, device=dev)  # root 0 at [:, 0]
    sp = torch.ones((m,), dtype=torch.int64, device=dev)
    retired = torch.zeros((m,), dtype=torch.bool, device=dev)
    nb = torch.zeros((m,), dtype=torch.int64, device=dev) if node_base is None else node_base
    cb = torch.zeros((m,), dtype=torch.int64, device=dev) if cluster_base is None else cluster_base
    two_level = insts is not None
    if two_level:
        blas_base = torch.full((m,), cap, dtype=torch.int64, device=dev)  # no BLAS entered
        obj_o, obj_d, obj_inv = o.clone(), d.clone(), inv.clone()
        cur_inst = torch.full((m,), -1, dtype=torch.int32, device=dev)
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        pos = sp[live]
        entry = stack[live, pos]
        ro, rd, ri = o[live], d[live], inv[live]
        if two_level:
            in_blas = pos >= blas_base[live]
            blas_base[live[~in_blas]] = cap  # a TLAS pop leaves the instance
            sel = in_blas[:, None]
            ro = torch.where(sel, obj_o[live], ro)
            rd = torch.where(sel, obj_d[live], rd)
            ri = torch.where(sel, obj_inv[live], ri)
            is_inst = (entry < 0) & ~in_blas
            is_leaf = (entry < 0) & in_blas
        else:
            is_inst = None
            is_leaf = entry < 0
        is_node = entry >= 0

        if bool(is_node.any()):
            ids, e = live[is_node], entry[is_node]
            k = ids.shape[0]
            rows = nodes[nb[ids] + e]
            cmin = rows[:, : 3 * w].reshape(k, w, 3)
            cmax = rows[:, 3 * w : 6 * w].reshape(k, w, 3)
            code = rows[:, 6 * w : 7 * w]
            real = (code + 1.0).abs() > 0.25
            o_, i_ = ro[is_node][:, None, :], ri[is_node][:, None, :]
            t0 = (cmin - o_) * i_
            t1 = (cmax - o_) * i_
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), torch.maximum(lo[..., 2], tmin))
            tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                               torch.minimum(hi[..., 2], best["t"][ids][:, None]))
            take = real & (tn <= tf) & ~torch.isinf(tn)
            counts[ids, 0] += 1
            counts[ids, 2] += real.sum(dim=1)
            if any_hit:
                # Any hit: pushes in slot order.
                perm = torch.argsort((~take).to(torch.int8), dim=1, stable=True)
            else:
                # Far-first pushes; among equal keys the later slot first.
                keys = torch.where(take, tn, -torch.inf).flip(1)
                perm = (w - 1) - torch.argsort(keys, dim=1, descending=True, stable=True)
            pushed = code.gather(1, perm).to(torch.int64)
            cnt = take.sum(dim=1)
            base = sp[ids]
            if bool((base + cnt > cap).any()):
                raise RuntimeError(f"traversal stack overflow: more than the tables' stack need, {cap}")
            keep = lanes[None, :] < cnt[:, None]
            stack[ids[:, None].expand(-1, w)[keep], (base[:, None] + lanes[None, :])[keep]] = pushed[keep]
            sp[ids] = base + cnt

        if is_inst is not None and bool(is_inst.any()):
            ids, e = live[is_inst], entry[is_inst]
            kk = -e - 2 - num_clusters
            mx = insts[kk]
            oi, di = ro[is_inst], rd[is_inst]
            ox, oy, oz = oi[:, 0], oi[:, 1], oi[:, 2]
            dx, dy, dz = di[:, 0], di[:, 1], di[:, 2]
            no = torch.stack([
                mx[:, 0] * ox + mx[:, 1] * oy + mx[:, 2] * oz + mx[:, 3],
                mx[:, 4] * ox + mx[:, 5] * oy + mx[:, 6] * oz + mx[:, 7],
                mx[:, 8] * ox + mx[:, 9] * oy + mx[:, 10] * oz + mx[:, 11],
            ], dim=1)
            nd = torch.stack([
                mx[:, 0] * dx + mx[:, 1] * dy + mx[:, 2] * dz,
                mx[:, 4] * dx + mx[:, 5] * dy + mx[:, 6] * dz,
                mx[:, 8] * dx + mx[:, 9] * dy + mx[:, 10] * dz,
            ], dim=1)
            obj_o[ids], obj_d[ids], obj_inv[ids] = no, nd, _clamped_inv(nd)
            cur_inst[ids] = kk.to(torch.int32)
            counts[ids, 4] += 1
            base = sp[ids]
            if bool((base + 1 > cap).any()):
                raise RuntimeError(f"traversal stack overflow: more than the tables' stack need, {cap}")
            stack[ids, base] = mx[:, 12].to(torch.int64)
            blas_base[ids] = base
            sp[ids] = base + 1

        if bool(is_leaf.any()):
            ids, e = live[is_leaf], entry[is_leaf]
            k = ids.shape[0]
            crow = clusters[cb[ids] + (-e - 2)]
            tri = crow[:, : 9 * ls].reshape(k, ls, 9)
            tid = crow[:, 9 * ls : 10 * ls]
            oi, di = ro[is_leaf], rd[is_leaf]
            ox, oy, oz = oi[:, 0], oi[:, 1], oi[:, 2]
            dx, dy, dz = di[:, 0], di[:, 1], di[:, 2]
            bt, bu, bv = best["t"][ids], best["u"][ids], best["v"][ids]
            bid, binst = best["id"][ids], best["inst"][ids]
            inst_k = cur_inst[ids] if two_level else torch.full((k,), -1, dtype=torch.int32, device=dev)
            rt = retire[ids]
            stopped = torch.zeros((k,), dtype=torch.bool, device=dev)
            ntri = torch.zeros((k,), dtype=counts.dtype, device=dev)
            for j in range(ls):
                valid = (tid[:, j] >= 0.0) & ~stopped
                ntri += valid
                v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[:, j, q] for q in range(9))
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                det_ok = det.abs() > 1e-9
                inv_det = torch.where(det_ok, 1.0 / det, 0.0)
                tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
                uu = (tx * px + ty * py + tz * pz) * inv_det
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                vv = (dx * qx + dy * qy + dz * qz) * inv_det
                tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                ok = (valid & det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                      & (tt > t_min) & (tt < bt))
                bt = torch.where(ok, tt, bt)
                bu = torch.where(ok, uu, bu)
                bv = torch.where(ok, vv, bv)
                bid = torch.where(ok, tid[:, j].to(torch.int32), bid)
                binst = torch.where(ok, inst_k, binst)
                stopped |= ok & rt
            best["t"][ids], best["u"][ids], best["v"][ids] = bt, bu, bv
            best["id"][ids], best["inst"][ids] = bid, binst
            counts[ids, 1] += 1
            counts[ids, 3] += ntri
            done = ids[stopped]
            sp[done] = 0  # the first accepted hit ends the whole walk
            retired[done] = True
    return retired


def _new_best(t_cap: torch.Tensor) -> dict:
    n, dev = t_cap.shape[0], t_cap.device
    return dict(
        t=t_cap.clone(),
        u=torch.zeros((n,), dtype=torch.float32, device=dev),
        v=torch.zeros((n,), dtype=torch.float32, device=dev),
        id=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inst=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )


def traverse_plain(
    pt: PacketTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, stats: bool = True,
):
    """K5's plain version, and K1/K2/K4's traversal in PyTorch: every ray
    walks the tree in the kernel's order with the kernel's tests
    (``_walk``), vectorised over rays with an [N, stack need] stack. Returns the
    kernel's ``Hit`` to the bit, prim ids on exact-t ties included, and with
    ``stats`` also ``(Hit, counts)``: int32 [N, 5] (``STAT_COLUMNS``)."""
    n = origins.shape[0]
    dev = origins.device
    t_cap = _t_cap(t_max, n, dev)
    best = _new_best(t_cap)
    counts = torch.zeros((n, 5), dtype=torch.int64, device=dev)
    two_level = pt.inst_table is not None
    _walk(pt.node_table, pt.cluster_table, pt.width, pt.leaf_size, t_min, origins, directions, best,
          any_hit, torch.full((n,), bool(any_hit), dtype=torch.bool, device=dev), counts, stack_depth(pt),
          insts=pt.inst_table if two_level else None, num_clusters=pt.num_clusters)
    found = best["id"] >= 0
    hit = Hit(t=torch.where(found, best["t"], _BG), uv=torch.stack([best["u"], best["v"]], dim=-1),
              prim_id=best["id"], hit=found, inst=best["inst"] if two_level else None)
    return (hit, counts.to(torch.int32)) if stats else hit


def segments_traverse_plain(
    tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap,
    t_min: float = 1e-4, any_hit: bool = False, anyhit_row=None,
    step_cull: bool = False, sublanes: int = 512, max_groups: int = 32,
    stats: bool = False,
):
    """K3's traversal in PyTorch, the segment-grid form of
    ``traverse_plain``: each ray walks its segment's steps in order and
    skips one as the kernel does (group bit clear; an any-hit lane whose
    cap is at or below t_min skips them all; ``step_cull``, after step 0,
    when its best t is at or below the step's entry), counting the steps it
    traverses in column 4; a flagged or any-hit lane that accepts a hit
    records t = 0 and stops. Returns [4, S·p] rows as
    ``packet_intersect_segments`` does, and with ``stats`` also the int32
    [S·p, 5] counts."""
    s_count, e_count = seg_list.shape
    n = origins.shape[0]
    dev = origins.device
    p, group_rays, n_words = _segment_groups(sublanes, max_groups)
    gm = seg_gmask.reshape(s_count, e_count, n_words)
    ray = torch.arange(n, device=dev)
    seg = ray // p
    grp = (ray % p) // group_rays
    word, bit = grp // 32, grp % 32
    if any_hit:
        flag = torch.ones((n,), dtype=torch.bool, device=dev)
    elif anyhit_row is not None:
        flag = anyhit_row > 0.5
    else:
        flag = torch.zeros((n,), dtype=torch.bool, device=dev)
    best = _new_best(t_cap)
    counts = torch.zeros((n, 5), dtype=torch.int64, device=dev)
    done = (t_cap <= t_min) if any_hit else torch.zeros((n,), dtype=torch.bool, device=dev)
    nodes = tt.node_tables.reshape(-1, tt.node_tables.shape[2])
    clusters = tt.cluster_tables.reshape(-1, tt.cluster_tables.shape[2])
    mt, ct = tt.node_tables.shape[1], tt.cluster_tables.shape[1]
    for e in range(e_count):
        active = (((gm[seg, e, word] >> bit) & 1) == 1) & ~done
        if step_cull and e > 0:
            active &= best["t"] > seg_entry[seg, e]
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            continue
        counts[idx, 4] += 1
        tid = seg_list[seg[idx], e].to(torch.int64)
        sub = {key: v[idx] for key, v in best.items()}
        sub_counts = torch.zeros((idx.shape[0], 5), dtype=torch.int64, device=dev)
        retired = _walk(nodes, clusters, tt.width, tt.leaf_size, t_min, origins[idx], directions[idx], sub,
                        any_hit, flag[idx], sub_counts, stack_depth(tt), node_base=tid * mt, cluster_base=tid * ct)
        sub["t"] = torch.where(retired, 0.0, sub["t"])
        for key, v in sub.items():
            best[key][idx] = v
        counts[idx] += sub_counts
        done[idx[retired]] = True
    out = torch.stack([best["t"], best["u"], best["v"], best["id"].to(torch.float32)])
    return (out, counts.to(torch.int32)) if stats else out


# Scenes whose estimated cluster table exceeds this take the treelet path.
# It equals the reference's CLUSTERS_VMEM_LIMIT, so both packages route the
# same scene the same way (the 19k-triangle atrium single-level, the
# 300k-triangle one to treelets).
TREELET_ROUTE_BYTES = 6 * 1024 * 1024


def _single_level_tables(host_tris, leaf_size: int, width: int, cluster_mode: str, device) -> PacketTables:
    """K1/K2's tables of numpy (v0, v1, v2) on ``device``; the kernels are
    built first on CUDA."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("packet_backend: a CUDA device was asked for but none is available")
        load_kernels()
    cb = cb_mod.build_cluster_bvh_host(*host_tris, leaf_size, width=width, cluster_mode=cluster_mode)
    return tables_from_numpy(pack_tables_host(cb), device)


def packet_backend(
    scene=None, leaf_size: int = 12, width: int = 16, host_tris=None,
    cluster_mode: str = "sah", force_treelets: bool = False, *, device,
) -> TraceBackend:
    """Build the tables on the host, upload them to ``device`` and wrap the
    traversal in a TraceBackend. Pass numpy ``host_tris=(v0, v1, v2)`` (or a
    scene, whose triangles are then copied to the host).

    A scene whose estimated cluster table (``ceil(T/leaf)·1.35`` rows of
    the leaf's row length) exceeds ``TREELET_ROUTE_BYTES``, or any scene
    with ``force_treelets``, gets ``treelets.treelet_backend`` with the
    treelet defaults (leaf 24 overrides this function's small-scene leaf
    size); the rest get single-level tables and K1/K2."""
    device = torch.device(device)
    if host_tris is None:
        host_tris = tuple(t.detach().cpu().numpy() for t in scene.tri_vertices())
    v0, v1, v2 = host_tris
    row_len = ((9 * leaf_size + leaf_size + 6 + 127) // 128) * 128
    est_clusters = -(-v0.shape[0] // leaf_size) * 1.35  # SAH underfill slack
    if force_treelets or est_clusters * row_len * 4 > TREELET_ROUTE_BYTES:
        from raytracer3_tpu_torch.ops import treelets

        return treelets.treelet_backend(host_tris=(v0, v1, v2), width=width, device=device)
    return _single_level_backend(host_tris, leaf_size, width, cluster_mode, device)


def _single_level_backend(host_tris, leaf_size, width, cluster_mode, device) -> TraceBackend:
    """Single-level tables (K1/K2) as a TraceBackend: the tables in
    ``arrays``, the full ``PacketTables`` in ``meta``."""
    pt = _single_level_tables(host_tris, leaf_size, width, cluster_mode, device)
    meta = pt._replace(node_table=None, cluster_table=None)
    arrays = {"nodes": pt.node_table, "clusters": pt.cluster_table}

    def _tables(arrays) -> PacketTables:
        return meta._replace(node_table=arrays["nodes"], cluster_table=arrays["clusters"])

    def isect_fn(arrays, o, d):
        return packet_intersect(_tables(arrays), o.contiguous(), d.contiguous())

    def occl_fn(arrays, o, d, tmax):
        if isinstance(tmax, torch.Tensor):
            tmax = tmax.contiguous()
        return packet_intersect(
            _tables(arrays), o.contiguous(), d.contiguous(), t_max=tmax, any_hit=True
        ).hit

    return TraceBackend(arrays, isect_fn, occl_fn, meta=pt)


def make_packet_backend(scene=None, leaf_size: int = 12, width: int = 16, host_tris=None, *, device):
    """Scene → (intersect_fn, occluded_fn, PacketTables) over the
    single-level tables ``packet_backend`` builds (never routed to
    treelets). Pass numpy ``host_tris=(v0, v1, v2)`` or a scene, whose
    triangles are then copied to the host."""
    device = torch.device(device)
    if host_tris is None:
        host_tris = tuple(t.detach().cpu().numpy() for t in scene.tri_vertices())
    b = _single_level_backend(host_tris, leaf_size, width, "sah", device)
    return (*b.bind(b.arrays), b.meta)
