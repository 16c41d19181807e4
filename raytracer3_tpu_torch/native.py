"""ctypes bindings for the native asset-pipeline library
(``native/rt3native.cpp``), the port's own copy of ``raytracer3_tpu/native.py``:
the mesh-processing entry points (welding, vertex-cache and fetch order,
the cache metrics, position and normal codecs, simplification, spatial
splits), the SAH triangle clustering and the binned-SAH BVH over boxes.

The library is compiled with g++ at first use into ``build/native/`` (keyed
on a hash of the source and flags, so an edited source rebuilds) and loaded
with ctypes. It is never shared with the JAX package's build. Without g++ or
a loadable library ``get_lib`` raises (``available`` says whether it
loads): the reference's numpy and Morton fallbacks give other trees and
other bytes, and the port's tables and encodings must equal the
reference's bit for bit.
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

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "rt3native.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _bind(lib):
    c_int = ctypes.c_int
    c_float = ctypes.c_float
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.rt3_weld_vertices.argtypes = [fp, c_int, c_int, ip]
    lib.rt3_weld_vertices.restype = c_int
    lib.rt3_optimize_vertex_cache.argtypes = [ip, c_int, c_int]
    lib.rt3_optimize_vertex_fetch.argtypes = [ip, c_int, c_int, ip]
    lib.rt3_optimize_vertex_fetch.restype = c_int
    lib.rt3_analyze_cache.argtypes = [ip, c_int, c_int, c_int, ctypes.POINTER(c_float), ctypes.POINTER(c_float)]
    lib.rt3_quantize_positions_14.argtypes = [fp, c_int, u16p, fp]
    lib.rt3_dequantize_positions_14.argtypes = [u16p, c_int, fp, fp]
    lib.rt3_encode_normals_octa8.argtypes = [fp, c_int, u16p]
    lib.rt3_decode_normals_octa8.argtypes = [u16p, c_int, fp]
    lib.rt3_split_fragments.argtypes = [fp, fp, fp, c_int, c_int, ip, fp, fp]
    lib.rt3_split_fragments.restype = c_int
    lib.rt3_simplify.argtypes = [fp, c_int, ip, c_int, c_int, c_float, ip, ctypes.POINTER(c_float)]
    lib.rt3_simplify.restype = c_int
    lib.rt3_build_sah_bvh.argtypes = [fp, fp, c_int, ip, ip, fp, fp, ip]
    lib.rt3_build_sah_bvh.restype = c_int
    lib.rt3_build_clusters.argtypes = [fp, fp, c_int, c_int, ip]
    lib.rt3_build_clusters.restype = c_int
    lib.rt3_build_clusters_sah.argtypes = [fp, fp, c_int, c_int, ip]
    lib.rt3_build_clusters_sah.restype = c_int
    return lib


def get_lib():
    """Load the native library, building it first if needed. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                src = f.read()
        except OSError as e:
            raise RuntimeError(f"native library source {_SRC} is missing") from e
        key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        so_path = os.path.join(_BUILD_DIR, f"rt3native_{key}.so")
        if not os.path.exists(so_path):
            cxx = shutil.which(CXX)
            if cxx is None:
                raise RuntimeError(f"{CXX} not found: it is needed to build {_SRC}")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} failed to build {_SRC} (exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so_path)
        try:
            _lib = _bind(ctypes.CDLL(so_path))
        except OSError as e:
            raise RuntimeError(f"cannot load the native library {so_path}: {e}") from e
        return _lib


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def weld_vertices(attrs: np.ndarray):
    """Merge identical vertex rows → (remap [V] old → new, new count)."""
    attrs = np.ascontiguousarray(attrs, np.float32)
    remap = np.zeros(len(attrs), np.int32)
    n = get_lib().rt3_weld_vertices(attrs, len(attrs), attrs.shape[1], remap)
    return remap, int(n)


def optimize_vertex_cache(indices: np.ndarray, n_verts: int) -> np.ndarray:
    """Forsyth linear-speed vertex-cache order of the triangles → [M, 3]."""
    lib = get_lib()
    idx = np.ascontiguousarray(indices.reshape(-1), np.int32).copy()
    if len(idx) >= 3:
        lib.rt3_optimize_vertex_cache(idx, len(idx) // 3, n_verts)
    return idx.reshape(-1, 3)


def optimize_vertex_fetch(indices: np.ndarray, n_verts: int):
    """Vertices renumbered by first use → (new indices [M, 3], remap old → new)."""
    lib = get_lib()
    idx = np.ascontiguousarray(indices.reshape(-1), np.int32).copy()
    remap = np.zeros(n_verts, np.int32)
    lib.rt3_optimize_vertex_fetch(idx, len(idx) // 3, n_verts, remap)
    return idx.reshape(-1, 3), remap


def analyze_cache(indices: np.ndarray, n_verts: int, cache_size: int = 32):
    """(ACMR, ATVR) under a FIFO cache of ``cache_size`` vertices."""
    idx = np.ascontiguousarray(indices.reshape(-1), np.int32)
    acmr = ctypes.c_float()
    atvr = ctypes.c_float()
    get_lib().rt3_analyze_cache(idx, len(idx) // 3, n_verts, cache_size, ctypes.byref(acmr), ctypes.byref(atvr))
    return float(acmr.value), float(atvr.value)


def quantize_positions(pos: np.ndarray):
    """14-bit positions → (uint16 [N, 3], scale_bias [6] f32)."""
    pos = np.ascontiguousarray(pos, np.float32)
    out = np.zeros_like(pos, dtype=np.uint16)
    sb = np.zeros(6, np.float32)
    get_lib().rt3_quantize_positions_14(pos, len(pos), out, sb)
    return out, sb


def dequantize_positions(qpos: np.ndarray, scale_bias: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(qpos, np.uint16)
    out = np.zeros((len(q), 3), np.float32)
    get_lib().rt3_dequantize_positions_14(q, len(q), np.ascontiguousarray(scale_bias, np.float32), out)
    return out


def encode_normals(nrm: np.ndarray) -> np.ndarray:
    """8+8-bit octahedral normals → uint16 [N]."""
    n = np.ascontiguousarray(nrm, np.float32)
    out = np.zeros(len(n), np.uint16)
    get_lib().rt3_encode_normals_octa8(n, len(n), out)
    return out


def decode_normals(enc: np.ndarray) -> np.ndarray:
    e = np.ascontiguousarray(enc, np.uint16)
    out = np.zeros((len(e), 3), np.float32)
    get_lib().rt3_decode_normals_octa8(e, len(e), out)
    return out


def simplify(positions: np.ndarray, indices: np.ndarray, target_ratio: float = 0.5, max_error: float = 0.0):
    """Quadric edge-collapse simplification onto the existing vertices
    (border-locked, normal-flip-guarded) → (new indices [M, 3], the square
    root of the worst single collapse's quadric error). ``max_error`` > 0
    stops before a collapse above that error."""
    idx = np.ascontiguousarray(indices.reshape(-1, 3), np.int32)
    lib = get_lib()
    if len(idx) == 0:
        return idx, 0.0
    pos = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    out = np.zeros_like(idx).reshape(-1)
    err = ctypes.c_float()
    m = lib.rt3_simplify(pos, len(pos), np.ascontiguousarray(idx.reshape(-1)), len(idx),
                         max(0, int(len(idx) * target_ratio)), float(max_error), out, ctypes.byref(err))
    return out[: m * 3].reshape(-1, 3).copy(), float(err.value)


def split_fragments(v0, v1, v2, budget: float = 1.3):
    """SBVH-style spatial splits: the largest triangles diced into
    axis-plane-clipped fragments, up to ``budget``×N → (frag_tri [M] int32,
    the fragment's triangle; frag_min / frag_max [M, 3] f32, the clipped
    boxes). Fragments keep their triangle's vertices, so hits do not change."""
    lib = get_lib()
    n = len(v0)
    max_out = int(n * budget)
    frag_tri = np.zeros(max_out, np.int32)
    frag_min = np.zeros((max_out, 3), np.float32)
    frag_max = np.zeros((max_out, 3), np.float32)
    m = lib.rt3_split_fragments(
        np.ascontiguousarray(v0, np.float32), np.ascontiguousarray(v1, np.float32),
        np.ascontiguousarray(v2, np.float32), n, max_out, frag_tri, frag_min, frag_max)
    return frag_tri[:m], frag_min[:m], frag_max[:m]


class BinaryBVH(NamedTuple):
    """Binary BVH over boxes, as numpy (the layout of the reference's
    ``ops/bvh.BVH``)."""

    node_min: np.ndarray  # [2N-1, 3]
    node_max: np.ndarray  # [2N-1, 3]
    node_left: np.ndarray  # [N-1] int32
    node_right: np.ndarray  # [N-1] int32
    leaf_tri: np.ndarray  # [N] int32


def build_sah_bvh(bmin: np.ndarray, bmax: np.ndarray) -> BinaryBVH:
    """Binned-SAH BVH over N ≥ 2 boxes."""
    lib = get_lib()
    n = len(bmin)
    left = np.zeros(n - 1, np.int32)
    right = np.zeros(n - 1, np.int32)
    nmin = np.zeros((2 * n - 1, 3), np.float32)
    nmax = np.zeros((2 * n - 1, 3), np.float32)
    leaf = np.zeros(n, np.int32)
    cnt = lib.rt3_build_sah_bvh(
        np.ascontiguousarray(bmin, np.float32), np.ascontiguousarray(bmax, np.float32),
        n, left, right, nmin, nmax, leaf,
    )
    if cnt != n - 1:
        raise RuntimeError(f"native SAH build emitted {cnt} internal nodes, expected {n - 1}")
    return BinaryBVH(nmin, nmax, left, right, leaf)


def build_clusters(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int, mode: str = "median"):
    """Triangle clustering → (cluster_of [N] int32, cluster count).

    mode "median": recursive centroid-median bisection (balanced, full
    clusters); "sah": binned-SAH split placement (tighter boxes, underfull
    clusters)."""
    lib = get_lib()
    n = len(bmin)
    out = np.zeros(n, np.int32)
    fn = lib.rt3_build_clusters_sah if mode == "sah" else lib.rt3_build_clusters
    cnt = fn(np.ascontiguousarray(bmin, np.float32), np.ascontiguousarray(bmax, np.float32),
             n, leaf_size, out)
    return out, int(cnt)
