"""ctypes bindings for the native BVH-build library (``native/rt3native.cpp``),
the port's own copy of ``raytracer3_tpu/native.py`` for the entry points the
port calls: the SAH triangle clustering and the binned-SAH BVH over boxes.

The library is compiled with g++ at first use into ``build/native/`` (keyed
on a hash of the source and flags, so an edited source rebuilds) and loaded
with ctypes. It is never shared with the JAX package's build. Without g++ or
a loadable library ``get_lib`` raises: the reference's numpy and Morton
fallbacks give other trees, and the port's tables must equal the
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
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
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
