"""The treelet driver's work around each K3 launch as hand-written CUDA
(``csrc/treelet_driver.cu``): build, binding and the two passes of
``treelets.treelet_intersect`` on a CUDA tensor.

- ``key_pass`` (``treelet_key_kernel``): before the sort, one thread a
  padded ray: its cap (the scene-exit cap under ``step_cull``) and, for a
  sorted launch, the sort key and nearest treelet (``treelets._prepare``'s
  work but the argsort, which stays PyTorch's).
- ``meta_pass`` (``treelet_meta_kernel`` over the ray groups, then
  ``treelet_meta_finish_kernel`` over the segments): after the sort, the
  rays K3 reads in sorted order (gathered by the order and padded) and the
  segment metadata (``treelets._seg_reduce`` and ``segment_metadata``).

``treelets.treelet_intersect``, and each round of
``treelets.treelet_intersect_rounds`` (the metadata pass), take the nvcc
build on every CUDA tensor.

Every output is the plain PyTorch driver's to the bit
(tests/test_torch_treelet_driver_kernel.py). The library is
``load_kernels()`` (nvcc for sm_90a with ``traverse_kernel.NVCC_FLAGS``,
``--fmad=false``) or, for the tests, ``load_host_kernels()`` (g++ under
``csrc/host_shim.h``, every block in turn, on CPU tensors). A pass refuses
tensors of another device, dtype or shape than it takes, and more treelets
or groups than the kernels hold; it allocates its outputs with
``torch.empty``, launches on the current stream and reads nothing back, so
a CUDA graph captures it. A pass of the CUDA library counts in
``traverse_kernel.LAUNCHES`` under ``treelet_key`` / ``treelet_meta``
(``TREELET_DRIVER_KEYS``); the host library's count nothing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from raytracer3_tpu_torch.ops import traverse_kernel as tk
from raytracer3_tpu_torch.ops.traverse_kernel import c_arg, c_launch, c_ptr

_SRC = os.path.join(os.path.dirname(tk._SRC), "treelet_driver.cu")
MAX_TREELETS = 256  # kMaxTreelets in csrc/treelet_driver.cu
MAX_GROUPS = 1024  # 32 mask words (kMaxWords)
# The plain driver's nudges, rounded to float32 as PyTorch rounds a Python
# number against a float32 tensor.
_EXIT_SCALE, _EXIT_PAD = float(np.float32(1.0 + 1e-4)), float(np.float32(1e-5))
_ENTRY_SCALE, _ENTRY_PAD = float(np.float32(1.0 - 1e-4)), float(np.float32(1e-5))


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rt3_treelet_key.argtypes = [
        vp, vp, vp, cf, ll, ll,  # origins, directions, t_cap or null, the scalar cap, n, n_pad
        vp, ci, cf, ci, cf, cf,  # aabb, k, t_min, step_cull, exit scale, exit pad
        vp, vp, vp, vp,  # out cap, key or null, tid or null, stream
    ]
    lib.rt3_treelet_key.restype = ci
    lib.rt3_treelet_meta.argtypes = [
        vp, vp, ll, vp, vp, vp, vp, ci, ll,  # origins, directions, n_src, cap, any-hit flags, order, tid, mode, n_pad
        vp, ci, cf, ci, ci, ci, ci, cf, cf,  # aabb, k, t_min, segment rays, group rays, words, e_limit, entry nudges
        vp, vp, vp, vp, vp, vp,  # out origins, directions, cap, ah (or all null), scratch g_tn, g_want
        vp, vp, vp, vp,  # out seg_list, seg_entry, seg_gmask, stream
    ]
    lib.rt3_treelet_meta.restype = ci
    return lib


def load_kernels():
    """``csrc/treelet_driver.cu`` built with nvcc for sm_90a at first use and
    bound once."""
    return tk.load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/treelet_driver.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (each block run by one thread, in turn), for the
    tests; ``treelet_intersect`` never takes it."""
    return tk.load_library(_SRC, _bind, "cpu")


def _boxes(lib, aabb: torch.Tensor, dev) -> tuple:
    if dev.type != lib.rt3_device_type:
        raise ValueError(f"the {lib.rt3_device_type} build of csrc/treelet_driver.cu cannot take tensors on {dev}")
    if aabb.dim() != 2 or not 1 <= aabb.shape[0] <= MAX_TREELETS or aabb.shape[1] != 8:
        raise ValueError(f"aabb must be [K, 8] with 1 <= K <= {MAX_TREELETS}, got {list(aabb.shape)}")
    return c_arg(aabb, "aabb", aabb.shape, torch.float32, dev), aabb.shape[0]


def key_pass(lib, aabb: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor, t_max, *, p: int,
             t_min: float, step_cull: bool, sort: bool, nearest_tid: bool = False):
    """Rays [N, 3] (float32) padded to whole segments of ``p``, with caps
    ``t_max`` (a number, or float32 [N]; 0 on pad lanes): (cap [N_pad] f32,
    key [N_pad] int32 or None, tid [N_pad] int32 or None). The key and,
    with ``nearest_tid``, the nearest treelet (K where none) come with
    ``sort``."""
    dev = origins.device
    aabb, k = _boxes(lib, aabb, dev)
    n = origins.shape[0]
    origins = c_arg(origins, "origins", (n, 3), torch.float32, dev)
    directions = c_arg(directions, "directions", (n, 3), torch.float32, dev)
    per_ray = isinstance(t_max, torch.Tensor) and t_max.ndim > 0
    t_cap = c_arg(t_max.to(torch.float32), "t_max", (n,), torch.float32, dev) if per_ray else None
    n_pad = -(-n // p) * p
    cap = torch.empty((n_pad,), dtype=torch.float32, device=dev)
    key = torch.empty((n_pad,), dtype=torch.int32, device=dev) if sort else None
    tid = torch.empty((n_pad,), dtype=torch.int32, device=dev) if sort and nearest_tid else None
    if n_pad:
        c_launch(lib, "treelet_key", dev, c_ptr(origins), c_ptr(directions), c_ptr(t_cap),
                 0.0 if per_ray else float(t_max), n, n_pad, c_ptr(aabb), k, float(t_min), int(step_cull),
                 _EXIT_SCALE, _EXIT_PAD, c_ptr(cap), c_ptr(key), c_ptr(tid))
    return cap, key, tid


def meta_pass(lib, aabb: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor, cap: torch.Tensor,
              anyhit=None, order=None, *, p: int, group_rays: int, n_words: int, t_min: float, only_tid=None,
              exclude_tid=None, e_cap=None):
    """The sorted launch's rays and segment metadata. Slot i of the
    N_pad = ``cap.shape[0]`` slots takes ray ``order[i]`` (int64 [N_pad];
    without an order, ray i) of the caller's rays [N, 3] (pad lanes from N
    on), its cap ``cap[order[i]]`` and any-hit flag (``anyhit`` [N], as
    float32, or None) and, with ``only_tid`` / ``exclude_tid`` (int32
    [N_pad], indexed by slot), keeps only / drops that treelet.
    Returns (origins, directions [N_pad, 3], cap [N_pad], anyhit row
    [N_pad] f32 or None, seg_list [S, K] int32, seg_entry [S, K] f32,
    seg_gmask [S, K, n_words] int32); without an order and with N = N_pad
    the rays come back as they were given."""
    dev = origins.device
    aabb, k = _boxes(lib, aabb, dev)
    n, n_pad = origins.shape[0], cap.shape[0]
    groups = p // group_rays
    if p % group_rays or n_pad % p or n > n_pad or n_words != (groups + 31) // 32 or groups > MAX_GROUPS:
        raise ValueError(f"{n_pad} slots do not make segments of {p} rays in groups of {group_rays} ({n_words} mask "
                         f"words, at most {MAX_GROUPS} groups) over {n} rays")
    if only_tid is not None and exclude_tid is not None:
        raise ValueError("only_tid and exclude_tid exclude each other")
    origins = c_arg(origins, "origins", (n, 3), torch.float32, dev)
    directions = c_arg(directions, "directions", (n, 3), torch.float32, dev)
    cap = c_arg(cap, "cap", (n_pad,), torch.float32, dev)
    ah = None if anyhit is None else c_arg(anyhit, "anyhit", (n,), anyhit.dtype, dev).to(torch.float32)
    if order is not None:
        order = c_arg(order, "order", (n_pad,), torch.int64, dev)
    tid, mode = (only_tid, 1) if only_tid is not None else (exclude_tid, 2) if exclude_tid is not None else (None, 0)
    if tid is not None:
        tid = c_arg(tid, "only_tid" if mode == 1 else "exclude_tid", (n_pad,), torch.int32, dev)
    e_limit = k if e_cap is None else sum(1 for e in range(k) if e < float(e_cap))

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    s_count = n_pad // p
    seg_list, seg_entry, seg_gmask = empty(s_count, k, dtype=torch.int32), empty(s_count, k), \
        empty(s_count, k, n_words, dtype=torch.int32)
    if order is None and n == n_pad:
        o_s, d_s, cap_s, ah_s = origins, directions, cap, ah
        outs = (None, None, None, None)
    else:
        o_s, d_s, cap_s = empty(n_pad, 3), empty(n_pad, 3), empty(n_pad)
        ah_s = None if ah is None else empty(n_pad)
        outs = (o_s, d_s, cap_s, ah_s)
    if n_pad:
        g_tn, g_want = empty(n_pad // group_rays, k), empty(n_pad // group_rays, k, dtype=torch.uint8)
        c_launch(lib, "treelet_meta", dev, c_ptr(origins), c_ptr(directions), n, c_ptr(cap), c_ptr(ah),
                 c_ptr(order), c_ptr(tid), mode, n_pad, c_ptr(aabb), k, float(t_min), p, group_rays, n_words, e_limit,
                 _ENTRY_SCALE, _ENTRY_PAD, *(c_ptr(x) for x in outs), c_ptr(g_tn), c_ptr(g_want), c_ptr(seg_list),
                 c_ptr(seg_entry), c_ptr(seg_gmask))
    return o_s, d_s, cap_s, ah_s, seg_list, seg_entry, seg_gmask
