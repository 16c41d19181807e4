"""The coherence-sorted launch's IO as hand-written CUDA
(``csrc/sorted_io.cu``): build, binding and the three passes that
``render/wavefront.sort_key_pos_dir``, ``sorted_trace`` and
``sorted_occlusion`` take on a CUDA tensor.

- ``launch_key`` (``launch_key_kernel``): the int32 sort key of each lane
  (``sort_key_pos_dir``), before PyTorch's stable argsort.
- ``launch_in`` (``launch_in_kernel``): the launch's rays (and caps) in the
  sort's order, as the contiguous tensors the launch reads.
- ``launch_out_hit`` / ``launch_out_bits`` (``launch_out_kernel``): the
  launch's ``Hit`` (with the instance id of a two-level trace) or its
  occlusion bits, scattered back to the caller's lane order.

Every output is the plain PyTorch version's to the bit
(tests/test_torch_sorted_io_kernel.py). The library is ``load_kernels()``
(nvcc for sm_90a with ``traverse_kernel.NVCC_FLAGS``, ``--fmad=false``) or,
for the tests, ``load_host_kernels()`` (g++ under ``csrc/host_shim.h``,
every thread in turn, on CPU tensors). A pass refuses tensors of another
device, dtype or shape than it takes; it allocates its outputs with
``torch.empty``, launches on the current stream and reads nothing back,
so a CUDA graph captures it. A pass of the CUDA library counts in
``traverse_kernel.LAUNCHES`` under ``launch_key`` / ``launch_in`` /
``launch_out`` (``SORTED_IO_KEYS``); the host library's count nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

from raytracer3_tpu_torch.ops import traverse_kernel as tk
from raytracer3_tpu_torch.ops.intersect import Hit
from raytracer3_tpu_torch.ops.traverse_kernel import c_arg, c_launch, c_ptr

_SRC = os.path.join(os.path.dirname(tk._SRC), "sorted_io.cu")


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rt3_launch_key.argtypes = [vp, vp, vp, vp, vp, ll, vp, vp]  # pos, dir, alive, lo, hi, n, out key, stream
    lib.rt3_launch_key.restype = ci
    lib.rt3_launch_in.argtypes = [vp, vp, vp, vp, ll, vp, vp, vp, vp]  # perm, o, d, cap, n, out o, d, cap, stream
    lib.rt3_launch_in.restype = ci
    lib.rt3_launch_out.argtypes = [
        vp, ll, vp, vp, vp, vp, vp,  # perm, n, t, uv, prim, inst, bits
        vp, vp, vp, vp, vp,  # out rows, hit, inst, bits, stream
    ]
    lib.rt3_launch_out.restype = ci
    return lib


def load_kernels():
    """``csrc/sorted_io.cu`` built with nvcc for sm_90a at first use and
    bound once."""
    return tk.load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/sorted_io.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (each thread run in turn), for the tests; no
    wavefront call takes it on its own."""
    return tk.load_library(_SRC, _bind, "cpu")


def _device(lib, x: torch.Tensor):
    dev = x.device
    if dev.type != lib.rt3_device_type:
        raise ValueError(f"the {lib.rt3_device_type} build of csrc/sorted_io.cu cannot take tensors on {dev}")
    return dev


def launch_key(lib, pos: torch.Tensor, d: torch.Tensor, alive: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """The sort key int32 [N] of lanes at ``pos`` [N, 3] heading ``d`` [N, 3]
    (float32), ``alive`` [N] (bool), within the bounds ``lo`` / ``hi``
    (float32 [3] on the lanes' device)."""
    dev = _device(lib, pos)
    n = pos.shape[0]
    pos = c_arg(pos, "pos", (n, 3), torch.float32, dev)
    d = c_arg(d, "d", (n, 3), torch.float32, dev)
    alive = c_arg(alive, "alive", (n,), torch.bool, dev)
    lo = c_arg(lo, "lo", (3,), torch.float32, dev)
    hi = c_arg(hi, "hi", (3,), torch.float32, dev)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        c_launch(lib, "launch_key", dev, c_ptr(pos), c_ptr(d), c_ptr(alive), c_ptr(lo), c_ptr(hi), n, c_ptr(key))
    return key


def _perm(perm, n: int, dev) -> torch.Tensor:
    return c_arg(perm, "perm", (n,), torch.int64, dev)


def launch_in(lib, perm: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor, t_max=None):
    """Slot i of the launch takes lane ``perm[i]`` (int64 [N], a
    permutation) of ``origins`` / ``directions`` [N, 3] and ``t_max`` [N]
    (float32, or None): (origins [N, 3], directions [N, 3], cap [N] or
    None), contiguous, in sorted order."""
    dev = _device(lib, origins)
    n = origins.shape[0]
    perm = _perm(perm, n, dev)
    origins = c_arg(origins, "origins", (n, 3), torch.float32, dev)
    directions = c_arg(directions, "directions", (n, 3), torch.float32, dev)
    cap = None if t_max is None else c_arg(t_max, "t_max", (n,), torch.float32, dev)
    o_s = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_s = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cap_s = None if cap is None else torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        c_launch(lib, "launch_in", dev, c_ptr(perm), c_ptr(origins), c_ptr(directions), c_ptr(cap), n, c_ptr(o_s),
                 c_ptr(d_s), c_ptr(cap_s))
    return o_s, d_s, cap_s


def launch_out_hit(lib, perm: torch.Tensor, h: Hit) -> Hit:
    """The sorted launch's closest hits ``h`` (slot order) in lane order:
    lane ``perm[i]`` takes slot i's t, uv, prim id (as int32) and, where
    ``h.inst`` is set, instance id (as int32); ``hit`` is prim id >= 0.
    t, uv and prim id are columns of one [N, 4] row a lane (prim id's
    int32 bits in the fourth), as the plain version's are of its gather."""
    dev = _device(lib, h.t)
    n = h.t.shape[0]
    perm = _perm(perm, n, dev)
    t = c_arg(h.t, "t", (n,), torch.float32, dev)
    uv = c_arg(h.uv, "uv", (n, 2), torch.float32, dev)
    prim = c_arg(h.prim_id.to(torch.int32), "prim_id", (n,), torch.int32, dev)
    inst = None if h.inst is None else c_arg(h.inst.to(torch.int32), "inst", (n,), torch.int32, dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    rows, hit = empty(n, 4), empty(n, dtype=torch.bool)
    inst_out = None if inst is None else empty(n, dtype=torch.int32)
    if n:
        c_launch(lib, "launch_out", dev, c_ptr(perm), n, c_ptr(t), c_ptr(uv), c_ptr(prim), c_ptr(inst), None,
                 c_ptr(rows), c_ptr(hit), c_ptr(inst_out), None)
    return Hit(t=rows[:, 0], uv=rows[:, 1:3], prim_id=rows.view(torch.int32)[:, 3], hit=hit, inst=inst_out)


def launch_out_bits(lib, perm: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The sorted any-hit launch's bits (bool [N], slot order) in lane
    order: lane ``perm[i]`` takes ``bits[i]``."""
    dev = _device(lib, bits)
    n = bits.shape[0]
    perm = _perm(perm, n, dev)
    bits = c_arg(bits, "bits", (n,), torch.bool, dev)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        c_launch(lib, "launch_out", dev, c_ptr(perm), n, None, None, None, None, c_ptr(bits), None, None, None,
                 c_ptr(out))
    return out
