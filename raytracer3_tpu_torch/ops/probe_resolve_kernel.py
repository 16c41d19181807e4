"""The probe resolve as hand-written CUDA (``csrc/probe_resolve.cu``): build,
binding and the three passes that ``render/probes.sis_packed``,
``project_sh`` and ``interpolate_packed`` take on a CUDA tensor.

- ``sis`` (``probe_sis_kernel``): the G-buffer's normals and each probe's
  direction budget (structured importance sampling).
- ``sh`` (``probe_sh_kernel``): each probe's SH3 coefficients, with
  ``probe_sh_fill``'s mean in the texels never written.
- ``interpolate`` (``probe_interpolate_kernel``): the lit image from the
  four neighbour probes of each pixel.

The SIS's outputs and the interpolation's weights are the plain PyTorch
version's to the bit. The SH coefficients and the light, which the plain
version sums through PyTorch's reductions in the library's own order, are
held instead to the plain formula evaluated exactly (in float64, from the
same float32 inputs): within ``sh_bound(R)`` and ``LIGHT_BOUND`` of the sum
of their terms' magnitudes, the worst case of the kernels' own roundings
(tests/test_torch_probe_resolve_kernel.py, chip_smoke.py).
The library is ``load_kernels()`` (nvcc for sm_90a with
``traverse_kernel.NVCC_FLAGS``, ``--fmad=false``) or, for the tests,
``load_host_kernels()`` (g++ under ``csrc/host_shim.h``, every thread in
turn, on CPU tensors). The kernels
take a probe spacing of at most ``MAX_SPACING`` pixels and at most
``MAX_DIRS`` texels a probe; a pass refuses more, and tensors of another
device, dtype or shape than it takes. It allocates its outputs with
``torch.empty``, launches on the current stream and reads nothing back, so
a CUDA graph captures it. A pass of the CUDA library counts in
``traverse_kernel.LAUNCHES`` under ``probe_sis`` / ``probe_sh`` /
``probe_interpolate`` (``PROBE_RESOLVE_KEYS``); the host library's count
nothing.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from raytracer3_tpu_torch.ops import traverse_kernel as tk
from raytracer3_tpu_torch.ops.traverse_kernel import c_arg, c_launch, c_ptr

_SRC = os.path.join(os.path.dirname(tk._SRC), "probe_resolve.cu")
MAX_SPACING = 32  # kMaxSpacing: the SIS block holds a tile of at most 32 x 32 pixels
MAX_DIRS = 256  # kMaxDirs: at most 16 x 16 texels a probe
_U = 2.0 ** -24  # float32's unit roundoff


def _gamma(k: int) -> float:
    """The relative error bound of k float32 roundings in a row:
    k·u / (1 - k·u)."""
    return k * _U / (1.0 - k * _U)


def sh_bound(r: int) -> float:
    """The worst |kernel - exact| of an SH coefficient of R x R texels over
    its terms' magnitudes 4π/R²·Σ_d |L_d·Y_d| (a filled texel's L_d counted
    as the magnitude Σ|L| / count of the mean it takes). A term rounds in
    its product (1), in the halving sum's L = ⌈log2 R²⌉ levels and in the
    scale's float32 value and product (2); a filled texel's value carries
    the mean's halving sum and division besides (L + 1): γ(2L + 4), 9.54e-7
    at R = 8."""
    return _gamma(2 * math.ceil(math.log2(r * r)) + 4)


# The worst |kernel - exact| of a light value over albedo²/π·Σ_n w_n·
# Σ_k |c_k·Y_k| + emission (w_n the normalised weights, bit-equal on both
# sides): the 9 products (1) and their halving sum (4), the product by w_n
# (1), the sum over the four neighbours (3), by albedo² (1), by 1/π's
# float32 value (2), the emission's add (1): γ(13), 7.75e-7.
LIGHT_BOUND = _gamma(13)


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt3_probe_sis.argtypes = [vp, ci, ci, ci, ci, ci, ci, ci,  # data, h, w, px, py, sp, r, ncull
                                  vp, vp, vp, vp]  # out normal, dir_index, mip, stream
    lib.rt3_probe_sis.restype = ci
    lib.rt3_probe_sh.argtypes = [vp, vp, ci, ci, ci, ci, cf,  # atlas, depth, px, py, r, fill, scale
                                 vp, vp]  # out, stream
    lib.rt3_probe_sh.restype = ci
    lib.rt3_probe_interpolate.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,  # data, depth, normal, sh, h, w,
                                          vp, vp]  # px, py, sp, emission; out light, stream
    lib.rt3_probe_interpolate.restype = ci
    return lib


def load_kernels():
    """``csrc/probe_resolve.cu`` built with nvcc for sm_90a at first use and
    bound once."""
    return tk.load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/probe_resolve.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (each thread run in turn), for the tests; no probe
    pass takes it on its own."""
    return tk.load_library(_SRC, _bind, "cpu")


def _device(lib, x: torch.Tensor):
    dev = x.device
    if dev.type != lib.rt3_device_type:
        raise ValueError(f"the {lib.rt3_device_type} build of csrc/probe_resolve.cu cannot take tensors on {dev}")
    return dev


def _check_grid(h: int, w: int, probe_grid, sp: int, r: int | None = None) -> None:
    px, py = probe_grid
    if not (1 <= sp <= MAX_SPACING and px >= 1 and py >= 1 and px * sp <= w and py * sp <= h):
        raise ValueError(f"{px}x{py} probes of spacing {sp} on a {w}x{h} frame: the kernels take a spacing of "
                         f"1 to {MAX_SPACING} pixels and a grid inside the frame")
    if r is not None and not 1 <= r * r <= MAX_DIRS:
        raise ValueError(f"probe_res {r}: the kernels take at most {MAX_DIRS} texels a probe")


def sis(lib, data: torch.Tensor, probe_grid, sp: int, r: int, ncull: int):
    """(normal [H, W, 3], dir_index, mip [Py, Px, R·R] int64) of the packed
    G-buffer words ``data`` [H, W, 4] (int64) over ``probe_grid`` = (Px, Py)
    probes of spacing ``sp`` and R x R directions, the ``ncull`` lowest by
    pdf culled."""
    dev = _device(lib, data)
    h, w = data.shape[:2]
    _check_grid(h, w, probe_grid, sp, r)
    px, py = probe_grid
    data = c_arg(data, "data", (h, w, 4), torch.int64, dev)
    normal = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    dir_index = torch.empty((py, px, r * r), dtype=torch.int64, device=dev)
    mip = torch.empty((py, px, r * r), dtype=torch.int64, device=dev)
    c_launch(lib, "probe_sis", dev, c_ptr(data), h, w, px, py, sp, r, ncull, c_ptr(normal), c_ptr(dir_index),
             c_ptr(mip))
    return normal, dir_index, mip


def sh(lib, atlas: torch.Tensor, depth: torch.Tensor, probe_grid, r: int, fill: bool) -> torch.Tensor:
    """SH3 coefficients [Py, Px, 3, 9] of the probe atlas [Py·R, Px·R, 3]
    with its hit depths [Py·R, Px·R] (0: never written), the texels never
    written filled with their probe's mean where ``fill``."""
    dev = _device(lib, atlas)
    px, py = probe_grid
    if not (px >= 1 and py >= 1 and 1 <= r * r <= MAX_DIRS):
        raise ValueError(f"{px}x{py} probes of {r}x{r} texels: the kernels take at most {MAX_DIRS} texels a probe")
    atlas = c_arg(atlas, "atlas", (py * r, px * r, 3), torch.float32, dev)
    depth = c_arg(depth, "depth", (py * r, px * r), torch.float32, dev)
    out = torch.empty((py, px, 3, 9), dtype=torch.float32, device=dev)
    c_launch(lib, "probe_sh", dev, c_ptr(atlas), c_ptr(depth), px, py, r, int(bool(fill)),
             4.0 * math.pi / (r * r), c_ptr(out))
    return out


def interpolate(lib, depth: torch.Tensor, normal: torch.Tensor, data: torch.Tensor, sh_coeffs: torch.Tensor,
                sp: int, emission: bool = True) -> torch.Tensor:
    """The lit image [H, W, 3] of a frame's depth [H, W], normals [H, W, 3]
    and packed words [H, W, 4] (int64; albedo from word 0, emission from
    word 3, or none where ``emission`` is false) from the probes'
    coefficients [Py, Px, 3, 9] at spacing ``sp``."""
    dev = _device(lib, depth)
    h, w = depth.shape
    py, px = sh_coeffs.shape[:2]
    _check_grid(h, w, (px, py), sp)
    depth = c_arg(depth, "depth", (h, w), torch.float32, dev)
    normal = c_arg(normal, "normal", (h, w, 3), torch.float32, dev)
    data = c_arg(data, "data", (h, w, 4), torch.int64, dev)
    sh_coeffs = c_arg(sh_coeffs, "sh_coeffs", (py, px, 3, 9), torch.float32, dev)
    light = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    c_launch(lib, "probe_interpolate", dev, c_ptr(data), c_ptr(depth), c_ptr(normal), c_ptr(sh_coeffs), h, w, px,
             py, sp, int(bool(emission)), c_ptr(light))
    return light
