"""The wavefront's shade pass as hand-written CUDA (``csrc/shade.cu``):
build, binding and one launch of each form, on the tensors of a
``wavefront.RayQueue``.

``render/wavefront._shade`` takes these where ``covers`` says the kernel
covers the scene (a CUDA device, shade and material rows, no texture atlas
or array); every other scene, and every CPU run, keeps its PyTorch path,
which is the kernel's plain version. Three forms (``FORMS``): ``deferred``
(a whole bounce in one pass, its shadow batch left to the next launch),
``split_a`` (before the bounce's own shadow launch: the emissive pickup and
the shadow batch) and ``split_b`` (after it: NEE's add, the BRDF sample and
Russian roulette). NEE's branch (``NEE_AREA``, ``NEE_ENV``, ``NEE_MIX``) is
fixed by the scene, as ``pathtracer._nee_prepare`` picks it.

``launch`` takes the library (``load_kernels()``: nvcc for sm_90a with
``traverse_kernel.NVCC_FLAGS``, ``--fmad=false``; or, for the tests,
``load_host_kernels()``: g++ under ``csrc/host_shim.h``, every thread in
turn, on CPU tensors) and refuses tensors of another device, dtype or
layout than it is built for. It allocates its outputs with ``torch.empty``,
launches on the current stream and reads nothing back, so a CUDA graph
captures it. A launch of the CUDA library counts in
``traverse_kernel.LAUNCHES`` under ``shade_<form>`` (``SHADE_KEYS``), so a
replayed graph adds its launches too; the host library's count nothing.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import traverse_kernel as tk

_SRC = os.path.join(os.path.dirname(tk._SRC), "shade.cu")
FORMS = {"deferred": 0, "split_a": 1, "split_b": 2}
NEE_NONE, NEE_AREA, NEE_ENV, NEE_MIX = 0, 1, 2, 3

_vp, _ll, _ci, _cf, _cu = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_uint

_QUEUE = ("origin", "direction", "throughput", "radiance", "alive", "prev_pdf", "depth", "prim_id", "uv", "inst",
          "seed")
# Each queue column's columns (0: [N]) and dtype.
_LAYOUT = {"origin": (3, torch.float32), "direction": (3, torch.float32), "throughput": (3, torch.float32),
           "radiance": (3, torch.float32), "alive": (0, torch.bool), "prev_pdf": (0, torch.float32),
           "depth": (0, torch.float32), "prim_id": (0, torch.int32), "uv": (2, torch.float32),
           "inst": (0, torch.int32), "seed": (0, torch.int64)}
_OUTS = ("radiance_out", "hit_pos", "new_dir", "throughput_out", "prev_pdf_out", "alive_out", "shadow_o",
         "shadow_d", "shadow_t", "pre_ok", "contrib")


class _Args(ctypes.Structure):
    """``ShadeArgs`` of csrc/shade.cu, field for field."""

    _fields_ = (
        [(k, _vp) for k in _QUEUE] + [("s_" + k, _ll) for k in _QUEUE]
        + [(k, _vp) for k in ("shade_table", "mat_table", "inst_normal_mats", "inst_mat_table", "light_table",
                              "cdf", "total_area", "env_table")]
        + [(k, _ll) for k in ("n_tris", "n_lights", "n_env")]
        + [(k, _ci) for k in ("shade_row", "mat_row", "light_row", "env_row", "inst_mat_row", "env_h", "env_w")]
        + [(k, _vp) for k in ("radiance_a", "contrib_a", "pre_ok_a", "blocked")] + [("s_blocked", _ll)]
        + [(k, _vp) for k in _OUTS] + [("n", _ll), ("index", _cu)]
        + [(k, _ci) for k in ("emit_mis", "diffuse_only", "roulette", "diet")]
        + [(k, _cf) for k in ("q_env", "one_minus_q_env", "nee_rr_threshold", "mean_factor")]
    )


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    lib.rt3_shade.argtypes = [_ci, _ci, ctypes.POINTER(_Args), _vp]  # form, NEE branch, arguments, stream
    lib.rt3_shade.restype = _ci
    lib.rt3_shade_args_size.argtypes = []
    lib.rt3_shade_args_size.restype = _ci
    if lib.rt3_shade_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/shade.cu's ShadeArgs is {lib.rt3_shade_args_size()} bytes; the wrapper's mirror "
                           f"{ctypes.sizeof(_Args)}")
    return lib


def load_kernels():
    """``csrc/shade.cu`` built with nvcc for sm_90a at first use and bound
    once."""
    return tk.load_library(_SRC, _bind)


def load_host_kernels():
    """``csrc/shade.cu`` built for the CPU with g++ under
    ``csrc/host_shim.h`` (every thread of a launch run in turn), for the
    tests; ``_shade`` never takes it."""
    return tk.load_library(_SRC, _bind, "cpu")


def covers(scene, device) -> bool:
    """Whether ``_shade`` takes the kernel: a CUDA device and a scene whose
    surface the kernel computes (shade and material rows, no texture)."""
    return (torch.device(device).type == "cuda" and scene.shade_table is not None and scene.mat_table is not None
            and scene.tex_atlas is None and scene.textures is None)


def nee_mode(scene, use_nee: bool, q_env: float) -> int:
    """NEE's branch, as ``pathtracer._nee_prepare`` picks it."""
    if not use_nee:
        return NEE_NONE
    has_area = int(scene.emissive.tri_ids.shape[0]) > 0
    if not has_area:
        return NEE_ENV
    return NEE_MIX if q_env > 0.0 else NEE_AREA


def nee_draws(mode: int, settings) -> int:
    """The sampler draws NEE takes: u_l, the env and mixture's pick, the
    shadow-ray roulette."""
    if mode == NEE_NONE:
        return 0
    return 3 + (4 if mode in (NEE_ENV, NEE_MIX) else 0) + (1 if settings.nee_rr_threshold > 0.0 else 0)


def brdf_draws(settings) -> int:
    """The BRDF sample's draws and Russian roulette's one."""
    return (2 if settings.diffuse_only else 3) + 1


class Pass(NamedTuple):
    """One launch's outputs (None where its form writes none)."""

    radiance: torch.Tensor  # [N, 3] f32, or int32 rgb9e5 words [N] (split_a under the diet)
    hit_pos: Optional[torch.Tensor] = None
    new_dir: Optional[torch.Tensor] = None
    throughput: Optional[torch.Tensor] = None
    prev_pdf: Optional[torch.Tensor] = None
    alive: Optional[torch.Tensor] = None
    shadow_o: Optional[torch.Tensor] = None
    shadow_d: Optional[torch.Tensor] = None
    shadow_t: Optional[torch.Tensor] = None
    pre_ok: Optional[torch.Tensor] = None
    contrib: Optional[torch.Tensor] = None  # [N, 3] f32, or int32 words [N] (split_a under the diet)


def _rows(x: torch.Tensor, name: str, n: int, cols: int, dtype, dev) -> int:
    """The row stride of ``x`` ([n] or [n, cols], rows contiguous; stride 0
    broadcasts one row), after checking it; raises on anything else."""
    shape = (n,) if cols == 0 else (n, cols)
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
        raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}, got {x.dtype} {list(x.shape)} on "
                         f"{x.device}")
    if cols and x.stride(1) != 1:
        raise ValueError(f"{name}'s rows must be contiguous (stride {x.stride()})")
    return x.stride(0)


def _table(x: torch.Tensor, name: str, cols: int, dev) -> torch.Tensor:
    if x is None or x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < cols or not x.is_contiguous() \
            or x.device != dev:
        raise ValueError(f"{name} must be a contiguous float32 table of at least {cols} columns on {dev}")
    return x


def _mean_factor(n: int) -> float:
    """CUDA's torch.mean factor over [n, 3]: outputs over inputs in float."""
    return float(np.float32(n) / np.float32(3 * n))


def launch(lib, form: str, mode: int, scene, q, seed: torch.Tensor, index: int, settings, *, emit_mis: bool,
           roulette: bool, q_env: float, radiance_a=None, contrib_a=None, pre_ok_a=None, blocked=None) -> Pass:
    """One pass of ``form`` over the queue ``q`` (a ``wavefront.RayQueue``),
    the sampler's seeds [N] (int64) and its counter ``index`` at the pass's
    first draw. ``split_b`` also takes ``split_a``'s radiance, contrib and
    pre_ok and the shadow launch's occlusion bits ``blocked`` [N]."""
    dev = q.origin.device
    if dev.type != lib.rt3_device_type:
        raise ValueError(f"the {lib.rt3_device_type} build of csrc/shade.cu cannot take tensors on {dev}")
    if form not in FORMS or (form == "split_a" and mode == NEE_NONE):
        raise ValueError(f"no {form} pass with NEE branch {mode}")
    n = q.origin.shape[0]
    f32, diet = torch.float32, bool(settings.lane_diet) and form == "split_a"
    a = _Args()
    fields = dict(q._asdict(), seed=seed)
    for k in _QUEUE:
        x = fields[k]
        if x is None:
            if k != "inst":
                raise ValueError(f"the queue has no {k}")
            continue
        setattr(a, "s_" + k, _rows(x, k, n, *_LAYOUT[k], dev))
        setattr(a, k, x.data_ptr())

    shade = _table(scene.shade_table, "shade_table", 16, dev)
    mat = _table(scene.mat_table, "mat_table", 12, dev)
    a.shade_table, a.shade_row, a.n_tris = shade.data_ptr(), shade.shape[1], shade.shape[0]
    a.mat_table, a.mat_row = mat.data_ptr(), mat.shape[1]
    if fields["inst"] is not None:
        if scene.inst_normal_mats is not None:
            a.inst_normal_mats = _table(scene.inst_normal_mats, "inst_normal_mats", 9, dev).data_ptr()
        if scene.inst_mat_table is not None:
            imat = _table(scene.inst_mat_table, "inst_mat_table", 12, dev)
            a.inst_mat_table, a.inst_mat_row = imat.data_ptr(), imat.shape[1]
    em = scene.emissive
    if mode != NEE_NONE or (form != "split_b" and emit_mis):
        total = em.total_area
        if total.dtype != f32 or total.numel() != 1 or total.device != dev:
            raise ValueError("emissive.total_area must be a float32 scalar on the queue's device")
        a.total_area = total.data_ptr()
    if mode in (NEE_AREA, NEE_MIX):
        lt = _table(em.light_table, "emissive.light_table", 13, dev)
        cdf = em.cdf
        if cdf.dtype != f32 or cdf.shape != (em.tri_ids.shape[0],) or not cdf.is_contiguous() or cdf.device != dev:
            raise ValueError("emissive.cdf must be contiguous float32 [L] on the queue's device")
        a.light_table, a.light_row, a.cdf, a.n_lights = lt.data_ptr(), lt.shape[1], cdf.data_ptr(), cdf.shape[0]
    if mode in (NEE_ENV, NEE_MIX):
        et = _table(scene.env_sample_table, "env_sample_table", 10, dev)
        a.env_table, a.env_row, a.n_env = et.data_ptr(), et.shape[1], et.shape[0]
        a.env_h, a.env_w = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]

    if form == "split_b":
        cols, dtype = (0, torch.int32) if settings.lane_diet else (3, f32)  # rgb9e5 words under the diet
        for name, x, c, dt in (("radiance_a", radiance_a, cols, dtype), ("contrib_a", contrib_a, cols, dtype),
                               ("pre_ok_a", pre_ok_a, 0, torch.bool)):
            if x is None:
                raise ValueError(f"split_b needs split_a's {name}")
            if _rows(x, name, n, c, dt, dev) != max(c, 1):
                raise ValueError(f"{name} must be contiguous")
            setattr(a, name, x.data_ptr())
        if blocked is None:
            raise ValueError("split_b needs the occlusion bits")
        a.s_blocked = _rows(blocked, "blocked", n, 0, torch.bool, dev)
        a.blocked = blocked.data_ptr()

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {}
    if form == "split_a":
        out["radiance"] = empty(n, dtype=torch.int32) if diet else empty(n, 3)
    else:
        out["radiance"] = empty(n, 3)
        out.update(hit_pos=empty(n, 3), new_dir=empty(n, 3), throughput=empty(n, 3), prev_pdf=empty(n),
                   alive=empty(n, dtype=torch.bool))
    if form != "split_b" and mode != NEE_NONE:
        out.update(shadow_o=empty(n, 3), shadow_d=empty(n, 3), shadow_t=empty(n), pre_ok=empty(n, dtype=torch.bool),
                   contrib=empty(n, dtype=torch.int32) if diet else empty(n, 3))
    names = dict(radiance="radiance_out", throughput="throughput_out", prev_pdf="prev_pdf_out", alive="alive_out")
    for k, x in out.items():
        setattr(a, names.get(k, k), x.data_ptr())

    a.n, a.index = n, int(index) & 0xFFFFFFFF
    a.emit_mis, a.diffuse_only, a.roulette, a.diet = int(emit_mis), int(settings.diffuse_only), int(roulette), \
        int(settings.lane_diet)
    a.q_env, a.one_minus_q_env = float(q_env), float(1.0 - q_env)
    a.nee_rr_threshold = float(settings.nee_rr_threshold)
    a.mean_factor = _mean_factor(n)
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    rc = lib.rt3_shade(FORMS[form], mode, ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(f"shade_kernel ({form}) launch failed: cudaError {rc}")
    if lib.rt3_device_type == "cuda":
        tk.LAUNCHES["shade_" + form] += 1
    return Pass(**out)
