"""AgX tonemapping (a frozen copy of ``raytracer3_tpu_torch/ops/tonemap.py``; the standard
published AgX constants and sigmoid fit)."""

from __future__ import annotations

import torch

from rtbench.reference import mathx

# Row-major; applied as row-vector * matrix (Slang mul(vec, mat)).
_AGX_MAT = (
    (0.842479062253094, 0.0423282422610123, 0.0423756549057051),
    (0.0784335999999992, 0.878468636469772, 0.0784336),
    (0.0792237451477643, 0.0791661274605434, 0.879142973793104),
)
_AGX_MAT_INV = (
    (1.19687900512017, -0.0528968517574562, -0.0529716355144438),
    (-0.0980208811401368, 1.15190312990417, -0.0980434501171241),
    (-0.0990297440797205, -0.0989611768448433, 1.15107367264116),
)
_MIN_EV = -12.47393
_MAX_EV = 4.026069

_LOOKS = {
    "golden": ((1.0, 0.9, 0.5), (0.8, 0.8, 0.8), 0.8),
    "punchy": ((1.0, 1.0, 1.0), (1.1, 1.1, 1.1), 1.1),
}


def _row_times(val: torch.Tensor, mat) -> torch.Tensor:
    """val [..., 3] @ mat (3×3, float32), summed left to right."""
    m = mathx.const(mat, val.dtype, val.device)
    return val[..., 0:1] * m[0] + val[..., 1:2] * m[1] + val[..., 2:3] * m[2]


def agx_default_contrast_approx(x: torch.Tensor) -> torch.Tensor:
    """6th-order polynomial sigmoid fit (postprocess.slang:13-23)."""
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def agx(val: torch.Tensor) -> torch.Tensor:
    """AgX forward transform (postprocess.slang:25-47)."""
    val = _row_times(val, _AGX_MAT)
    val = torch.clamp(torch.log2(torch.clamp_min(val, 1e-10)), _MIN_EV, _MAX_EV)
    val = (val - _MIN_EV) / (_MAX_EV - _MIN_EV)
    return agx_default_contrast_approx(val)


def agx_eotf(val: torch.Tensor) -> torch.Tensor:
    """Undo the input transform (postprocess.slang:49-61)."""
    return _row_times(val, _AGX_MAT_INV)


def agx_look(val: torch.Tensor, look: str = "punchy") -> torch.Tensor:
    """ASC CDL grade (postprocess.slang:63-88); the reference compiles the
    "punchy" look."""
    lw = mathx.const((0.2126, 0.7152, 0.0722), val.dtype, val.device)
    luma = (val[..., 0] * lw[0] + val[..., 1] * lw[1] + val[..., 2] * lw[2])[..., None]
    slope, power, sat = _LOOKS.get(look, ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), 1.0))
    slope_t = mathx.const(slope, val.dtype, val.device)
    power_t = mathx.const(power, val.dtype, val.device)
    val = torch.pow(torch.clamp_min(val * slope_t, 0.0), power_t)
    return luma + sat * (val - luma)


def agx_tonemap(color: torch.Tensor, look: str = "punchy") -> torch.Tensor:
    """Full AgX pipeline per pixel (postprocess.slang:107-109)."""
    return agx_eotf(agx_look(agx(color), look))
