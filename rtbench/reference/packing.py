"""rgb9e5 packing (a frozen copy of the codec in
``raytracer3_tpu_torch/ops/packing.py`` for the benchmark's plain
reference): the sky lookups quantise radiance through it, and the lane diet
rounds the colour state of a wavefront through it at every launch.

Packed words are uint32 values held in int64 tensors: CPU torch has no
uint32 shifts."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_RGB9E5_EXP_BIAS = 15
_RGB9E5_MANT_BITS = 9
_RGB9E5_MAX_EXP = 31 - _RGB9E5_EXP_BIAS
_RGB9E5_MANT_VALUES = 1 << _RGB9E5_MANT_BITS
_MAX_RGB9E5_MANT = _RGB9E5_MANT_VALUES - 1
MAX_RGB9E5 = float(_MAX_RGB9E5_MANT) / _RGB9E5_MANT_VALUES * (1 << _RGB9E5_MAX_EXP)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits & 0x7F800000) >> 23) - 127


def pack_rgb9e5(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] non-negative float → [...] packed words (int64)."""
    c = torch.clamp(rgb, 0.0, MAX_RGB9E5)
    maxrgb = torch.amax(c, dim=-1)
    exp_shared = (
        torch.clamp_min(_floor_log2(maxrgb), -_RGB9E5_EXP_BIAS - 1) + 1 + _RGB9E5_EXP_BIAS
    )
    denom = torch.exp2((exp_shared - _RGB9E5_EXP_BIAS - _RGB9E5_MANT_BITS).to(torch.float32))
    maxm = torch.floor(maxrgb / denom + 0.5).to(torch.int32)
    bump = maxm == (_MAX_RGB9E5_MANT + 1)
    denom = torch.where(bump, denom * 2.0, denom)
    exp_shared = torch.where(bump, exp_shared + 1, exp_shared)
    m = torch.floor(c / denom[..., None] + 0.5).to(torch.int64)
    return (
        (m[..., 0] << (32 - 9))
        | (m[..., 1] << (32 - 18))
        | (m[..., 2] << (32 - 27))
        | exp_shared.to(torch.int64)
    ) & _M32


def unpack_rgb9e5(v: torch.Tensor) -> torch.Tensor:
    """Packed words → [..., 3] float32."""
    v = v.to(torch.int64) & _M32
    exponent = (v & 0x1F) - _RGB9E5_EXP_BIAS - _RGB9E5_MANT_BITS
    scale = torch.exp2(exponent.to(torch.float32))
    mask = _MAX_RGB9E5_MANT
    return torch.stack(
        [
            ((v >> (32 - 9)) & mask).to(torch.float32),
            ((v >> (32 - 18)) & mask).to(torch.float32),
            ((v >> (32 - 27)) & mask).to(torch.float32),
        ],
        dim=-1,
    ) * scale[..., None]
