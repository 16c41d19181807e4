"""Bit-packing codecs for the G-buffer, the probes and the environment (port
of ``raytracer3_tpu/ops/packing.py``), bit-equal with the reference.

Packed words are uint32 values held in int64 tensors (see ops/rng.py): CPU
torch has no uint32 shifts. The env lookups quantise radiance through rgb9e5
in the reference (render/pathtracer._sample_env), so the port must too or
images drift; the packed G-buffer (render/gbuffer.py) uses the rest."""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.ops import mathx

_M32 = 0xFFFFFFFF
_RGB9E5_EXP_BIAS = 15
_RGB9E5_MANT_BITS = 9
_RGB9E5_MAX_EXP = 31 - _RGB9E5_EXP_BIAS
_RGB9E5_MANT_VALUES = 1 << _RGB9E5_MANT_BITS
_MAX_RGB9E5_MANT = _RGB9E5_MANT_VALUES - 1
MAX_RGB9E5 = float(_MAX_RGB9E5_MANT) / _RGB9E5_MANT_VALUES * (1 << _RGB9E5_MAX_EXP)


def pack_unorm(val: torch.Tensor, bit_count: int) -> torch.Tensor:
    """Float [0,1] → unsigned normalized integer (packing.slang:7-10)."""
    max_val = (1 << bit_count) - 1
    return (torch.clamp(val, 0.0, 1.0) * max_val + 0.5).to(torch.int64)


def unpack_unorm(pckd: torch.Tensor, bit_count: int) -> torch.Tensor:
    """Inverse of :func:`pack_unorm` (packing.slang:2-5)."""
    max_val = (1 << bit_count) - 1
    return (pckd.to(torch.int64) & max_val).to(torch.float32) / max_val


def pack_normal_11_10_11(n: torch.Tensor) -> torch.Tensor:
    """Unit normal → 11-10-11 unorm word (packing.slang:12-43)."""
    p = pack_unorm(n[..., 0] * 0.5 + 0.5, 11)
    p = p + (pack_unorm(n[..., 1] * 0.5 + 0.5, 10) << 11)
    p = p + (pack_unorm(n[..., 2] * 0.5 + 0.5, 11) << 21)
    return p & _M32


def unpack_normal_11_10_11(p: torch.Tensor, do_normalize: bool = True) -> torch.Tensor:
    p = p.to(torch.int64) & _M32
    n = torch.stack([unpack_unorm(p, 11), unpack_unorm(p >> 11, 10), unpack_unorm(p >> 21, 11)], dim=-1) * 2.0 - 1.0
    return mathx.normalize(n) if do_normalize else n


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded: through float64, since CPU
    torch's float32 ``sqrt`` is off by one ulp on ~0.7% of inputs, which
    moves packed words."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def pack_color_888(color: torch.Tensor) -> torch.Tensor:
    """Colour → 8-8-8 unorm of its square root (packing.slang:46-62)."""
    c = sqrt_rn(torch.clamp_min(color, 0.0))
    return pack_unorm(c[..., 0], 8) + (pack_unorm(c[..., 1], 8) << 8) + (pack_unorm(c[..., 2], 8) << 16)


def unpack_color_888(p: torch.Tensor) -> torch.Tensor:
    p = p.to(torch.int64) & _M32
    c = torch.stack([unpack_unorm(p, 8), unpack_unorm(p >> 8, 8), unpack_unorm(p >> 16, 8)], dim=-1)
    return c * c


def octa_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit direction → octahedral UV in [0,1]² (packing.slang:68-75)."""
    denom = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    v = n / torch.clamp_min(denom[..., None], 1e-20)
    xy = v[..., :2]
    sign_xy = torch.where(xy >= 0.0, 1.0, -1.0)
    wrapped = (1.0 - torch.abs(torch.flip(xy, dims=[-1]))) * sign_xy
    xy = torch.where(v[..., 2:3] < 0.0, wrapped, xy)
    return xy * 0.5 + 0.5


def octa_decode(f: torch.Tensor) -> torch.Tensor:
    """Octahedral UV in [0,1]² → unit direction (packing.slang:77-87)."""
    f = f * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, 0.0, 1.0)
    sign_xy = torch.where(f >= 0.0, 1.0, -1.0)
    xy = f - sign_xy * t[..., None]
    return mathx.normalize(torch.cat([xy, z[..., None]], dim=-1))


def pack_2xf16(f: torch.Tensor) -> torch.Tensor:
    """[..., 2] float → two IEEE halves in one word (packing.slang:89-98)."""
    bits = f.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return bits[..., 0] | (bits[..., 1] << 16)


def _half(bits: torch.Tensor) -> torch.Tensor:
    return (((bits & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16).to(torch.float32)


def unpack_2xf16(u: torch.Tensor) -> torch.Tensor:
    u = u.to(torch.int64) & _M32
    return torch.stack([_half(u), _half(u >> 16)], dim=-1)


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


def prequant_shift_11_11_10(v: torch.Tensor) -> torch.Tensor:
    """Rounding shift before storing to an 11-11-10 float target
    (packing.slang:168-176)."""
    mant = mathx.const((6.0, 6.0, 5.0), v.dtype, v.device)
    exponent = torch.ceil(torch.log2(torch.clamp_min(v, 1e-30)))
    return v + torch.exp2(exponent - mant - 2.0)
