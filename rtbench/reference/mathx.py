"""Math and sampling primitives on tensors with arbitrary leading batch dims
(the parts of ``raytracer3_tpu_torch/ops/mathx.py`` that the benchmark's
plain reference uses, frozen; the last axis holds vector components).

Three-component reductions (``dot``, ``to_world``, ``to_local``) are written
out left to right, the order XLA's CPU reduction uses, so that float results
agree with the reference to the last bit wherever the ops themselves do.
"""

from __future__ import annotations

import functools

import torch

TAU = 6.283185307179586476925286766559
PI = 3.141592653589793238462643383279
INV_PI = 0.3183098861837906715377675267450
# Sentinel depth for "ray missed everything" (reference
# shaders/include/datatypes.slang:3 BACKGROUND_DEPTH).
BACKGROUND_DEPTH = 100000.0

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tensor, uploaded once per (values, dtype, device). Building
    it per call with ``torch.tensor(..., device=cuda)`` would copy from
    pageable host memory, which waits for the whole stream to drain. Callers
    must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Batched dot product over the trailing (3-component) axis."""
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s.unsqueeze(-1) if keepdims else s


def length(v: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL-style reflect: v - 2*dot(v,n)*n (v points toward the surface)."""
    return v - 2.0 * dot(v, n) * n


def build_orthonormal_basis(n: torch.Tensor) -> torch.Tensor:
    """Branchless Duff et al. ONB. Returns M [..., 3, 3] whose *columns* are
    (b1, b2, n): ``world = M @ local`` maps local +z onto n."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + z)
    b = x * y * a
    b1 = torch.stack([1.0 + s * x * x * a, s * b, -s * x], dim=-1)
    b2 = torch.stack([b, s + y * y * a, -y], dim=-1)
    return torch.stack([b1, b2, n], dim=-1)


def to_world(onb: torch.Tensor, v_local: torch.Tensor) -> torch.Tensor:
    """``onb @ v_local`` per lane (ONB from build_orthonormal_basis)."""
    return (
        onb[..., :, 0] * v_local[..., 0:1]
        + onb[..., :, 1] * v_local[..., 1:2]
        + onb[..., :, 2] * v_local[..., 2:3]
    )


def to_local(onb: torch.Tensor, v_world: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_world` (ONB is orthonormal → transpose)."""
    return (
        onb[..., 0, :] * v_world[..., 0:1]
        + onb[..., 1, :] * v_world[..., 1:2]
        + onb[..., 2, :] * v_world[..., 2:3]
    )


# ---------------------------------------------------------------------------
# Direction sampling (math.slang:53-103)
# ---------------------------------------------------------------------------


def cosine_sample_hemisphere(urand: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction around +z (brdf.slang:57-63)."""
    u, v = urand[..., 0], urand[..., 1]
    phi = u * TAU
    cos_theta = torch.sqrt(torch.clamp_min(1.0 - v, 0.0))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )


# ---------------------------------------------------------------------------
# Equirect mapping (math.slang:6-12)
# ---------------------------------------------------------------------------


def direction_to_equirect_uv(d: torch.Tensor) -> torch.Tensor:
    """Direction → equirectangular UV. d must be normalized."""
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) / TAU
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    return torch.stack([u, v], dim=-1)


def equirect_uv_to_direction(uv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`direction_to_equirect_uv`."""
    phi = (uv[..., 0] - 0.5) * TAU
    theta = (0.5 - uv[..., 1]) * PI
    cos_t = torch.cos(theta)
    return torch.stack(
        [cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi)], dim=-1
    )


# ---------------------------------------------------------------------------
# Morton / Z-curve (math.slang:105-117). Unsigned 32-bit values live in int64
# tensors masked to 32 bits: CPU torch has no uint32 shifts or adds.
# ---------------------------------------------------------------------------


def integer_explode(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of x to even bit positions (math.slang:105-112)."""
    x = x.to(torch.int64) & _M32
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def zcurve_index(xy: torch.Tensor) -> torch.Tensor:
    """2D Morton code (uint32 value in int64) from integer coords [..., 2]."""
    x = integer_explode(xy[..., 0])
    y = integer_explode(xy[..., 1])
    return (x | (y << 1)) & _M32


