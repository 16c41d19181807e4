"""Spherical harmonics (L2, 9 coefficients) for the probe-GI pipeline (port
of ``raytracer3_tpu/ops/sh.py``; shaders/include/spherical_harmonics.slang).

An SH is a flat [..., 9] tensor (index = row*3+col of the reference's
float3x3). Coefficient order:
  0: Y(0, 0)   1: Y(1,-1)  2: Y(1,0)  3: Y(1,1)
  4: Y(2,-2)   5: Y(2,-1)  6: Y(2,0)  7: Y(2,1)  8: Y(2,2)
"""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.ops import mathx

_C0 = 0.28209479177387814347403972578039
_C1 = 0.48860251190291992158638462283836
_C2 = 1.09254843059207907054338570580268
_C3 = 0.31539156525252000603089369029571
_C4 = 0.54627421529603953527169285290134

PI = 3.14159265358979323846

# Cosine-lobe zonal-harmonic convolution factors per band (A0, A1, A2)
# (spherical_harmonics.slang:72-89).
_COS_LOBE = (PI, 2.0943951023931954923, 2.0943951023931954923, 2.0943951023931954923,
             0.7853981633974483096, 0.7853981633974483096, 0.7853981633974483096,
             0.7853981633974483096, 0.7853981633974483096)


def sh2_evaluate(d: torch.Tensor) -> torch.Tensor:
    """First-order SH basis [..., 4] (spherical_harmonics.slang:19-28)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, _C0), -_C1 * y, _C1 * z, -_C1 * x], dim=-1)


def sh3_evaluate(d: torch.Tensor) -> torch.Tensor:
    """Second-order SH basis [..., 9] (spherical_harmonics.slang:30-46)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [
            torch.full_like(x, _C0),
            -_C1 * y,
            _C1 * z,
            -_C1 * x,
            _C2 * x * y,
            _C2 * y * z,
            _C3 * (3.0 * z * z - 1.0),
            _C2 * x * z,
            _C4 * (x * x - y * y),
        ],
        dim=-1,
    )


def sh_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SH inner product (spherical_harmonics.slang:56-61, 106-109)."""
    return torch.sum(a * b, dim=-1)


def sh3_unproject(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Evaluate a projected function in direction d
    (spherical_harmonics.slang:63-67)."""
    return sh_dot(coeffs, sh3_evaluate(d))


def sh3_transform_cos_lobe(normal: torch.Tensor) -> torch.Tensor:
    """SH basis at ``normal`` convolved with the clamped-cosine lobe
    (spherical_harmonics.slang:72-89)."""
    return sh3_evaluate(normal) * mathx.const(_COS_LOBE, torch.float32, normal.device)


def sh3_unproject_cos_lobe(coeffs_rgb: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Cosine-convolved irradiance lookup (spherical_harmonics.slang:102-110):
    coeffs_rgb [..., 3, 9] at normal [..., 3] → [..., 3]."""
    return torch.sum(coeffs_rgb * sh3_transform_cos_lobe(normal)[..., None, :], dim=-1)


def sh3_project_batch(directions: torch.Tensor, values: torch.Tensor, n_samples: int | None = None) -> torch.Tensor:
    """Project sampled radiance onto SH3 (old/spherical_harmonic_conversion.slang:
    9-33): directions [..., N, 3], values [..., N, C] → [..., C, 9] scaled by
    4π/N (uniform-sphere Monte Carlo)."""
    n = directions.shape[-2] if n_samples is None else n_samples
    basis = sh3_evaluate(directions)
    return torch.einsum("...nk,...nc->...ck", basis, values) * (4.0 * PI / n)
