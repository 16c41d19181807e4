"""Edge-aware à-trous wavelet denoiser for low-sample progressive frames
(port of ``raytracer3_tpu/render/denoise.py``).

The 5×5 B3-spline kernel of Dammertz et al. ("Edge-Avoiding À-Trous Wavelet
Transform for Fast Global Illumination Filtering") applied with doubling tap
spacing, weighted by G-buffer edge-stopping functions (normal, relative
depth, luminance) so that lighting blurs and geometry stays sharp. Each tap
is a ``torch.roll`` of the whole image, as the reference's ``jnp.roll``:
the borders wrap. Plain PyTorch; the reference computes it outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.ops import mathx

# B3-spline 1D weights; the 5x5 kernel is the outer product.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_filter(color: torch.Tensor, depth: torch.Tensor, normal: torch.Tensor, iterations: int = 3,
                  sigma_color: float = 0.25, sigma_normal: float = 64.0, sigma_depth: float = 0.05) -> torch.Tensor:
    """Edge-aware smoothing of ``color`` [H, W, 3] with the primary hits'
    ``depth`` [H, W] (background depth for sky) and ``normal`` [H, W, 3];
    sky pixels pass through untouched. sigma_normal is the exponent on the
    clamped normal dot (higher = harder normal edges); sigma_depth is
    relative to the center depth (scale-free)."""
    sky = depth >= mathx.BACKGROUND_DEPTH
    lum_w = mathx.const((0.2126, 0.7152, 0.0722), color.dtype, color.device)
    out = color
    for it in range(iterations):
        step = 1 << it
        lum_c = torch.sum(out * lum_w, dim=-1)
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                h = _B3[dy + 2] * _B3[dx + 2]
                shift = (dy * step, dx * step)
                sc = torch.roll(out, shift, dims=(0, 1))
                sd = torch.roll(depth, shift, dims=(0, 1))
                sn = torch.roll(normal, shift, dims=(0, 1))
                sl = torch.roll(lum_c, shift, dims=(0, 1))
                w_n = torch.clamp_min(torch.sum(normal * sn, dim=-1), 0.0) ** sigma_normal
                w_d = torch.exp(-torch.abs(depth - sd) / (sigma_depth * torch.clamp_min(depth, 1e-3)))
                w_l = torch.exp(-torch.abs(lum_c - sl) / sigma_color)
                # Never pull sky radiance onto geometry (or vice versa).
                s_sky = torch.roll(sky, shift, dims=(0, 1))
                w = h * w_n * w_d * w_l * (~s_sky) * (~sky)
                acc = acc + sc * w[..., None]
                wsum = wsum + w
        filtered = acc / torch.clamp_min(wsum, 1e-8)[..., None]
        out = torch.where((wsum > 1e-8)[..., None], filtered, out)
    return torch.where(sky[..., None], color, out)


def denoise_strength(frame_count, full_until: float = 4.0, off_at: float = 64.0) -> torch.Tensor:
    """Blend weight for the filtered film: 1.0 while accumulation is
    shallow, falling linearly to 0 at ``off_at`` frames as Monte-Carlo
    convergence overtakes the filter. ``frame_count`` is a number or a
    0-dim tensor (left on its device)."""
    n = torch.as_tensor(frame_count, dtype=torch.float32)
    t = (n - full_until) / max(off_at - full_until, 1e-6)
    return torch.clamp(1.0 - t, 0.0, 1.0)
