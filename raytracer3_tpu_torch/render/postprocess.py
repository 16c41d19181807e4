"""Postprocess: environment fill for background pixels + AgX tonemap (port of
``raytracer3_tpu/render/postprocess.py``)."""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.ops import mathx, tonemap


def postprocess(light: torch.Tensor, depth=None, view_dirs=None, env_map=None,
                look: str = "punchy") -> torch.Tensor:
    """light [H,W,3] (+ optional depth/env background fill) → display RGB."""
    color = light
    if depth is not None and view_dirs is not None and env_map is not None:
        uv = mathx.direction_to_equirect_uv(view_dirs)
        he, we = env_map.shape[0], env_map.shape[1]
        x = torch.clamp((uv[..., 0] * we).to(torch.int64), 0, we - 1)
        y = torch.clamp((uv[..., 1] * he).to(torch.int64), 0, he - 1)
        sky = env_map[y, x]
        bg = (depth >= mathx.BACKGROUND_DEPTH)[..., None]
        color = torch.where(bg, sky, color)
    return tonemap.agx_tonemap(color, look=look)
