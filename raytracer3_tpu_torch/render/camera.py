"""Camera and primary-ray generation (port of
``raytracer3_tpu/render/camera.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raytracer3_tpu_torch.ops import mathx


class Camera(NamedTuple):
    position: torch.Tensor  # [3]
    direction: torch.Tensor  # [3] unit forward
    fov_y: torch.Tensor  # [] radians
    aspect: torch.Tensor  # [] width/height
    near: torch.Tensor  # []
    far: torch.Tensor  # []

    @staticmethod
    def create(position=(0.0, 0.0, -1.0), direction=(0.0, 0.0, 1.0), fov_y_deg=65.0,
               aspect=1920.0 / 1088.0, near=0.1, far=1000.0, *, device) -> "Camera":
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        d = f32(direction)
        return Camera(
            position=f32(position),
            direction=d / torch.linalg.vector_norm(d),
            fov_y=f32(fov_y_deg) * f32(math.pi / 180.0),
            aspect=f32(aspect),
            near=f32(near),
            far=f32(far),
        )

    def basis(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Right-handed camera basis (right, up, forward), world up = +y."""
        fwd = self.direction
        world_up = mathx.const((0.0, 1.0, 0.0), fwd.dtype, fwd.device)
        right = mathx.normalize(mathx.cross(fwd, world_up))
        up = mathx.cross(right, fwd)
        return right, up, fwd


def camera_from_numpy(fields, device) -> Camera:
    """Camera on ``device`` from the reference Camera's fields as numpy
    (``_asdict()`` of the reference NamedTuple works as is)."""
    fields = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    return Camera(**{
        k: torch.as_tensor(np.array(fields[k], np.float32), device=device)
        for k in Camera._fields
    })


def pixel_grid(width: int, height: int, *, device) -> torch.Tensor:
    """Integer pixel coords [H*W, 2] in x-fastest order."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def primary_rays(camera: Camera, width: int, height: int,
                 jitter: Optional[torch.Tensor] = None,
                 pixel_xy: Optional[torch.Tensor] = None):
    """Camera rays through pixel centers (+ optional subpixel jitter in
    [0,1)²). Returns (origins [N,3], directions [N,3])."""
    dev = camera.position.device
    if pixel_xy is None:
        pixel_xy = pixel_grid(width, height, device=dev)
    p = pixel_xy.to(torch.float32)
    offset = 0.5 if jitter is None else jitter
    uv = (p + offset) / mathx.const((float(width), float(height)), torch.float32, dev)
    ndc = uv * 2.0 - 1.0

    right, up, fwd = camera.basis()
    tan_half = torch.tan(camera.fov_y * 0.5)
    # NDC y points down in pixel space → flip.
    d = (
        fwd[None, :]
        + ndc[:, 0:1] * tan_half * camera.aspect * right[None, :]
        - ndc[:, 1:2] * tan_half * up[None, :]
    )
    d = mathx.normalize(d)
    o = camera.position.expand(d.shape)
    return o, d
