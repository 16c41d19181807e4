"""Camera and primary-ray generation (the parts of
``raytracer3_tpu_torch/render/camera.py`` that the benchmark's plain
reference uses, frozen)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtbench.reference import mathx


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


MOVE_SPEED = 10.0  # camera.rs:18, world units a second


def orbit_camera(camera: Camera, yaw_delta, pitch_delta, move_local, dt) -> Camera:
    """Editor camera update, the ``editor_camera`` analog
    (components/camera.rs:127-178): yaw about world +y, pitch about the
    camera's right (held 0.99 away from the poles), and WASD movement in the
    camera's frame at ``MOVE_SPEED``. The deltas, ``move_local`` (3 floats)
    and ``dt`` are host numbers: their sines, cosines and products are
    rounded to float32 on the host, so nothing is copied to the device."""
    f32 = np.float32
    right, up, fwd = camera.basis()
    cy, sy = float(np.cos(f32(yaw_delta))), float(np.sin(f32(yaw_delta)))
    f1 = torch.stack([cy * fwd[0] + sy * fwd[2], fwd[1], -sy * fwd[0] + cy * fwd[2]])
    right1 = mathx.normalize(mathx.cross(f1, mathx.const((0.0, 1.0, 0.0), f1.dtype, f1.device)))
    cp, sp = float(np.cos(f32(pitch_delta))), float(np.sin(f32(pitch_delta)))
    f2 = mathx.normalize(cp * f1 + sp * mathx.cross(right1, f1) * -1.0)
    f2 = mathx.normalize(torch.where(f2[1].abs() > 0.99, f1, f2))
    mx, my, mz = (float(f32(m)) for m in np.asarray(move_local, np.float32).reshape(3))
    delta = (mx * right + my * up + mz * fwd) * float(f32(MOVE_SPEED) * f32(dt))
    return camera._replace(position=camera.position + delta, direction=f2)
