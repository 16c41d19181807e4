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

    def view_matrix(self) -> torch.Tensor:
        """Right-handed look-at (camera.rs:38-44): world → view, camera looks
        down -z in view space."""
        right, up, fwd = self.basis()
        r = torch.stack([right, up, -fwd])  # rows
        m = torch.eye(4, dtype=torch.float32, device=r.device)
        m[:3, :3] = r
        m[:3, 3] = -mathx.dot(r, self.position[None, :], keepdims=False)
        return m

    def projection_matrix(self) -> torch.Tensor:
        """Right-handed perspective, depth 0..1 (camera.rs:46-57)."""
        f = 1.0 / torch.tan(self.fov_y * 0.5)
        n, fa = self.near, self.far
        m = torch.zeros((4, 4), dtype=torch.float32, device=f.device)
        m[0, 0] = f / self.aspect
        m[1, 1] = f
        m[2, 2] = fa / (n - fa)
        m[2, 3] = n * fa / (n - fa)
        m[3, 2] = -1.0
        return m

    def matrices(self):
        """(proj, view, proj_inverse, view_inverse): the four GConst matrices
        (renderer/mod.rs:47-63)."""
        view = self.view_matrix()
        proj = self.projection_matrix()
        return proj, view, torch.linalg.inv(proj), torch.linalg.inv(view)


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
