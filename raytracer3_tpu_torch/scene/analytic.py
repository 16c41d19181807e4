"""The Cornell box (port of ``raytracer3_tpu/scene/analytic.py``): the small
brute-force scene of the CPU tests and of the import check that the port
never loads JAX."""

from __future__ import annotations

import numpy as np

from raytracer3_tpu_torch.render.camera import Camera
from raytracer3_tpu_torch.scene import types as scene_types


def _quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3, normal -cross(p1-p0, p2-p0)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    n = -np.cross(verts[1] - verts[0], verts[2] - verts[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, normals, uvs, idx


def _box(center, size, yaw=0.0):
    """Axis-aligned box rotated by yaw around +y; returns its 6 quads."""
    cx, cy, cz = center
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    c, s = np.cos(yaw), np.sin(yaw)

    def rot(p):
        x, y, z = p
        return (cx + c * x + s * z, cy + y, cz - s * x + c * z)

    corners = [
        rot((dx * sx, dy * sy, dz * sz))
        for dx, dy, dz in [
            (-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1),
            (-1, 1, -1), (1, 1, -1), (1, 1, 1), (-1, 1, 1),
        ]
    ]
    return [
        (corners[4], corners[5], corners[6], corners[7]),  # top (+y)
        (corners[3], corners[2], corners[1], corners[0]),  # bottom
        (corners[0], corners[1], corners[5], corners[4]),  # -z
        (corners[2], corners[3], corners[7], corners[6]),  # +z
        (corners[1], corners[2], corners[6], corners[5]),  # +x
        (corners[3], corners[0], corners[4], corners[7]),  # -x
    ]


def cornell_box(light_scale: float = 1.0, *, device) -> scene_types.Scene:
    """Classic Cornell box, y-up: [-1,1]×[0,2]×[-1,1], red wall at x=+1,
    green at x=-1, one ceiling area light, two boxes."""
    white, red, green, light = 0, 1, 2, 3
    geoms = [
        (_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)), white),  # floor
        (_quad((-1, 2, 1), (1, 2, 1), (1, 2, -1), (-1, 2, -1)), white),  # ceiling
        (_quad((1, 0, 1), (1, 2, 1), (-1, 2, 1), (-1, 0, 1)), white),  # back
        (_quad((-1, 0, 1), (-1, 2, 1), (-1, 2, -1), (-1, 0, -1)), green),  # x=-1
        (_quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1)), red),  # x=+1
    ]
    e = 0.35
    geoms.append((_quad((-e, 1.98, e), (e, 1.98, e), (e, 1.98, -e), (-e, 1.98, -e)), light))
    for q in _box((-0.38, 0.6, 0.35), (0.55, 1.2, 0.55), yaw=np.deg2rad(18)):
        geoms.append((_quad(*q), white))
    for q in _box((0.42, 0.3, -0.25), (0.55, 0.6, 0.55), yaw=np.deg2rad(-17)):
        geoms.append((_quad(*q), white))

    positions, normals, uvs, indices, geo_id = [], [], [], [], []
    voff = 0
    for (verts, norms, uv, idx), mid in geoms:
        positions.append(verts)
        normals.append(norms)
        uvs.append(uv)
        indices.append(idx + voff)
        geo_id.extend([mid] * len(idx))
        voff += len(verts)

    base_color = np.asarray(
        [[0.73, 0.73, 0.73, 1.0], [0.65, 0.05, 0.05, 1.0],
         [0.12, 0.45, 0.15, 1.0], [0.78, 0.78, 0.78, 1.0]],
        np.float32,
    )
    emission = np.zeros((4, 3), np.float32)
    emission[3] = (15.0 * light_scale) / scene_types.EMISSION_SCALE
    return scene_types.make_scene(
        positions=np.concatenate(positions),
        normals=np.concatenate(normals),
        uvs=np.concatenate(uvs),
        indices=np.concatenate(indices),
        geo_id=np.asarray(geo_id, np.int32),
        base_color=base_color,
        emission=emission,
        metallic=np.zeros(4, np.float32),
        roughness=np.ones(4, np.float32),
        device=device,
    )


def default_camera(*, device) -> Camera:
    """Camera framing the Cornell box."""
    return Camera.create(
        position=(0.0, 1.0, -3.4), direction=(0.0, 0.0, 1.0),
        fov_y_deg=40.0, aspect=1.0, device=device,
    )
