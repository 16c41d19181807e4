"""The Cornell box (port of ``raytracer3_tpu/scene/analytic.py``): the small
brute-force scene of the CPU tests and of the import check that the port
never loads JAX. Also the two textured scenes of the reference's goldens
(``tools/regen_goldens.py``: ``textured`` and ``textured_mip``)."""

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


def textured_floor(mip: bool, *, device):
    """The textured goldens' scene, camera and settings (``tools/
    regen_goldens.py``): a checker-textured floor quad under a small
    emissive quad, 4 triangles. ``mip=False``: the 2×2 floor, uvs tiled to
    4, a 16×16 checker in the legacy texture array, rendered by the
    reference-mode tracer (``textured_64_8f.npy``). ``mip=True``: the
    16×16 floor, uvs tiled to 32, a 32×32 checker in the mip atlas, traced
    by the wavefront with a ray cone of 0.015 (``textured_mip_64_8f.npy``).
    Both goldens are the mean of frames 0-7 at 64×64."""
    from raytracer3_tpu_torch.utils.config import RenderSettings

    e, t, n, k = (8.0, 32, 32, 4) if mip else (1.0, 4, 16, 2)  # half size, uv tiling, texels, checker cell
    positions = np.asarray(
        [[-e, 0, -e], [e, 0, -e], [e, 0, e], [-e, 0, e],
         [-0.4, 1.5, -0.4], [0.4, 1.5, -0.4], [0.4, 1.5, 0.4], [-0.4, 1.5, 0.4]], np.float32)
    normals = np.asarray([[0, 1, 0]] * 4 + [[0, -1, 0]] * 4, np.float32)
    uvs = np.asarray([[0, 0], [t, 0], [t, t], [0, t], [0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.asarray([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6]], np.int32)
    cx, cy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((cx // k + cy // k) % 2).astype(np.float32)
    tex = np.stack([checker, 0.3 + 0.4 * checker, 1.0 - checker], axis=-1)
    emit = (2.0, 1.9, 1.8) if mip else (1.0, 0.95, 0.9)
    scene = scene_types.make_scene(
        positions=positions, normals=normals, uvs=uvs, indices=indices, geo_id=np.asarray([0, 0, 1, 1], np.int32),
        base_color=np.ones((2, 4), np.float32), emission=np.asarray([[0, 0, 0], emit], np.float32),
        metallic=np.zeros(2, np.float32), roughness=np.asarray([0.9, 1.0], np.float32),
        base_color_texture=np.asarray([0, -1], np.int32),
        **(dict(tex_images=[tex]) if mip else dict(textures=tex[None])), device=device)
    if mip:
        cam = Camera.create(position=(0.0, 0.6, -7.5), direction=(0.0, -0.12, 1.0), fov_y_deg=55.0, aspect=1.0,
                            device=device)
        settings = RenderSettings(width=64, height=64, bounces=2, samples=1, tex_cone_angle=0.015)
    else:
        cam = Camera.create(position=(0.0, 1.2, -2.6), direction=(0.0, -0.3, 1.0), fov_y_deg=55.0, aspect=1.0,
                            device=device)
        settings = RenderSettings(width=64, height=64, bounces=2, samples=1)
    return scene, cam, settings
