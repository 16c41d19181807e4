"""The atrium benchmark scene (port of ``atrium_scene``/``atrium_camera``
from ``raytracer3_tpu/scene/procedural.py``). The geometry and the sky are
the reference's own numpy generators (``atrium``, ``sky_equirect``), which
import nothing of JAX."""

from __future__ import annotations

from raytracer3_tpu.scene.procedural import atrium, sky_equirect
from raytracer3_tpu_torch.render.camera import Camera
from raytracer3_tpu_torch.scene import types as scene_types

__all__ = ["atrium", "sky_equirect", "atrium_scene", "atrium_camera"]


def atrium_scene(detail: int = 2, seed: int = 0, with_sky: bool = True,
                 return_host: bool = False, *, device):
    """Atrium as a Scene on ``device`` (+ procedural 256×512 sky). With
    ``return_host=True`` also returns the host numpy (v0, v1, v2) triangle
    vertices for the BVH build."""
    kw = atrium(detail=detail, seed=seed)
    env = sky_equirect(256, 512) if with_sky else None
    scene = scene_types.make_scene(env_map=env, device=device, **kw)
    if return_host:
        pos, idx = kw["positions"], kw["indices"]
        return scene, (pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]])
    return scene


def atrium_camera(aspect: float = 16.0 / 9.0, *, device) -> Camera:
    return Camera.create(
        position=(-10.0, 2.2, 0.0),
        direction=(1.0, 0.08, 0.05),
        fov_y_deg=65.0,
        aspect=aspect,
        device=device,
    )
