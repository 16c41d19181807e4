"""The atrium benchmark scenes (port of ``atrium_scene``/``atrium_camera``
from ``raytracer3_tpu/scene/procedural.py`` and of ``bench.sponza_world_scene``).
The geometry and the sky are the reference's own numpy generators
(``atrium``, ``sky_equirect``), and the GLB writer and processed-asset cache
its numpy-only ``scene/gltf`` and ``scene/assets``; none imports JAX."""

from __future__ import annotations

import os

from raytracer3_tpu.scene import assets
from raytracer3_tpu.scene import gltf as gltf_mod
from raytracer3_tpu.scene.procedural import atrium, sky_equirect
from raytracer3_tpu_torch.render.camera import Camera
from raytracer3_tpu_torch.scene import types as scene_types

__all__ = ["atrium", "sky_equirect", "atrium_scene", "atrium_camera", "sponza_world_scene"]


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


def sponza_world_scene(detail: int = 8, *, device, cache_dir=None):
    """The Sponza-scale scene through the real ingest path, as the sponza
    configurations build it: procedural atrium (``detail=8``: 299,508
    triangles) → GLB file → processed-asset cache → ``World`` → (Scene on
    ``device``, host (v0, v1, v2) of the real triangles), with the 256×512
    sky. The GLB and its cache go to ``cache_dir`` (default: the asset
    cache's own directory)."""
    from raytracer3_tpu_torch.app import world as world_mod

    kw = atrium(detail=detail)
    path = os.path.join(assets._cache_dir(cache_dir), f"bench_atrium_d{detail}.glb")
    if not os.path.exists(path):
        gltf_mod.write_glb_multi(
            path, kw["positions"], kw["normals"], kw["uvs"], kw["indices"], kw["geo_id"],
            kw["base_color"], kw["emission"], kw["metallic"], kw["roughness"],
        )
    md = assets.load_glb_cached(path, cache_dir=cache_dir)
    w = world_mod.World()
    w.spawn(w.add_mesh_data(md), name="atrium")
    w.env_map = sky_equirect(256, 512)
    scene = w.scene(device=device)
    return scene, w._host_tris()
