"""World: entity registry over the geometry pool, with a lazily rebuilt
device scene (port of ``raytracer3_tpu/app/world.py``).

Meshes are registered (``add_mesh``, ``add_mesh_data`` for an ingested
glTF), instances spawned with transforms, edited and despawned; ``scene``
flattens the pool into a ``Scene`` on a device when the structure changed,
and ``_host_tris`` hands the real triangles (never the pool's padding) to
the BVH builders. The pool and the glTF/asset modules are the reference's
own numpy-only ``scene/pools``, ``scene/gltf`` and ``scene/assets``.

Not ported yet: the instanced path (``scene_instanced``, ``tlas_backend``,
``set_instance_material``) waits for TLAS instancing (ROADMAP M12), the
async loader (``load_glb_async``, ``update``) for the tail modules (M13);
each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from raytracer3_tpu.scene import pools as pools_mod
from raytracer3_tpu_torch.scene import types as scene_types


@dataclasses.dataclass
class Entity:
    entity_id: int
    instance_id: Optional[int] = None  # pool instance (renderable)
    name: str = ""


def _later(what: str, milestone: str):
    raise NotImplementedError(f"World.{what} is not ported yet (ROADMAP.md {milestone})")


class World:
    def __init__(self):
        self.pool = pools_mod.GeometryPool()
        self._entities: Dict[int, Entity] = {}
        self._next_entity = 0
        # Material table shared across meshes.
        self._materials = dict(base_color=[], emission=[], metallic=[], roughness=[])
        self._built_key = None
        self._scene = None
        self._host_flat = None
        self.env_map: Optional[np.ndarray] = None

    # -- materials -----------------------------------------------------------

    def add_material(self, base_color=(0.8, 0.8, 0.8, 1.0), emission=(0.0, 0.0, 0.0),
                     metallic=0.0, roughness=1.0) -> int:
        self._materials["base_color"].append(np.asarray(base_color, np.float32))
        self._materials["emission"].append(np.asarray(emission, np.float32))
        self._materials["metallic"].append(np.float32(metallic))
        self._materials["roughness"].append(np.float32(roughness))
        return len(self._materials["base_color"]) - 1

    # -- meshes / entities ---------------------------------------------------

    def add_mesh(self, positions, normals, uvs, indices, geo_id, colors=None) -> pools_mod.MeshHandle:
        return self.pool.add_mesh(positions, normals, uvs, indices, geo_id, colors=colors)

    def add_mesh_data(self, md) -> pools_mod.MeshHandle:
        """Register a gltf.MeshData; its material table is appended to the
        world's and geo ids are rebased."""
        base = len(self._materials["base_color"])
        for i in range(len(md.base_color)):
            self.add_material(md.base_color[i], md.emission[i], md.metallic[i], md.roughness[i])
        return self.add_mesh(
            md.positions, md.normals, md.uvs, md.indices, md.geo_id + base, colors=md.colors,
        )

    def spawn(self, mesh: pools_mod.MeshHandle, transform=None, name="") -> Entity:
        iid = self.pool.add_instance(mesh, transform)
        e = Entity(self._next_entity, instance_id=iid, name=name)
        self._entities[e.entity_id] = e
        self._next_entity += 1
        return e

    def set_transform(self, entity: Entity, transform: np.ndarray):
        if entity.instance_id is None:
            raise ValueError(f"entity {entity.entity_id} has no instance")
        self.pool.set_transform(entity.instance_id, transform)

    def despawn(self, entity: Entity):
        if entity.instance_id is not None:
            self.pool.remove_instance(entity.instance_id)
        del self._entities[entity.entity_id]

    # -- device build ----------------------------------------------------------

    @property
    def dirty(self) -> bool:
        return self._built_key is None or self._built_key[0] != self.pool.version

    def scene(self, *, device) -> scene_types.Scene:
        """Scene on ``device``, rebuilt when the structure (or the device)
        changed. The pool's arrays come padded to power-of-two capacity with
        degenerate triangles, as the reference's scene takes them."""
        key = (self.pool.version, torch.device(device))
        if self._built_key != key or self._scene is None:
            flat = self.pool.flatten()
            self._host_flat = flat  # host geometry for BVH builds
            self._scene = scene_types.make_scene(
                positions=flat["positions"],
                normals=flat["normals"],
                uvs=flat["uvs"],
                indices=flat["indices"],
                geo_id=flat["geo_id"],
                base_color=np.stack(self._materials["base_color"]),
                emission=np.stack(self._materials["emission"]),
                metallic=np.asarray(self._materials["metallic"]),
                roughness=np.asarray(self._materials["roughness"]),
                env_map=self.env_map,
                colors=flat.get("colors"),
                device=device,
            )
            self._built_key = key
        return self._scene

    def _host_tris(self):
        """Host (v0, v1, v2) of the REAL triangles of the last built scene:
        the pool's degenerate padding never reaches a BVH build."""
        flat = self._host_flat
        pos, idx = flat["positions"], flat["indices"]
        idx = idx[: flat["real_tri_count"]]
        return pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]

    # -- not ported yet ----------------------------------------------------------

    def set_instance_material(self, *args, **kw):
        _later("set_instance_material", "M12 instancing")

    def scene_instanced(self, *args, **kw):
        _later("scene_instanced", "M12 instancing")

    def tlas_backend(self, *args, **kw):
        _later("tlas_backend", "M12 instancing")

    def load_glb_async(self, *args, **kw):
        _later("load_glb_async", "M13 tail modules")

    def update(self, *args, **kw):
        _later("update", "M13 tail modules")
