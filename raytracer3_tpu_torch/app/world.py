"""World: entity registry over the geometry pool, with lazily rebuilt
device scenes (port of ``raytracer3_tpu/app/world.py``).

Meshes are registered (``add_mesh``, ``add_mesh_data`` for an ingested
glTF), instances spawned with transforms, edited and despawned.

- ``scene`` flattens the pool into a world-space ``Scene`` when the
  structure changed; ``_host_tris`` hands its real triangles (never the
  pool's padding) to the BVH builders.
- ``scene_instanced`` and ``tlas_backend`` are the two-level path: the
  geometry and shading tables stay in object space per mesh, each mesh's
  BLAS is built once, and a transform edit (or ``set_instance_material``)
  rebuilds only the TLAS and the small per-instance tables.

- ``load_glb_async`` hands a GLB to a background ``AsyncAssetPipeline``;
  ``update`` (once per frame tick) adds the finished meshes and spawns
  them.
- ``trace_backend`` (a TraceBackend) and ``backend`` (the two trace
  functions) trace the flattened scene: ``auto`` is the packet backend on
  a CUDA device and brute force on the CPU.

The pool is the port's ``scene/pools``. Meshes with COLOR_0 carry their
vertex colours into both scenes. As in the reference, neither scene
carries textures: ``make_scene`` is called without base-colour textures,
so an override row's ``tex_id`` finds no atlas and shades untextured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import tlas as tlas_mod
from raytracer3_tpu_torch.scene import assets as assets_mod
from raytracer3_tpu_torch.scene import pools as pools_mod
from raytracer3_tpu_torch.scene import types as scene_types


@dataclasses.dataclass
class Entity:
    entity_id: int
    instance_id: Optional[int] = None  # pool instance (renderable)
    name: str = ""


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
        # Per-instance material overrides: instance_id → 12-lane mat row,
        # versioned like transforms so scene_instanced refreshes the small
        # tables only.
        self._mat_overrides: Dict[int, np.ndarray] = {}
        self._mat_override_ver = 0
        self._inst_base_key = None  # (structural version, device)
        self._inst_base = None
        self._inst_key = None  # (structural, transform, override versions, device)
        self._inst_scene = None
        self._blas_key = None  # (structural version, build options)
        self._blas_cache = None
        self._tlas_key = None
        self._tlas_backend = None
        self._backend_key = None  # (pool version, kind, device, options)
        self._backend = None
        self._assets = None  # AsyncAssetPipeline, made by the first load_glb_async
        self._async_specs = {}  # ticket → (transform, name)

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

    # -- async asset loading -----------------------------------------------------

    def load_glb_async(self, path: str, transform=None, name="", **kw) -> int:
        """Enqueue a .glb for background processing; ``update`` spawns it
        when the worker has finished. Returns a ticket id."""
        if self._assets is None:
            self._assets = assets_mod.AsyncAssetPipeline()
        t = self._assets.load(path, **kw)
        self._async_specs[t] = (transform, name)
        return t

    def update(self):
        """Integrate finished async assets (call once per frame tick).
        Returns the newly spawned entities."""
        if self._assets is None:
            return []
        spawned = []
        for ticket, md in self._assets.poll():
            transform, name = self._async_specs.pop(ticket)
            spawned.append(self.spawn(self.add_mesh_data(md), transform=transform, name=name))
        return spawned

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
            self._mat_overrides.pop(entity.instance_id, None)
        del self._entities[entity.entity_id]

    def set_instance_material(self, entity: Entity, base_color=None, emission=(0.0, 0.0, 0.0),
                              metallic=0.0, roughness=0.5, tex_id=-1):
        """Override the material of every surface of one instance (the
        shared mesh is untouched); ``base_color=None`` clears the override.
        The next ``scene_instanced`` re-uploads the small per-instance
        tables and rebuilds the light list."""
        if entity.instance_id is None:
            raise ValueError(f"entity {entity.entity_id} has no instance")
        if base_color is None:
            self._mat_overrides.pop(entity.instance_id, None)
        else:
            row = np.zeros(12, np.float32)
            row[0:3] = np.asarray(base_color, np.float32)
            row[3:6] = np.asarray(emission, np.float32) * scene_types.EMISSION_SCALE
            row[6] = metallic
            row[7] = roughness
            row[8] = tex_id
            row[11] = 1.0  # active flag (hit_surface_info gate)
            self._mat_overrides[entity.instance_id] = row
        self._mat_override_ver += 1

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

    # -- instanced (TLAS/BLAS) path --------------------------------------------

    def _mesh_list(self):
        mids = sorted(self.pool._meshes)
        return mids, [self.pool._meshes[m] for m in mids]

    def _instance_list(self, mids):
        mesh_index = {m: i for i, m in enumerate(mids)}
        insts = sorted(self.pool._instances.values(), key=lambda i: i.instance_id)
        return [(mesh_index[i.mesh_id], i.transform) for i in insts]

    def scene_instanced(self, *, device) -> scene_types.Scene:
        """Object-space scene on ``device`` for TLAS tracing: the meshes'
        geometry concatenated once per structure, with per-instance normal
        matrices, override rows and the world-space light list refreshed
        on transform or material edits."""
        device = torch.device(device)
        sv = self.pool.structural_version
        if self._inst_base_key != (sv, device):
            _, meshes = self._mesh_list()
            voff = 0
            idx_parts = []
            for m in meshes:
                idx_parts.append(m["indices"] + voff)
                voff += len(m["positions"])
            colors = None
            if any("colors" in m for m in meshes):
                colors = np.concatenate(
                    [m.get("colors", np.ones((len(m["positions"]), 3), np.float32)) for m in meshes])
            self._inst_base = scene_types.make_scene(
                positions=np.concatenate([m["positions"] for m in meshes]),
                normals=np.concatenate([m["normals"] for m in meshes]),
                uvs=np.concatenate([m["uvs"] for m in meshes]),
                indices=np.concatenate(idx_parts),
                geo_id=np.concatenate([m["geo_id"] for m in meshes]),
                base_color=np.stack(self._materials["base_color"]),
                emission=np.stack(self._materials["emission"]),
                metallic=np.asarray(self._materials["metallic"]),
                roughness=np.asarray(self._materials["roughness"]),
                env_map=self.env_map,
                colors=colors,
                device=device,
            )
            self._inst_base_key = (sv, device)
        key = (sv, self.pool.transform_version, self._mat_override_ver, device)
        if self._inst_key != key:
            mids, meshes = self._mesh_list()
            instances = self._instance_list(mids)
            nmats = np.stack([
                (np.linalg.inv(t[:3, :3]).T if abs(np.linalg.det(t[:3, :3])) > 1e-12 else t[:3, :3]).reshape(-1)
                for _, t in instances
            ]).astype(np.float32)
            # Override rows in TLAS instance order (sorted by instance_id, as
            # Hit.inst counts); an emission override also moves the
            # instance's triangles in or out of the light list (raw emission:
            # the table builder applies EMISSION_SCALE).
            iids = sorted(i.instance_id for i in self.pool._instances.values())
            imt = np.zeros((len(iids), 12), np.float32)
            em_over = {}
            for pos, iid in enumerate(iids):
                row = self._mat_overrides.get(iid)
                if row is not None:
                    imt[pos] = row
                    em_over[pos] = row[3:6] / scene_types.EMISSION_SCALE
            emissive = scene_types.build_emissive_table_instanced(
                meshes, instances, np.stack(self._materials["emission"]),
                emission_overrides=em_over or None, device=device,
            )
            self._inst_scene = self._inst_base._replace(
                emissive=emissive,
                inst_normal_mats=torch.as_tensor(nmats, device=device),
                inst_mat_table=torch.as_tensor(imt, device=device) if self._mat_overrides else None,
            )
            self._inst_key = key
        return self._inst_scene

    def tlas_backend(self, *, device, **kw):
        """Two-level TraceBackend (K4) on ``device``. The BLASes and the
        device cluster table are cached across transform edits; a
        structural change rebuilds them."""
        device = torch.device(device)
        sv = self.pool.structural_version
        opts = tuple(sorted(kw.items()))
        key = (sv, self.pool.transform_version, device, opts)
        if self._tlas_key == key:
            return self._tlas_backend
        if self._blas_key != (sv, opts):
            self._blas_cache = {}
            self._blas_key = (sv, opts)
        mids, meshes = self._mesh_list()
        self._tlas_backend = tlas_mod.two_level_backend(
            meshes, self._instance_list(mids), blas_cache=self._blas_cache, device=device, **kw)
        self._tlas_key = key
        return self._tlas_backend

    # -- trace backends ------------------------------------------------------

    @staticmethod
    def _kind(kind: str, device: torch.device) -> str:
        """``auto`` is the packet backend on a CUDA device and brute force
        on the CPU: chosen by ``device``, never by probing for a card."""
        if kind == "auto":
            return "packet" if device.type == "cuda" else "brute"
        return kind

    def trace_backend(self, kind: str = "auto", *, device, **kw):
        """TraceBackend for the current scene on ``device``. Kinds:
        ``auto``, ``packet`` (K1/K2, or K3 when ``packet_backend`` routes a
        large scene to treelets), ``treelet`` (K3), ``cluster`` (the 8-wide
        cluster BVH's walk, ``ops/cluster_bvh.cluster_backend``: kernel D
        of ``csrc/oracle_bvh.cu`` on the card) and ``brute``. Every kind
        reads nothing back on the card, so a compiled step
        (``FrameGraph.compile(jit=True)``) over it captures."""
        device = torch.device(device)
        self.scene(device=device)
        kind = self._kind(kind, device)
        if kind == "packet":
            from raytracer3_tpu_torch.ops import traverse_kernel as tk

            return tk.packet_backend(host_tris=self._host_tris(), device=device, **kw)
        if kind == "treelet":
            from raytracer3_tpu_torch.ops import treelets

            return treelets.treelet_backend(host_tris=self._host_tris(), device=device, **kw)
        if kind == "cluster":
            from raytracer3_tpu_torch.ops import cluster_bvh

            return cluster_bvh.cluster_backend(host_tris=self._host_tris(), device=device, **kw)
        if kind == "brute":
            from raytracer3_tpu_torch.ops import intersect as isect_mod

            return isect_mod.brute_backend(tris=self._host_tris(), device=device)
        raise ValueError(f"unknown backend kind {kind!r}")

    def backend(self, kind: str = "auto", *, device, **kw):
        """(intersect_fn, occluded_fn) for the current scene on ``device``,
        rebuilt when the scene is. Kinds: ``auto``, ``packet`` (K1/K2 over
        ``make_packet_backend``'s tables), ``cluster`` (the cluster BVH's
        walk, ``ops/cluster_bvh.make_cluster_backend``), ``bvh`` (the LBVH
        over the scene's padded triangles, ``ops/traverse.make_bvh_backend``)
        and ``brute`` (over the same triangles, as the reference's). On the
        card ``bvh`` builds with kernels A and B and walks with kernel C,
        ``cluster`` walks with kernel D (``csrc/oracle_bvh.cu``); none reads
        the device from the host, so a compiled step over any kind
        captures."""
        device = torch.device(device)
        key = (self.pool.version, kind, device, tuple(sorted(kw.items())))
        if self._backend is not None and not self.dirty and self._backend_key == key:
            return self._backend
        scene = self.scene(device=device)
        resolved = self._kind(kind, device)
        if resolved == "packet":
            from raytracer3_tpu_torch.ops import traverse_kernel as tk

            isect, occl, _ = tk.make_packet_backend(host_tris=self._host_tris(), device=device, **kw)
        elif resolved == "cluster":
            from raytracer3_tpu_torch.ops import cluster_bvh

            isect, occl, _ = cluster_bvh.make_cluster_backend(host_tris=self._host_tris(), device=device, **kw)
        elif resolved == "bvh":
            from raytracer3_tpu_torch.ops import traverse

            isect, occl, _ = traverse.make_bvh_backend(scene)
        elif resolved == "brute":
            from raytracer3_tpu_torch.ops import intersect as isect_mod

            v0, v1, v2 = scene.tri_vertices()

            def isect(o, d):
                return isect_mod.intersect_bruteforce(o, d, v0, v1, v2)

            def occl(o, d, tmax):
                return isect_mod.occluded_bruteforce(o, d, v0, v1, v2, t_max=tmax)
        else:
            raise ValueError(f"unknown backend kind {kind!r}")
        self._backend = (isect, occl)
        self._backend_key = key
        return self._backend
