"""Geometry pool: registered meshes, instances with transforms, and their
flattening into padded world-space arrays (copy of
``raytracer3_tpu/scene/pools.py``, host numpy only).

Meshes are registered once; instances carry a 4×4 transform. ``flatten``
bakes every instance into world space and pads to power-of-two capacity
with degenerate triangles, as the reference does. ``version`` counts every
change; ``structural_version`` counts mesh/instance adds and removes (which
invalidate BLASes), ``transform_version`` transform edits (which rebuild
only the TLAS and the per-instance tables).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class MeshHandle:
    """A registered mesh."""

    mesh_id: int
    vertex_count: int
    tri_count: int


@dataclasses.dataclass
class Instance:
    """A mesh instance with its 4×4 transform."""

    mesh_id: int
    transform: np.ndarray  # [4,4]
    instance_id: int = -1


class GeometryPool:
    """Host-side mesh and instance pool; produces padded numpy arrays for
    ``scene.types.make_scene``."""

    def __init__(self):
        self._meshes: Dict[int, dict] = {}
        self._instances: Dict[int, Instance] = {}
        self._next_mesh = 0
        self._next_instance = 0
        self.version = 0
        self.structural_version = 0
        self.transform_version = 0

    def add_mesh(
        self,
        positions: np.ndarray,
        normals: np.ndarray,
        uvs: np.ndarray,
        indices: np.ndarray,
        geo_id: np.ndarray,
        colors: Optional[np.ndarray] = None,
    ) -> MeshHandle:
        mid = self._next_mesh
        self._next_mesh += 1
        self._meshes[mid] = dict(
            positions=np.asarray(positions, np.float32),
            normals=np.asarray(normals, np.float32),
            uvs=np.asarray(uvs, np.float32),
            indices=np.asarray(indices, np.int32),
            geo_id=np.asarray(geo_id, np.int32),
        )
        if colors is not None:
            self._meshes[mid]["colors"] = np.asarray(colors, np.float32)
        self.version += 1
        self.structural_version += 1
        return MeshHandle(mid, len(positions), len(indices))

    def add_instance(self, mesh: MeshHandle, transform: Optional[np.ndarray] = None) -> int:
        iid = self._next_instance
        self._next_instance += 1
        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
        self._instances[iid] = Instance(mesh.mesh_id, t, iid)
        self.version += 1
        self.structural_version += 1
        return iid

    def set_transform(self, instance_id: int, transform: np.ndarray):
        self._instances[instance_id].transform = np.asarray(transform, np.float32)
        self.version += 1
        self.transform_version += 1

    def remove_instance(self, instance_id: int):
        del self._instances[instance_id]
        self.version += 1
        self.structural_version += 1

    @property
    def instance_count(self) -> int:
        return len(self._instances)

    def flatten(self, pad: bool = True):
        """Bake all instances into world-space pooled arrays, padded to
        power-of-two capacity with degenerate triangles (``pad``)."""
        positions, normals, uvs, indices, geo_id, inst_id = [], [], [], [], [], []
        colors = []
        any_colors = any("colors" in m for m in self._meshes.values())
        voff = 0
        for inst in self._instances.values():
            m = self._meshes[inst.mesh_id]
            r = inst.transform[:3, :3]
            t = inst.transform[:3, 3]
            pos = m["positions"] @ r.T + t
            nit = np.linalg.inv(r).T if abs(np.linalg.det(r)) > 1e-12 else r
            nrm = m["normals"] @ nit.T
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            positions.append(pos.astype(np.float32))
            normals.append(nrm.astype(np.float32))
            uvs.append(m["uvs"])
            if any_colors:
                colors.append(m.get("colors", np.ones((len(pos), 3), np.float32)))
            indices.append(m["indices"] + voff)
            geo_id.append(m["geo_id"])
            inst_id.append(np.full(len(m["indices"]), inst.instance_id, np.int32))
            voff += len(pos)

        if not positions:
            raise ValueError("pool has no instances")
        positions = np.concatenate(positions)
        normals = np.concatenate(normals)
        uvs = np.concatenate(uvs)
        indices = np.concatenate(indices)
        geo_id = np.concatenate(geo_id)
        inst_id = np.concatenate(inst_id)
        colors = np.concatenate(colors) if any_colors else None

        if pad:
            vcap = _next_pow2(len(positions))
            tcap = _next_pow2(len(indices))
            vp = vcap - len(positions)
            tp = tcap - len(indices)
            positions = np.pad(positions, ((0, vp), (0, 0)))
            normals = np.pad(normals, ((0, vp), (0, 0)))
            if vp:
                normals[-vp:, 2] = 1.0  # unit normals for padding vertices
            uvs = np.pad(uvs, ((0, vp), (0, 0)))
            if colors is not None:
                colors = np.pad(colors, ((0, vp), (0, 0)), constant_values=1.0)
            # Degenerate padding triangles reference vertex 0 three times.
            indices = np.pad(indices, ((0, tp), (0, 0)))
            geo_id = np.pad(geo_id, (0, tp))
            inst_id = np.pad(inst_id, (0, tp), constant_values=-1)

        return dict(
            positions=positions,
            normals=normals,
            uvs=uvs,
            indices=indices,
            geo_id=geo_id,
            instance_id=inst_id,
            real_tri_count=int((inst_id >= 0).sum()),
            colors=colors,
        )
