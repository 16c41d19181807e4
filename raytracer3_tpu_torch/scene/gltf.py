"""glTF 2.0 (.glb) ingest and the GLB writers (copy of ``load_glb``,
``write_glb``, ``write_glb_multi``, ``mesh_to_scene`` and ``MeshData`` from
``raytracer3_tpu/scene/gltf.py``, host numpy but for the final upload).

``load_glb`` parses the GLB container (JSON + BIN chunks), reads accessors
with strides, u8/u16/u32 indices, POSITION/NORMAL/TEXCOORD_0/COLOR_0,
walks the node hierarchy with matrix/TRS transforms into world space, and
builds the pbrMetallicRoughness material table with emissiveFactor ×
KHR_materials_emissive_strength and base-colour textures (PNG/JPEG through
PIL). Its arrays must equal the reference's: the port's scenes are compared
with the reference's bit for bit.
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class MeshData:
    """Flattened scene geometry in world space + material table."""

    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray  # [V, 3] f32
    uvs: np.ndarray  # [V, 2] f32
    indices: np.ndarray  # [T, 3] i32
    geo_id: np.ndarray  # [T] i32 material index per triangle
    base_color: np.ndarray  # [G, 4] f32
    emission: np.ndarray  # [G, 3] f32
    metallic: np.ndarray  # [G] f32
    roughness: np.ndarray  # [G] f32
    base_color_texture: np.ndarray  # [G] i32 (-1 = none)
    textures: Optional[np.ndarray] = None  # [K, TH, TW, 3] f32 linear
    tex_images: Optional[list] = None  # native-resolution decoded images
    colors: Optional[np.ndarray] = None  # [V, 3] f32 per-vertex COLOR_0


def _parse_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC:
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported glTF version {version}")
    off = 12
    gltf = None
    bin_chunk = b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8 : off + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk)
        elif ctype == _CHUNK_BIN:
            bin_chunk = bytes(chunk)
        # Chunks are 4-byte aligned whatever their type.
        off += 8 + clen + (-clen) % 4
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, bin_chunk


def _read_accessor(gltf: dict, bin_chunk: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    if "sparse" in acc:
        raise ValueError("sparse accessors not supported")
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    bv = gltf["bufferViews"][acc["bufferView"]]
    base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride in (0, itemsize):
        arr = np.frombuffer(bin_chunk, dtype=dtype, count=count * ncomp, offset=base)
        out = arr.reshape(count, ncomp)
    else:
        rows = []
        for i in range(count):
            rows.append(np.frombuffer(bin_chunk, dtype=dtype, count=ncomp, offset=base + i * stride))
        out = np.stack(rows)
    if acc.get("normalized") and dtype != np.float32:
        maxv = float(np.iinfo(dtype).max)
        out = out.astype(np.float32) / maxv
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(map(np.float32, node["scale"])) + [np.float32(1)])
    if "rotation" in node:
        x, y, z, w = map(float, node["rotation"])
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        rm = np.eye(4, dtype=np.float32)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4, dtype=np.float32)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _decode_image(gltf: dict, bin_chunk: bytes, img_idx: int, size: int | None) -> np.ndarray:
    """Decode a glTF image to linear RGB f32 — native resolution when
    ``size`` is None, else resampled to [size, size]."""
    from PIL import Image

    img = gltf["images"][img_idx]
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        base = bv.get("byteOffset", 0)
        raw = bin_chunk[base : base + bv["byteLength"]]
    else:
        raise ValueError("external image URIs not supported in GLB ingest")
    pim = Image.open(io.BytesIO(raw)).convert("RGB")
    if size is not None:
        pim = pim.resize((size, size))
    srgb = np.asarray(pim, np.float32) / 255.0
    return srgb**2.2  # sRGB → linear (approximation)


def load_glb(path_or_bytes, texture_size: int = 256) -> MeshData:
    """Load a .glb into flattened world-space SoA arrays."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    gltf, bin_chunk = _parse_glb(data)

    mats = gltf.get("materials", [{}])
    g = max(1, len(mats))
    base_color = np.tile(np.asarray([1.0, 1.0, 1.0, 1.0], np.float32), (g, 1))
    emission = np.zeros((g, 3), np.float32)
    metallic = np.ones(g, np.float32)
    roughness = np.ones(g, np.float32)
    bc_tex = np.full(g, -1, np.int32)
    tex_image_ids = []  # material → glTF image index
    for i, m in enumerate(mats):
        pbr = m.get("pbrMetallicRoughness", {})
        base_color[i] = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        metallic[i] = pbr.get("metallicFactor", 1.0)
        roughness[i] = pbr.get("roughnessFactor", 1.0)
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}
        ).get("emissiveStrength", 1.0)
        emission[i] = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32) * strength
        if "baseColorTexture" in pbr:
            t = gltf["textures"][pbr["baseColorTexture"]["index"]]
            img_idx = t.get("source", -1)
            if img_idx >= 0:
                if img_idx not in tex_image_ids:
                    tex_image_ids.append(img_idx)
                bc_tex[i] = tex_image_ids.index(img_idx)

    textures = None
    tex_images = None
    if tex_image_ids:
        tex_images = [_decode_image(gltf, bin_chunk, i, None) for i in tex_image_ids]
        textures = np.stack([_decode_image(gltf, bin_chunk, i, texture_size) for i in tex_image_ids])

    # Walk the default scene's node tree, flattening transforms.
    positions, normals, uvs, indices, geo_id, colors = [], [], [], [], [], []
    has_colors = False
    voff = 0

    def emit_mesh(mesh_idx: int, world: np.ndarray):
        nonlocal voff, has_colors
        mesh = gltf["meshes"][mesh_idx]
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, bin_chunk, attrs["POSITION"]).astype(np.float32)
            n = pos.shape[0]
            nrm = (
                _read_accessor(gltf, bin_chunk, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _read_accessor(gltf, bin_chunk, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
                if "TEXCOORD_0" in attrs
                else np.zeros((n, 2), np.float32)
            )
            if "COLOR_0" in attrs:
                col = _read_accessor(gltf, bin_chunk, attrs["COLOR_0"]).astype(np.float32)[:, :3]
                has_colors = True
            else:
                col = np.ones((n, 3), np.float32)
            if "indices" in prim:
                idx = _read_accessor(gltf, bin_chunk, prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(n, dtype=np.int64)
            tri = idx.reshape(-1, 3).astype(np.int32)

            r = world[:3, :3]
            t = world[:3, 3]
            pos_w = pos @ r.T + t
            if nrm is None:
                # Face normals scattered to vertices (flat shading fallback).
                fn = np.cross(
                    pos_w[tri[:, 1]] - pos_w[tri[:, 0]],
                    pos_w[tri[:, 2]] - pos_w[tri[:, 0]],
                )
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
                nrm_w = np.zeros_like(pos_w)
                for k in range(3):
                    np.add.at(nrm_w, tri[:, k], fn)
                nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-20)
            else:
                nrm_it = np.linalg.inv(r).T
                nrm_w = nrm @ nrm_it.T
                nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-20)

            positions.append(pos_w.astype(np.float32))
            normals.append(nrm_w.astype(np.float32))
            uvs.append(uv)
            colors.append(col)
            indices.append(tri + voff)
            geo_id.extend([prim.get("material", 0)] * len(tri))
            voff += n

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)
        for c in node.get("children", []):
            walk(c, world)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{"nodes": list(range(len(gltf.get("nodes", []))))}])
    roots = scenes[scene_idx].get("nodes", [])
    if roots:
        for r in roots:
            walk(r, np.eye(4, dtype=np.float32))
    else:
        for mi in range(len(gltf.get("meshes", []))):
            emit_mesh(mi, np.eye(4, dtype=np.float32))

    if not positions:
        raise ValueError("GLB contains no triangle geometry")

    return MeshData(
        positions=np.concatenate(positions),
        normals=np.concatenate(normals),
        uvs=np.concatenate(uvs),
        indices=np.concatenate(indices),
        geo_id=np.asarray(geo_id, np.int32),
        base_color=base_color,
        emission=emission,
        metallic=metallic,
        roughness=roughness,
        base_color_texture=bc_tex,
        textures=textures,
        tex_images=tex_images,
        colors=np.concatenate(colors) if has_colors else None,
    )


def write_glb(
    path: str,
    positions: np.ndarray,
    indices: np.ndarray,
    normals: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
    base_color=(0.8, 0.8, 0.8, 1.0),
    metallic: float = 0.0,
    roughness: float = 1.0,
    emissive=(0.0, 0.0, 0.0),
    colors: np.ndarray | None = None,
) -> None:
    """Write a minimal single-mesh, single-material GLB; ``colors`` [V, 3]
    or [V, 4] becomes COLOR_0 (VEC3 or VEC4)."""
    bufs = []

    def add(arr):
        off = sum(len(b) for b in bufs)
        raw = np.ascontiguousarray(arr).tobytes()
        bufs.append(raw + b"\0" * ((-len(raw)) % 4))
        return off, len(raw)

    pos = positions.astype(np.float32)
    idx = indices.astype(np.uint32).reshape(-1)
    p_off, p_len = add(pos)
    i_off, i_len = add(idx)
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,
            "count": len(pos),
            "type": "VEC3",
            "min": pos.min(0).tolist(),
            "max": pos.max(0).tolist(),
        },
        {"bufferView": 1, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
    ]
    views = [
        {"buffer": 0, "byteOffset": p_off, "byteLength": p_len},
        {"buffer": 0, "byteOffset": i_off, "byteLength": i_len},
    ]
    attrs = {"POSITION": 0}
    if normals is not None:
        n_off, n_len = add(normals.astype(np.float32))
        views.append({"buffer": 0, "byteOffset": n_off, "byteLength": n_len})
        accessors.append({"bufferView": len(views) - 1, "componentType": 5126, "count": len(normals), "type": "VEC3"})
        attrs["NORMAL"] = len(accessors) - 1
    if uvs is not None:
        u_off, u_len = add(uvs.astype(np.float32))
        views.append({"buffer": 0, "byteOffset": u_off, "byteLength": u_len})
        accessors.append({"bufferView": len(views) - 1, "componentType": 5126, "count": len(uvs), "type": "VEC2"})
        attrs["TEXCOORD_0"] = len(accessors) - 1
    if colors is not None:
        colors = np.asarray(colors, np.float32)
        c_off, c_len = add(colors)
        views.append({"buffer": 0, "byteOffset": c_off, "byteLength": c_len})
        accessors.append({
            "bufferView": len(views) - 1,
            "componentType": 5126,
            "count": len(colors),
            "type": "VEC4" if colors.shape[1] == 4 else "VEC3",
        })
        attrs["COLOR_0"] = len(accessors) - 1

    binblob = b"".join(bufs)
    gltf = {
        "asset": {"version": "2.0", "generator": "raytracer3_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "indices": 1, "material": 0}]}],
        "materials": [
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": list(map(float, base_color)),
                    "metallicFactor": float(metallic),
                    "roughnessFactor": float(roughness),
                },
                "emissiveFactor": list(map(float, emissive)),
            }
        ],
        "buffers": [{"byteLength": len(binblob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(binblob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _CHUNK_JSON))
        f.write(js)
        f.write(struct.pack("<II", len(binblob), _CHUNK_BIN))
        f.write(binblob)


def write_glb_multi(
    path: str | None,
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
    geo_id: np.ndarray,
    base_color: np.ndarray,  # [G, 3|4]
    emission: np.ndarray,  # [G, 3]
    metallic: np.ndarray,  # [G]
    roughness: np.ndarray,  # [G]
) -> bytes:
    """Write a multi-material GLB: one mesh, one primitive per material
    (triangles grouped by geo_id). Returns the GLB bytes; also writes
    ``path`` when given. Round-trips through ``load_glb``."""
    bufs = []

    def add(arr):
        off = sum(len(b) for b in bufs)
        raw = np.ascontiguousarray(arr).tobytes()
        bufs.append(raw + b"\0" * ((-len(raw)) % 4))
        return off, len(raw)

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32)
    uv = np.asarray(uvs, np.float32)
    accessors = []
    views = []

    def add_accessor(arr, ctype, atype, minmax=False):
        off, ln = add(arr)
        views.append({"buffer": 0, "byteOffset": off, "byteLength": ln})
        acc = {"bufferView": len(views) - 1, "componentType": ctype, "count": len(arr), "type": atype}
        if minmax:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    a_pos = add_accessor(pos, 5126, "VEC3", minmax=True)
    a_nrm = add_accessor(nrm, 5126, "VEC3")
    a_uv = add_accessor(uv, 5126, "VEC2")

    g = len(base_color)
    prims = []
    materials = []
    geo_id = np.asarray(geo_id)
    for gi in range(g):
        tris = np.asarray(indices)[geo_id == gi].astype(np.uint32)
        if tris.size == 0:
            tris = np.zeros((0, 3), np.uint32)
        a_idx = add_accessor(tris.reshape(-1), 5125, "SCALAR")
        prims.append({
            "attributes": {"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv},
            "indices": a_idx,
            "material": gi,
        })
        bc = list(map(float, np.asarray(base_color[gi]).reshape(-1)[:4]))
        bc += [1.0] * (4 - len(bc))
        em = np.asarray(emission[gi], np.float64).reshape(-1)[:3]
        strength = float(max(em.max(), 1.0))
        materials.append({
            "pbrMetallicRoughness": {
                "baseColorFactor": bc,
                "metallicFactor": float(metallic[gi]),
                "roughnessFactor": float(roughness[gi]),
            },
            # emissiveFactor must be ≤ 1; overshoot via the strength ext.
            "emissiveFactor": (em / strength).tolist(),
            "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": strength}},
        })

    binblob = b"".join(bufs)
    gltf = {
        "asset": {"version": "2.0", "generator": "raytracer3_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": prims}],
        "materials": materials,
        "extensionsUsed": ["KHR_materials_emissive_strength"],
        "buffers": [{"byteLength": len(binblob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(binblob)
    blob = (
        struct.pack("<III", _MAGIC, 2, total)
        + struct.pack("<II", len(js), _CHUNK_JSON)
        + js
        + struct.pack("<II", len(binblob), _CHUNK_BIN)
        + binblob
    )
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def mesh_to_scene(md: MeshData, env_map: np.ndarray | None = None, *, device):
    """MeshData → Scene on ``device``: its textures, native images (the mip
    atlas) and vertex colours included."""
    from raytracer3_tpu_torch.scene import types as scene_types

    return scene_types.make_scene(
        positions=md.positions,
        normals=md.normals,
        uvs=md.uvs,
        indices=md.indices,
        geo_id=md.geo_id,
        base_color=md.base_color,
        emission=md.emission,
        metallic=md.metallic,
        roughness=md.roughness,
        base_color_texture=md.base_color_texture,
        textures=md.textures,
        env_map=env_map,
        tex_images=md.tex_images,
        colors=md.colors,
        device=device,
    )
