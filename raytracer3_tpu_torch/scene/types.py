"""Scene tensors and hit shading (port of ``raytracer3_tpu/scene/types.py``).

The scene is a NamedTuple of dense tensors addressed by integer ids, built
on the host with numpy and uploaded once to an explicit device. Hit shading
takes the reference's fast path: ONE row of the per-triangle shade table and
one row of the material table per hit (the reference's one-hot MXU fetch is
plain indexing here). Instanced (TLAS) scenes keep their geometry in object
space and carry per-instance normal matrices and material overrides.

Base-colour textures come as the mip atlas (``scene/textures.py``, sampled
at the ray-cone level the wavefront passes in) or as the legacy array of
equal-size textures; either is rgb9e5-packed once, when the scene is
made, into ``tex_words``. Per-vertex colours (COLOR_0) widen the shade
rows to 32 lanes and multiply the albedo. A scene without shade rows
(``shade_table``/``mat_table`` None, as the reference allows) takes the
reference's slower path: the vertex attributes gathered by ``indices``
and the material fields by ``geo_id``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import mathx
from raytracer3_tpu_torch.scene import textures as tex_mod

# hit_logic.slang:35 multiplies material emission by 12.0.
EMISSION_SCALE = 12.0


class Materials(NamedTuple):
    base_color: torch.Tensor  # [G, 4] rgba factor
    emission: torch.Tensor  # [G, 3] raw emission factor (scaled at hit time)
    metallic: torch.Tensor  # [G]
    roughness: torch.Tensor  # [G]
    base_color_texture: torch.Tensor  # [G] int32, -1 = none


class EmissiveTable(NamedTuple):
    """Emissive-triangle list for next-event estimation."""

    tri_ids: torch.Tensor  # [L] int32 triangle indices (padded with -1)
    areas: torch.Tensor  # [L] world-space area
    cdf: torch.Tensor  # [L] normalized cumulative area
    total_area: torch.Tensor  # [] sum of areas
    count: torch.Tensor  # [] int32 number of valid entries
    # Per-light row: v0(3) e1(3) e2(3) emission·12(3) valid(1) pad(3).
    light_table: Optional[torch.Tensor] = None  # [L, 16] f32


class Scene(NamedTuple):
    positions: torch.Tensor  # [V, 3]
    normals: torch.Tensor  # [V, 3]
    uvs: torch.Tensor  # [V, 2]
    indices: torch.Tensor  # [T, 3] int32
    geo_id: torch.Tensor  # [T] int32 material id per triangle
    materials: Materials
    env_map: Optional[torch.Tensor]  # [He, We, 3] equirect HDR
    emissive: EmissiveTable
    # Per-triangle shading row: n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) geo(1),
    # with vertex colours c0(3) c1(3) c2(3) pad(7) in lanes 16:32.
    shade_table: Optional[torch.Tensor]  # [T, 16 or 32] f32; None: the slow path
    # Material row: base_color(3) emission·12(3) metallic roughness tex_id
    # log2 texel density (atlas scenes) pad(2).
    mat_table: Optional[torch.Tensor]  # [G, 12] f32; None: the slow path
    # Legacy texture array: every texture at one resolution.
    textures: Optional[torch.Tensor] = None  # [K, TH, TW, 3] f32
    # Env importance sampling: per-texel alias row prob alias pdf rgb(3)
    # pdf_alias rgb_alias(3) pad(6), and (r, g, b, pdf) per texel.
    env_sample_table: Optional[torch.Tensor] = None  # [He*We, 16] f32
    env_rgbp: Optional[torch.Tensor] = None  # [He, We, 4] f32
    # Instanced (TLAS) scenes: the geometry above is OBJECT space per mesh;
    # shading rotates normals by the hit instance's object→world normal
    # matrix (row-major 3×3). None for flattened scenes.
    inst_normal_mats: Optional[torch.Tensor] = None  # [I, 9] f32
    # Per-instance material override rows (mat_table layout; lane 11 = 1.0
    # makes the row replace the mesh material on every hit of the instance).
    inst_mat_table: Optional[torch.Tensor] = None  # [I, 12] f32
    # Mip atlas and its meta rows (scene/textures.py); it supersedes
    # ``textures``.
    tex_atlas: Optional[torch.Tensor] = None  # [Ha, Wa, 3] f32
    tex_meta: Optional[torch.Tensor] = None  # [K, 16] f32
    # rgb9e5 words of tex_atlas (else of textures), flat, int32 bits.
    tex_words: Optional[torch.Tensor] = None  # [Ha*Wa] or [K*TH*TW] int32
    # Per-vertex COLOR_0, set only where a colour is not white.
    vertex_colors: Optional[torch.Tensor] = None  # [V, 3] f32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    def tri_vertices(self):
        """Per-triangle vertex positions → (v0, v1, v2) each [T, 3]."""
        i = self.indices.long()
        return self.positions[i[:, 0]], self.positions[i[:, 1]], self.positions[i[:, 2]]


class SurfaceInfo(NamedTuple):
    albedo: torch.Tensor  # [N, 3]
    emissive: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    roughness: torch.Tensor  # [N]
    metalness: torch.Tensor  # [N]


def hit_surface_info(scene: Scene, prim_id, uv, inst=None, footprint_log2=None) -> SurfaceInfo:
    """Batched ``hit_info`` (hit_logic.slang:5-39): one shade-table row per
    hit, barycentric interpolation, one material row. prim_id is clamped;
    callers mask misses. With ``inst`` (the hit instance of a TLAS trace)
    the interpolated normal is rotated by the instance's normal matrix
    before it is normalised, and an active per-instance override row
    replaces the material row. The albedo is the material's base colour
    times the interpolated vertex colour (32-lane rows) times the
    base-colour texture: the atlas at mip level ``footprint_log2`` [N] (log2
    of the ray-cone footprint in world units) plus the material's log2
    texel density (mat lane 9), level 0 when None; else the legacy array.

    A scene without shade or material rows takes the reference's slow path
    (``_surface_from_vertices``)."""
    pid = prim_id.long().clamp(0, scene.num_triangles - 1)
    if scene.shade_table is None or scene.mat_table is None:
        return _surface_from_vertices(scene, pid, uv, footprint_log2)
    row = scene.shade_table[pid]
    w0 = (1.0 - uv[:, 0] - uv[:, 1])[:, None]
    w1 = uv[:, 0:1]
    w2 = uv[:, 1:2]
    nrm = row[:, 0:3] * w0 + row[:, 3:6] * w1 + row[:, 6:9] * w2
    iid = None if inst is None else inst.long().clamp_min(0)
    if iid is not None and scene.inst_normal_mats is not None:
        nm = scene.inst_normal_mats[iid]  # [N, 9]
        nrm = torch.stack([
            nm[:, 0] * nrm[:, 0] + nm[:, 1] * nrm[:, 1] + nm[:, 2] * nrm[:, 2],
            nm[:, 3] * nrm[:, 0] + nm[:, 4] * nrm[:, 1] + nm[:, 5] * nrm[:, 2],
            nm[:, 6] * nrm[:, 0] + nm[:, 7] * nrm[:, 1] + nm[:, 8] * nrm[:, 2],
        ], dim=-1)
    normal = mathx.normalize(nrm)
    mat = scene.mat_table[row[:, 15].to(torch.int64)]
    if iid is not None and scene.inst_mat_table is not None:
        imat = scene.inst_mat_table[iid]
        mat = torch.where(imat[:, 11:12] > 0.5, imat, mat)
    color = mat[:, 0:3]
    if scene.shade_table.shape[1] > 16:
        color = color * (row[:, 16:19] * w0 + row[:, 19:22] * w1 + row[:, 22:25] * w2)
    if scene.tex_atlas is not None or scene.textures is not None:
        tex_id = mat[:, 8].to(torch.int32)
        tex_uv = row[:, 9:11] * w0 + row[:, 11:13] * w1 + row[:, 13:15] * w2
        with torch.profiler.record_function("texture:sample"):
            if scene.tex_atlas is not None:
                lod = None if footprint_log2 is None else footprint_log2 + mat[:, 9]
                tex = tex_mod.sample_atlas(scene.tex_words, scene.tex_atlas.shape[1], scene.tex_meta, tex_id,
                                           tex_uv, lod)
            else:
                tex = tex_mod.sample_texture_array(scene.tex_words, scene.textures.shape[:3], tex_id, tex_uv)
        color = color * tex
    return SurfaceInfo(
        albedo=color,
        emissive=mat[:, 3:6],
        normal=normal,
        roughness=mat[:, 7],
        metalness=mat[:, 6],
    )


def _surface_from_vertices(scene: Scene, pid, uv, footprint_log2) -> SurfaceInfo:
    """The reference's path for scenes without shade rows
    (``raytracer3_tpu/scene/types.py:307-342``): normals, UVs and colours
    gathered per vertex through ``indices``, the material fields through
    ``geo_id``; the atlas level is ``footprint_log2`` as given (this path
    adds no texel density), and instance rows are not read."""
    tri = scene.indices[pid].long()
    w = torch.stack([1.0 - uv[:, 0] - uv[:, 1], uv[:, 0], uv[:, 1]], dim=-1)

    def interp(attr):
        a0, a1, a2 = (attr[tri[:, k]] for k in range(3))
        return a0 * w[:, 0:1] + a1 * w[:, 1:2] + a2 * w[:, 2:3]

    normal = mathx.normalize(interp(scene.normals))
    g = scene.geo_id[pid].long()
    mat = scene.materials
    color = mat.base_color[g, :3]
    if scene.vertex_colors is not None:
        color = color * interp(scene.vertex_colors)
    if scene.tex_atlas is not None or scene.textures is not None:
        tex_id = mat.base_color_texture[g].to(torch.int32)
        tex_uv = interp(scene.uvs)
        with torch.profiler.record_function("texture:sample"):
            if scene.tex_atlas is not None:
                tex = tex_mod.sample_atlas(scene.tex_words, scene.tex_atlas.shape[1], scene.tex_meta, tex_id,
                                           tex_uv, footprint_log2)
            else:
                tex = tex_mod.sample_texture_array(scene.tex_words, scene.textures.shape[:3], tex_id, tex_uv)
        color = color * tex
    return SurfaceInfo(
        albedo=color,
        emissive=mat.emission[g] * EMISSION_SCALE,
        normal=normal,
        roughness=mat.roughness[g],
        metalness=mat.metallic[g],
    )


def geometric_normals(scene: Scene, prim_id) -> torch.Tensor:
    """Face normals for offset/backface logic, [N, 3]."""
    pid = prim_id.long().clamp(0, scene.num_triangles - 1)
    tri = scene.indices[pid].long()
    v0 = scene.positions[tri[:, 0]]
    v1 = scene.positions[tri[:, 1]]
    v2 = scene.positions[tri[:, 2]]
    return mathx.normalize(mathx.cross(v1 - v0, v2 - v0))


# ---------------------------------------------------------------------------
# Host-side scene construction (numpy, then one upload)
# ---------------------------------------------------------------------------


def _emissive_host(positions, indices, geo_id, emission, pad_to=None) -> dict:
    em_per_tri = emission[geo_id]  # [T, 3]
    ids = np.nonzero(em_per_tri.max(axis=-1) > 0.0)[0].astype(np.int32)
    v0 = positions[indices[ids, 0]]
    v1 = positions[indices[ids, 1]]
    v2 = positions[indices[ids, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = float(areas.sum()) if len(ids) else 0.0
    n = len(ids)
    size = pad_to or max(1, n)
    pad = size - n
    ids_p = np.pad(ids, (0, pad), constant_values=-1)
    areas_p = np.pad(areas, (0, pad))
    cdf = np.cumsum(areas_p)
    cdf = cdf / max(cdf[-1], 1e-30)
    lt = np.zeros((size, 16), np.float32)
    if n:
        lt[:n, 0:3] = v0
        lt[:n, 3:6] = v1 - v0
        lt[:n, 6:9] = v2 - v0
        lt[:n, 9:12] = emission[geo_id[ids]] * EMISSION_SCALE
        lt[:n, 12] = 1.0  # valid
    return dict(
        tri_ids=ids_p.astype(np.int32), areas=areas_p.astype(np.float32),
        cdf=cdf.astype(np.float32), total_area=np.float32(total),
        count=np.int32(n), light_table=lt,
    )


def build_emissive_table(positions, indices, geo_id, emission, pad_to=None, *, device) -> EmissiveTable:
    """Precompute the NEE light list (host side) and upload it."""
    em = _emissive_host(positions, indices, geo_id, emission, pad_to)
    return EmissiveTable(**{k: torch.as_tensor(np.asarray(v), device=device) for k, v in em.items()})


def _next_pow2_int(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _emissive_instanced_host(meshes, instances, emission, pad_to=None, emission_overrides=None) -> dict:
    v0s, v1s, v2s, ems, ids = [], [], [], [], []
    tri_base = np.cumsum([0] + [len(m["indices"]) for m in meshes[:-1]]).tolist()
    for ii, (mi, t) in enumerate(instances):
        m = meshes[mi]
        em_per_tri = emission[m["geo_id"]]
        if emission_overrides and ii in emission_overrides:
            em_per_tri = np.broadcast_to(np.asarray(emission_overrides[ii], np.float32), em_per_tri.shape)
        mask = em_per_tri.max(axis=-1) > 0.0
        if not mask.any():
            continue
        idx = m["indices"][mask]
        pos = m["positions"] @ t[:3, :3].T + t[:3, 3]
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        ems.append(em_per_tri[mask])
        ids.append(np.nonzero(mask)[0].astype(np.int32) + tri_base[mi])
    if not v0s:
        return dict(
            tri_ids=np.full((0,), -1, np.int32), areas=np.zeros((0,), np.float32),
            cdf=np.zeros((0,), np.float32), total_area=np.float32(0.0), count=np.int32(0),
            light_table=np.zeros((1, 16), np.float32),
        )
    v0 = np.concatenate(v0s).astype(np.float32)
    v1 = np.concatenate(v1s).astype(np.float32)
    v2 = np.concatenate(v2s).astype(np.float32)
    em = np.concatenate(ems).astype(np.float32)
    ids = np.concatenate(ids)
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    n = len(ids)
    size = pad_to or max(1, _next_pow2_int(n))
    pad = size - n
    lt = np.zeros((size, 16), np.float32)
    lt[:n, 0:3] = v0
    lt[:n, 3:6] = v1 - v0
    lt[:n, 6:9] = v2 - v0
    lt[:n, 9:12] = em * EMISSION_SCALE
    lt[:n, 12] = 1.0
    areas_p = np.pad(areas, (0, pad))
    cdf = np.cumsum(areas_p)
    cdf = cdf / max(cdf[-1], 1e-30)
    return dict(
        tri_ids=np.pad(ids, (0, pad), constant_values=-1), areas=areas_p.astype(np.float32),
        cdf=cdf.astype(np.float32), total_area=np.float32(float(areas.sum())), count=np.int32(n),
        light_table=lt,
    )


def build_emissive_table_instanced(meshes, instances, emission, pad_to=None, emission_overrides=None,
                                   *, device) -> EmissiveTable:
    """NEE light list of an instanced (TLAS) scene: the emissive triangles
    of every instance, in world space (host numpy, then one upload). Light
    ids are mesh-concatenated triangle ids; the list pads to a power of two.

    meshes: dicts with object-space positions/indices/geo_id; instances:
    (mesh index, transform [4, 4]); emission_overrides: {instance position
    → [3] raw emission} — a per-instance material override replaces every
    geo's emission, so the whole instance enters or leaves the list."""
    em = _emissive_instanced_host(meshes, instances, emission, pad_to, emission_overrides)
    return EmissiveTable(**{k: torch.as_tensor(np.asarray(v), device=device) for k, v in em.items()})


def _vose_alias(p: np.ndarray):
    """Vose's alias method. p must sum to 1. Returns (prob [N], alias [N])."""
    n = len(p)
    scaled = p * n
    prob = np.zeros(n, np.float32)
    alias = np.zeros(n, np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l_ = large.pop()
        prob[s] = scaled[s]
        alias[s] = l_
        scaled[l_] = (scaled[l_] + scaled[s]) - 1.0
        if scaled[l_] < 1.0:
            small.append(l_)
        else:
            large.append(l_)
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def build_env_tables(env_map: np.ndarray):
    """Luminance·sinθ alias table + solid-angle pdf map for an equirect HDR
    environment (host numpy). Returns (sample_table [He*We, 16], rgbp
    [He, We, 4])."""
    env = np.asarray(env_map, np.float32)
    he, we = env.shape[0], env.shape[1]
    lum = 0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2]
    theta = (np.arange(he, dtype=np.float64) + 0.5) / he * np.pi
    sin_t = np.sin(theta)[:, None]
    w = np.maximum(lum, 0.0) * sin_t
    total = w.sum()
    if total <= 0.0:
        w = np.ones_like(w) * sin_t
        total = w.sum()
    p = (w / total).reshape(-1)
    prob, alias = _vose_alias(p)
    # Solid angle of texel (y, x): dΩ = (2π/We)(π/He) sinθ_y.
    d_omega = (2.0 * np.pi / we) * (np.pi / he) * np.maximum(sin_t, 1e-8)
    pdf = (p.reshape(he, we) / d_omega).astype(np.float32)
    pdf_flat = pdf.reshape(-1)
    rgb_flat = env.reshape(-1, 3)
    table = np.zeros((he * we, 16), np.float32)
    table[:, 0] = prob
    table[:, 1] = alias.astype(np.float32)
    table[:, 2] = pdf_flat
    table[:, 3:6] = rgb_flat
    table[:, 6] = pdf_flat[alias]
    table[:, 7:10] = rgb_flat[alias]
    rgbp = np.concatenate([env, pdf[..., None]], axis=-1).astype(np.float32)
    return table, rgbp


def make_scene(
    positions, normals, uvs, indices, geo_id, base_color, emission, metallic,
    roughness, base_color_texture=None, textures=None, env_map=None,
    tex_images=None, colors=None, *, device,
) -> Scene:
    """Assemble a Scene on ``device`` from host numpy arrays.

    tex_images: native-resolution [H, W, 3] images → the mip atlas, which
    supersedes ``textures`` (the legacy [K, TH, TW, 3] array). colors:
    per-vertex [V, 3] COLOR_0; unless all are white the shade rows widen to
    32 lanes and shading multiplies the albedo by them."""
    g = len(base_color)
    if base_color_texture is None:
        base_color_texture = np.full(g, -1, np.int32)

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    uvs = np.asarray(uvs, np.float32)
    indices = np.asarray(indices, np.int32)
    geo_id = np.asarray(geo_id, np.int32)

    use_colors = colors is not None and not np.allclose(np.asarray(colors, np.float32), 1.0)
    st = np.zeros((indices.shape[0], 32 if use_colors else 16), np.float32)
    st[:, 0:3] = normals[indices[:, 0]]
    st[:, 3:6] = normals[indices[:, 1]]
    st[:, 6:9] = normals[indices[:, 2]]
    st[:, 9:11] = uvs[indices[:, 0]]
    st[:, 11:13] = uvs[indices[:, 1]]
    st[:, 13:15] = uvs[indices[:, 2]]
    st[:, 15] = geo_id.astype(np.float32)
    if use_colors:
        colors = np.asarray(colors, np.float32)
        st[:, 16:19] = colors[indices[:, 0]]
        st[:, 19:22] = colors[indices[:, 1]]
        st[:, 22:25] = colors[indices[:, 2]]

    mt = np.zeros((g, 12), np.float32)
    mt[:, 0:3] = np.asarray(base_color, np.float32)[:, :3]
    mt[:, 3:6] = np.asarray(emission, np.float32) * EMISSION_SCALE
    mt[:, 6] = np.asarray(metallic, np.float32)
    mt[:, 7] = np.asarray(roughness, np.float32)
    mt[:, 8] = np.asarray(base_color_texture, np.float32)

    tex = {}
    if tex_images is not None and len(tex_images) > 0:
        atlas, meta = tex_mod.build_texture_atlas(tex_images)
        # Per-material log2 texel density (the mean over its triangles)
        # completes the ray-cone mip level at shading time.
        bct = np.asarray(base_color_texture)
        v0, v1, v2 = positions[indices[:, 0]], positions[indices[:, 1]], positions[indices[:, 2]]
        u0, u1, u2 = uvs[indices[:, 0]], uvs[indices[:, 1]], uvs[indices[:, 2]]
        tex_of_tri = bct[geo_id]
        for gi in range(g):
            ti = int(bct[gi])
            if ti < 0:
                continue
            sel = (geo_id == gi) & (tex_of_tri >= 0)
            if not sel.any():
                continue
            d = tex_mod.texel_density_log2(v0[sel], v1[sel], v2[sel], u0[sel], u1[sel], u2[sel],
                                           float(meta[ti, 2]), float(meta[ti, 3]))
            mt[gi, 9] = float(np.mean(d))
        tex = dict(tex_atlas=atlas, tex_meta=meta)
    elif textures is not None:
        tex = dict(textures=np.asarray(textures, np.float32))

    fields = dict(
        positions=positions, normals=normals, uvs=uvs, indices=indices,
        geo_id=geo_id,
        materials=dict(
            base_color=np.asarray(base_color, np.float32),
            emission=np.asarray(emission, np.float32),
            metallic=np.asarray(metallic, np.float32),
            roughness=np.asarray(roughness, np.float32),
            base_color_texture=np.asarray(base_color_texture, np.int32),
        ),
        env_map=None if env_map is None else np.asarray(env_map, np.float32),
        emissive=_emissive_host(positions, indices, geo_id, np.asarray(emission, np.float32)),
        shade_table=st,
        mat_table=mt,
        vertex_colors=colors if use_colors else None,
        **tex,
    )
    if env_map is not None:
        fields["env_sample_table"], fields["env_rgbp"] = build_env_tables(env_map)
    return scene_from_numpy(fields, device)


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def scene_from_numpy(fields, device) -> Scene:
    """Build a Scene on ``device`` from numpy fields: the port's own
    (make_scene) or the reference Scene's, pulled as numpy (``_asdict()`` of
    the reference NamedTuple works as is). The texture words are packed
    here, from ``tex_atlas`` or else ``textures``; the reference has no
    such field. ``shade_table``/``mat_table`` may be None (the slow shading
    path of ``hit_surface_info``)."""
    fields = _fields(fields)

    def up(a):
        return None if a is None else torch.as_tensor(np.array(a), device=device)

    mats = _fields(fields["materials"])
    em = _fields(fields["emissive"])
    textures, atlas = up(fields.get("textures")), up(fields.get("tex_atlas"))
    texels = atlas if atlas is not None else textures
    return Scene(
        positions=up(fields["positions"]),
        normals=up(fields["normals"]),
        uvs=up(fields["uvs"]),
        indices=up(fields["indices"]),
        geo_id=up(fields["geo_id"]),
        materials=Materials(**{k: up(mats[k]) for k in Materials._fields}),
        env_map=up(fields.get("env_map")),
        emissive=EmissiveTable(**{k: up(em.get(k)) for k in EmissiveTable._fields}),
        shade_table=up(fields.get("shade_table")),
        mat_table=up(fields.get("mat_table")),
        textures=textures,
        env_sample_table=up(fields.get("env_sample_table")),
        env_rgbp=up(fields.get("env_rgbp")),
        inst_normal_mats=up(fields.get("inst_normal_mats")),
        inst_mat_table=up(fields.get("inst_mat_table")),
        tex_atlas=atlas,
        tex_meta=up(fields.get("tex_meta")),
        tex_words=None if texels is None else tex_mod.pack_texels(texels),
        vertex_colors=up(fields.get("vertex_colors")),
    )
