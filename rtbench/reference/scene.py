"""The reference's scene: its shading tables worked out from the raw
triangles, materials and sky that the benchmark hands both sides, and the
hit shading (a frozen copy of the untextured paths of
``raytracer3_tpu_torch/scene/types.py``: ``make_scene``'s shade, material,
light and sky tables, ``hit_surface_info`` and ``geometric_normals``).

Nothing here reads a table the program built: the reference makes its own
from the same inputs."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference import mathx

# hit_logic.slang:35 multiplies material emission by 12.0.
EMISSION_SCALE = 12.0


class Lights(NamedTuple):
    """Emissive-triangle list for next-event estimation."""

    count: int  # real emitters
    cdf: torch.Tensor  # [L] normalized cumulative area
    total_area: torch.Tensor  # [] sum of areas
    # Per-light row: v0(3) e1(3) e2(3) emission·12(3) valid(1) pad(3).
    light_table: torch.Tensor  # [L, 16]


class Scene(NamedTuple):
    positions: torch.Tensor  # [V, 3]
    indices: torch.Tensor  # [T, 3] int64
    # Per-triangle shading row: n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) geo(1).
    shade_table: torch.Tensor  # [T, 16]
    # Material row: base_color(3) emission·12(3) metallic roughness pad(4).
    mat_table: torch.Tensor  # [G, 12]
    lights: Lights
    # Sky importance sampling: per-texel alias row prob alias pdf rgb(3)
    # pdf_alias rgb_alias(3) pad(6), and (r, g, b, pdf) per texel.
    env_sample_table: torch.Tensor  # [He*We, 16]
    env_rgbp: torch.Tensor  # [He, We, 4]
    bounds: tuple  # (lo [3], hi [3]) of the positions


class SurfaceInfo(NamedTuple):
    albedo: torch.Tensor  # [N, 3]
    emissive: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    roughness: torch.Tensor  # [N]
    metalness: torch.Tensor  # [N]


def _lights_host(positions, indices, geo_id, emission) -> dict:
    em_per_tri = emission[geo_id]
    ids = np.nonzero(em_per_tri.max(axis=-1) > 0.0)[0]
    v0 = positions[indices[ids, 0]]
    v1 = positions[indices[ids, 1]]
    v2 = positions[indices[ids, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = float(areas.sum()) if len(ids) else 0.0
    n = len(ids)
    size = max(1, n)
    areas_p = np.pad(areas, (0, size - n))
    cdf = np.cumsum(areas_p)
    cdf = cdf / max(cdf[-1], 1e-30)
    lt = np.zeros((size, 16), np.float32)
    if n:
        lt[:n, 0:3] = v0
        lt[:n, 3:6] = v1 - v0
        lt[:n, 6:9] = v2 - v0
        lt[:n, 9:12] = emission[geo_id[ids]] * EMISSION_SCALE
        lt[:n, 12] = 1.0
    return dict(count=n, cdf=cdf.astype(np.float32), total_area=np.float32(total), light_table=lt)


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


def env_tables(env_map: np.ndarray):
    """Luminance·sinθ alias table + solid-angle pdf map of an equirect sky.
    Returns (sample_table [He*We, 16], rgbp [He, We, 4])."""
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


def make_scene(mesh: dict, env_map: np.ndarray, *, device) -> Scene:
    """The reference's scene on ``device`` from host arrays: ``mesh`` holds
    positions, normals, uvs, indices, geo_id, base_color, emission,
    metallic and roughness (``rtbench.inputs``); ``env_map`` the sky."""
    positions = np.asarray(mesh["positions"], np.float32)
    normals = np.asarray(mesh["normals"], np.float32)
    uvs = np.asarray(mesh["uvs"], np.float32)
    indices = np.asarray(mesh["indices"], np.int64)
    geo_id = np.asarray(mesh["geo_id"], np.int64)
    emission = np.asarray(mesh["emission"], np.float32)
    g = len(mesh["base_color"])

    st = np.zeros((indices.shape[0], 16), np.float32)
    for k in range(3):
        st[:, 3 * k:3 * k + 3] = normals[indices[:, k]]
        st[:, 9 + 2 * k:11 + 2 * k] = uvs[indices[:, k]]
    st[:, 15] = geo_id.astype(np.float32)
    mt = np.zeros((g, 12), np.float32)
    mt[:, 0:3] = np.asarray(mesh["base_color"], np.float32)[:, :3]
    mt[:, 3:6] = emission * EMISSION_SCALE
    mt[:, 6] = np.asarray(mesh["metallic"], np.float32)
    mt[:, 7] = np.asarray(mesh["roughness"], np.float32)
    mt[:, 8] = -1.0  # no texture
    lights = _lights_host(positions, indices, geo_id, emission)
    table, rgbp = env_tables(env_map)

    def up(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return Scene(
        positions=up(positions), indices=up(indices), shade_table=up(st), mat_table=up(mt),
        lights=Lights(count=lights["count"], cdf=up(lights["cdf"]), total_area=up(lights["total_area"]),
                      light_table=up(lights["light_table"])),
        env_sample_table=up(table), env_rgbp=up(rgbp),
        bounds=(up(positions.min(axis=0)), up(positions.max(axis=0))),
    )


def hit_surface_info(scene: Scene, prim_id, uv) -> SurfaceInfo:
    """One shade row per hit, barycentric interpolation, one material row
    (hit_logic.slang:5-39). prim_id is clamped; callers mask misses."""
    pid = prim_id.long().clamp(0, scene.indices.shape[0] - 1)
    row = scene.shade_table[pid]
    w0 = (1.0 - uv[:, 0] - uv[:, 1])[:, None]
    w1 = uv[:, 0:1]
    w2 = uv[:, 1:2]
    nrm = row[:, 0:3] * w0 + row[:, 3:6] * w1 + row[:, 6:9] * w2
    mat = scene.mat_table[row[:, 15].to(torch.int64)]
    return SurfaceInfo(albedo=mat[:, 0:3], emissive=mat[:, 3:6], normal=mathx.normalize(nrm),
                       roughness=mat[:, 7], metalness=mat[:, 6])


def geometric_normals(scene: Scene, prim_id) -> torch.Tensor:
    """Face normals [N, 3]."""
    pid = prim_id.long().clamp(0, scene.indices.shape[0] - 1)
    tri = scene.indices[pid]
    v0 = scene.positions[tri[:, 0]]
    v1 = scene.positions[tri[:, 1]]
    v2 = scene.positions[tri[:, 2]]
    return mathx.normalize(mathx.cross(v1 - v0, v2 - v0))
