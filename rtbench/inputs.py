"""The benchmark's inputs, made by the benchmark and handed to both the
program and the plain reference: the atrium's triangles and materials, the
procedural sky and the blue-noise texture.

The generators are frozen copies of ``raytracer3_tpu_torch/scene/procedural.py``
(``atrium``, ``sky_equirect`` and their parts) and the blue noise of
``rtbench.reference.rng``, so a change to the program's generators never
moves the benchmark's scenes. The blue-noise texture takes seconds to make;
it is cached once per checkout under ``build/rtbench/`` (a fixed path)."""

from __future__ import annotations

import os

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(_ROOT, "build", "rtbench")


def _cylinder(center, radius, height, segments, rings=1):
    """Open cylinder (side wall) triangles."""
    cx, cy, cz = center
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    verts = []
    for r in range(rings + 1):
        y = cy + height * r / rings
        ring = np.stack(
            [cx + radius * np.cos(ang), np.full(segments, y), cz + radius * np.sin(ang)],
            axis=-1,
        )
        verts.append(ring)
    verts = np.concatenate(verts)
    tris = []
    for r in range(rings):
        for s in range(segments):
            a = r * segments + s
            b = r * segments + (s + 1) % segments
            c = (r + 1) * segments + s
            d = (r + 1) * segments + (s + 1) % segments
            tris += [[a, b, d], [a, d, c]]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def _box_tris(bmin, bmax):
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    v = np.asarray(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1],
            [x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    f = [
        [0, 1, 2], [0, 2, 3],  # bottom
        [4, 6, 5], [4, 7, 6],  # top
        [0, 4, 5], [0, 5, 1],
        [1, 5, 6], [1, 6, 2],
        [2, 6, 7], [2, 7, 3],
        [3, 7, 4], [3, 4, 0],
    ]
    return v, np.asarray(f, np.int32)


def _grid_patch(origin, du, dv, nu, nv, height_fn=None):
    """Tessellated quad patch with optional displacement (banners, floor)."""
    origin = np.asarray(origin, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    us = np.linspace(0, 1, nu + 1)
    vs = np.linspace(0, 1, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    pts = origin[None, None] + uu[..., None] * du[None, None] + vv[..., None] * dv[None, None]
    if height_fn is not None:
        n = np.cross(du, dv)
        n /= np.linalg.norm(n)
        pts = pts + height_fn(uu, vv)[..., None] * n[None, None]
    verts = pts.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = a + 1
            c = a + (nv + 1)
            d = c + 1
            tris += [[a, b, d], [a, d, c]]
    return verts, np.asarray(tris, np.int32)


def atrium(detail: int = 2, seed: int = 0):
    """Sponza-stand-in atrium: a colonnade of fluted columns on a courtyard
    with galleries, draped banners, metal props and a skylight emitter
    (detail=2: 19,188 triangles; detail=8: 299,508). Host arrays for
    ``scene.types.make_scene``."""
    rng = np.random.default_rng(seed)
    seg = 12 * detail
    rings = 4 * detail
    patch_n = 16 * detail

    parts = []  # (verts, tris, material_id)

    MAT_FLOOR, MAT_WALL, MAT_COLUMN, MAT_BANNER_R, MAT_BANNER_G, MAT_BANNER_B, MAT_METAL, MAT_LIGHT = range(8)

    # Courtyard floor 24×12, slightly tessellated for uv variety.
    v, t = _grid_patch((-12, 0, -6), (24, 0, 0), (0, 0, 12), patch_n, patch_n // 2)
    parts.append((v, t, MAT_FLOOR))
    # Perimeter walls.
    for bmin, bmax in [
        ((-12, 0, -6.5), (12, 8, -6)),
        ((-12, 0, 6), (12, 8, 6.5)),
        ((-12.5, 0, -6.5), (-12, 8, 6.5)),
        ((12, 0, -6.5), (12.5, 8, 6.5)),
    ]:
        v, t = _box_tris(bmin, bmax)
        parts.append((v, t, MAT_WALL))
    # Upper gallery slabs (leave a skylight opening).
    for bmin, bmax in [
        ((-12, 8, -6.5), (12, 8.5, -3)),
        ((-12, 8, 3), (12, 8.5, 6.5)),
        ((-12, 8, -3), (-8, 8.5, 3)),
        ((8, 8, -3), (12, 8.5, 3)),
    ]:
        v, t = _box_tris(bmin, bmax)
        parts.append((v, t, MAT_WALL))

    # Two rows of columns.
    for z in (-3.0, 3.0):
        for i in range(7):
            x = -9.0 + 3.0 * i
            v, t = _cylinder((x, 0.0, z), 0.45, 6.0, seg, rings)
            parts.append((v, t, MAT_COLUMN))
            # capital + base
            v, t = _box_tris((x - 0.6, 5.9, z - 0.6), (x + 0.6, 6.4, z + 0.6))
            parts.append((v, t, MAT_COLUMN))
            v, t = _box_tris((x - 0.6, 0.0, z - 0.6), (x + 0.6, 0.3, z + 0.6))
            parts.append((v, t, MAT_COLUMN))

    # Draped banners (displaced cloth patches) hanging from the gallery.
    banner_mats = [MAT_BANNER_R, MAT_BANNER_G, MAT_BANNER_B]
    for k in range(6):
        x = -8.0 + 3.2 * k
        z = -2.96 if k % 2 == 0 else 2.96
        sgn = 1.0 if k % 2 == 0 else -1.0
        phase = rng.uniform(0, 2 * np.pi)

        def wave(uu, vv, phase=phase, sgn=sgn):
            return sgn * 0.25 * np.sin(3.0 * np.pi * vv + phase) * np.sin(np.pi * uu)

        v, t = _grid_patch((x, 7.8, z), (1.8, 0, 0), (0, -3.2, 0), patch_n, patch_n, wave)
        parts.append((v, t, banner_mats[k % 3]))

    # A few metallic props on the floor.
    for k in range(5):
        x = rng.uniform(-9, 9)
        z = rng.uniform(-4.5, 4.5)
        s = rng.uniform(0.3, 0.8)
        v, t = _box_tris((x - s, 0.0, z - s), (x + s, 2 * s, z + s))
        parts.append((v, t, MAT_METAL))

    # Skylight emitter panel (area light over the opening).
    v, t = _grid_patch((-8, 8.45, -3), (16, 0, 0), (0, 0, 6), 2, 2)
    parts.append((v, t[:, ::-1].copy(), MAT_LIGHT))  # flip to face down

    positions, indices, geo_id = [], [], []
    voff = 0
    for v, t, m in parts:
        positions.append(v)
        indices.append(t + voff)
        geo_id.extend([m] * len(t))
        voff += len(v)
    positions = np.concatenate(positions)
    indices = np.concatenate(indices)
    geo_id = np.asarray(geo_id, np.int32)

    # Smooth vertex normals from face normals.
    fn = np.cross(
        positions[indices[:, 1]] - positions[indices[:, 0]],
        positions[indices[:, 2]] - positions[indices[:, 0]],
    )
    fl = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(fl, 1e-20)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)

    # Planar uvs.
    uvs = (positions[:, [0, 2]] - positions[:, [0, 2]].min(0)) / 24.0

    base_color = np.asarray(
        [
            [0.65, 0.6, 0.55, 1.0],  # floor
            [0.75, 0.71, 0.65, 1.0],  # wall
            [0.8, 0.78, 0.72, 1.0],  # column
            [0.6, 0.08, 0.08, 1.0],  # banner r
            [0.08, 0.5, 0.1, 1.0],  # banner g
            [0.1, 0.15, 0.55, 1.0],  # banner b
            [0.95, 0.93, 0.88, 1.0],  # metal
            [1.0, 0.98, 0.92, 1.0],  # light
        ],
        np.float32,
    )
    emission = np.zeros((8, 3), np.float32)
    emission[7] = np.asarray([4.0, 3.9, 3.7]) / 12.0  # scaled at hit by ×12
    metallic = np.asarray([0, 0, 0, 0, 0, 0, 1.0, 0], np.float32)
    roughness = np.asarray([0.8, 0.9, 0.7, 0.95, 0.95, 0.95, 0.25, 1.0], np.float32)

    return dict(
        positions=positions,
        normals=normals,
        uvs=uvs.astype(np.float32),
        indices=indices,
        geo_id=geo_id,
        base_color=base_color,
        emission=emission,
        metallic=metallic,
        roughness=roughness,
    )


def sky_equirect(height: int = 256, width: int = 512, sun_dir=(0.35, 0.55, 0.2),
                 turbidity: float = 2.5) -> np.ndarray:
    """Procedural clear-sky HDR (gradient + sun disc), equirect [H, W, 3]."""
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    vs, us = np.meshgrid(
        (np.arange(height) + 0.5) / height, (np.arange(width) + 0.5) / width, indexing="ij"
    )
    phi = (us - 0.5) * 2 * np.pi
    theta = (0.5 - vs) * np.pi  # = asin(y)
    y = np.sin(theta)
    x = np.cos(theta) * np.cos(phi)
    z = np.cos(theta) * np.sin(phi)
    cos_g = np.clip(x * sun[0] + y * sun[1] + z * sun[2], -1, 1)

    horizon = np.asarray([0.55, 0.65, 0.8])
    zenith = np.asarray([0.15, 0.3, 0.65])
    ty = np.clip(y, 0, 1) ** 0.5
    base = horizon[None, None] * (1 - ty[..., None]) + zenith[None, None] * ty[..., None]
    # Below-horizon ground glow.
    ground = np.asarray([0.25, 0.22, 0.18])
    base = np.where(y[..., None] < 0, ground[None, None] * (1 + 0.5 * y[..., None]), base)
    # Forward-scattering glow + sun disc (~0.5° radius, at least one pixel).
    glow = np.exp((cos_g - 1) * 12.0 * turbidity)[..., None] * np.asarray([1.2, 1.0, 0.7])
    g_ang = np.arccos(cos_g)
    sun_radius = max(np.deg2rad(0.53), np.pi / height)
    disc = np.exp(-((g_ang / sun_radius) ** 8))[..., None]
    sun_col = np.asarray([800.0, 720.0, 600.0])
    hdr = base * 1.2 + glow * 2.0 + disc * sun_col * np.clip(y[..., None] * 4 + 0.2, 0, 1)
    return hdr.astype(np.float32)




def blue_noise(size: int = 64) -> np.ndarray:
    """The void-and-cluster blue-noise texture [size, size] (seed 0), from
    ``build/rtbench/`` when a run in this checkout made it already."""
    path = os.path.join(CACHE_DIR, f"bluenoise_{size}.npy")
    if os.path.exists(path):
        return np.load(path)
    from rtbench.reference import rng

    bn = rng.generate_blue_noise(size=size)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, bn)
    os.replace(tmp, path)
    return bn


def scene_inputs(config: dict):
    """The raw inputs both sides get for a configuration: (mesh, sky, blue
    noise)."""
    sc = config["scene"]
    return (atrium(detail=sc["detail"], seed=sc["seed"]), sky_equirect(*sc["sky"]),
            blue_noise(config["render"]["blue_noise"]))
