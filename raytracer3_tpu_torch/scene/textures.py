"""Native-resolution textures with mip chains in one packed atlas (port of
``raytracer3_tpu/scene/textures.py``).

Every texture's full box-filtered mip pyramid sits in ONE flat [H, W, 3]
atlas (mips stacked under the base level, textures shelf-packed by
column), described by a [K, 16] meta-row table. A lane gathers its meta
row, computes the level's origin and size, and reads 4 (bilinear) or 8
(trilinear) texels. The mip level comes from the ray cone: footprint ≈
t · cone_angle / cos θ world units, plus the material's log2 texel density
(computed at ingest).

The host builders (``build_texture_atlas``, ``texel_density_log2``) are
numpy and bit-equal to the reference's. Taps read rgb9e5-packed words, as
the reference's do: the reference packs the atlas on every call, the port
packs it once when the ``Scene`` is made (``pack_texels``) and the
samplers take the words. Tap indices are bit-equal to the reference's; the
colours differ by the reference's ``unpack_rgb9e5`` rounding (≤ 1 ulp on
XLA's CPU) and its contracted multiply-adds.

Meta row of texture k (16 f32 lanes):
  [0] x0        atlas x of every mip level (widths halve in place)
  [1] y0        atlas y of mip 0
  [2] w, [3] h  base resolution
  [4] n_mips
  [5] nearest   1.0 → point sampling
  [6..15]       y offset of mips 1..10 (mip m > 0 at (x0, y_off[m]))
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from raytracer3_tpu_torch.ops import packing

MAX_MIPS = 11  # lanes 6..15 hold mips 1..10; mip 0 at (x0, y0)


def _mip_chain(img: np.ndarray) -> list[np.ndarray]:
    """Box-filter pyramid down to 1×1; an odd last row or column is
    dropped from the level below."""
    mips = [img.astype(np.float32)]
    while (mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1) and len(mips) < MAX_MIPS:
        cur = mips[-1]
        h, w = cur.shape[0], cur.shape[1]
        nh, nw = max(1, h // 2), max(1, w // 2)
        ev = cur[: nh * 2, : nw * 2]
        down = (ev[0::2, 0::2] + ev[1::2, 0::2] + ev[0::2, 1::2] + ev[1::2, 1::2]) * 0.25
        mips.append(down)
    return mips


def build_texture_atlas(images: Sequence[np.ndarray], nearest: Sequence[bool] | None = None):
    """Pack native-resolution images and their mip chains into one atlas
    (host numpy). Returns (atlas [H, W, 3] f32, meta [K, 16] f32)."""
    k = len(images)
    meta = np.zeros((k, 16), np.float32)
    chains, col_w, col_h = [], [], []
    for img in images:
        a = np.asarray(img, np.float32)
        if a.ndim == 2:
            a = a[:, :, None].repeat(3, axis=2)
        a = a[:, :, :3]
        ch = _mip_chain(a)
        chains.append(ch)
        col_w.append(ch[0].shape[1])
        col_h.append(sum(m.shape[0] for m in ch))
    aw = int(sum(col_w)) if k else 1
    ah = int(max(col_h)) if k else 1
    atlas = np.zeros((ah, aw, 3), np.float32)
    x = 0
    for i, ch in enumerate(chains):
        y = 0
        for m, mip in enumerate(ch):
            atlas[y: y + mip.shape[0], x: x + mip.shape[1]] = mip
            if m == 0:
                meta[i, 0] = x
                meta[i, 1] = y
            elif m <= 10:
                meta[i, 5 + m] = y
            y += mip.shape[0]
        meta[i, 2] = ch[0].shape[1]
        meta[i, 3] = ch[0].shape[0]
        meta[i, 4] = len(ch)
        meta[i, 5] = 1.0 if (nearest is not None and nearest[i]) else 0.0
        x += ch[0].shape[1]
    return atlas, meta


def pack_texels(texels: torch.Tensor) -> torch.Tensor:
    """[..., 3] texels → their flat rgb9e5 words as int32 (the uint32 bit
    pattern), the form the samplers read."""
    w = packing.pack_rgb9e5(texels.reshape(-1, 3))
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _floor_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` on floats: fmod, moved into the divisor's sign."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def _level_params(meta_rows: torch.Tensor, level: torch.Tensor):
    """Per-lane (x0, y0, w, h) of mip ``level`` [N] int for gathered meta
    rows [N, 16]."""
    lv = level.clamp(0, MAX_MIPS - 1)
    # 2^-level, exact: the exponent field of a float32 (level is 0..10 here).
    scale = torch.bitwise_left_shift(127 - level.to(torch.int32), 23).view(torch.float32)
    w = torch.clamp_min(torch.floor(meta_rows[:, 2] * scale), 1.0)
    h = torch.clamp_min(torch.floor(meta_rows[:, 3] * scale), 1.0)
    ys = torch.cat([meta_rows[:, 1:2], meta_rows[:, 6:16]], dim=1)  # [N, 11]
    y0 = torch.gather(ys, 1, lv.long()[:, None])[:, 0]
    return meta_rows[:, 0], y0, w, h


def level_taps(meta_rows, uv, level, nearest, atlas_width: int):
    """The four flat texel indices (00, 10, 01, 11) [N] int64 of one mip
    level and the bilinear weights (fu, fv) [N, 1] (0 for nearest lanes)."""
    x0, y0, w, h = _level_params(meta_rows, level)
    u = uv[:, 0] * w - 0.5
    v = uv[:, 1] * h - 0.5
    ui = torch.floor(u)
    vi = torch.floor(v)
    fu = torch.where(nearest, 0.0, u - ui)[:, None]
    fv = torch.where(nearest, 0.0, v - vi)[:, None]
    u_n = torch.where(nearest, torch.round(u), ui)
    v_n = torch.where(nearest, torch.round(v), vi)
    x0i, y0i = x0.long(), y0.long()
    xi0 = _floor_mod(u_n, w).long() + x0i
    yi0 = _floor_mod(v_n, h).long() + y0i
    xi1 = _floor_mod(u_n + 1, w).long() + x0i
    yi1 = _floor_mod(v_n + 1, h).long() + y0i
    r0, r1 = yi0 * atlas_width, yi1 * atlas_width
    return (r0 + xi0, r0 + xi1, r1 + xi0, r1 + xi1), fu, fv


def _bilinear(words, taps, fu, fv):
    i00, i10, i01, i11 = taps
    c00 = packing.unpack_rgb9e5(words[i00])
    c10 = packing.unpack_rgb9e5(words[i10])
    c01 = packing.unpack_rgb9e5(words[i01])
    c11 = packing.unpack_rgb9e5(words[i11])
    return c00 * (1 - fu) * (1 - fv) + c10 * fu * (1 - fv) + c01 * (1 - fu) * fv + c11 * fu * fv


def sample_atlas(words, atlas_width: int, meta, tex_id, uv, lod=None, trilinear: bool = True) -> torch.Tensor:
    """Sample texture ``tex_id`` [N] at ``uv`` [N, 2] and mip level ``lod``
    [N] (float; None → level 0) from the atlas's packed words
    (``pack_texels``) → [N, 3]. tex_id < 0 → white (hit_logic.slang:30-32).
    Trilinear lanes blend levels floor(lod) and the next one; with
    ``lod=None`` both are level 0, as in the reference."""
    rows = meta[torch.clamp_min(tex_id, 0).long()]  # [N, 16]
    nearest = rows[:, 5] > 0.5
    if lod is None:
        lod = torch.zeros(uv.shape[0], dtype=torch.float32, device=uv.device)
    l0, l1, f = mip_levels(rows, lod)
    c0 = _bilinear(words, *level_taps(rows, uv, l0, nearest, atlas_width))
    if trilinear:
        c1 = _bilinear(words, *level_taps(rows, uv, l1, nearest, atlas_width))
        c0 = c0 * (1 - f) + c1 * f
    return torch.where(tex_id[:, None] < 0, 1.0, c0)


def mip_levels(meta_rows, lod):
    """The two levels a trilinear tap blends and the weight of the second:
    (l0 [N] int32, l1 [N] int32, f [N, 1]) for ``lod`` [N] clamped to the
    texture's chain."""
    n_mips = meta_rows[:, 4]
    lod = torch.minimum(torch.clamp_min(lod, 0.0), n_mips - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, torch.clamp_min(n_mips.to(torch.int32) - 1, 0))
    return l0, l1, (lod - l0.to(torch.float32))[:, None]


def sample_texture_array(words, shape, tex_id, uv) -> torch.Tensor:
    """Bilinear wrap sample of texture ``tex_id`` [N] of the legacy texture
    array (every texture at one resolution; ``shape`` = (K, TH, TW), its
    words from ``pack_texels``) at ``uv`` [N, 2] → [N, 3]. tex_id < 0 →
    white."""
    _, th, tw = shape
    safe = torch.clamp_min(tex_id, 0).long()
    x = uv[:, 0] * tw - 0.5
    y = uv[:, 1] * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), tw).long()
    y0i = torch.remainder(y0.to(torch.int32), th).long()
    x1i = torch.remainder(x0i + 1, tw)
    y1i = torch.remainder(y0i + 1, th)
    base = (safe * th + y0i) * tw
    base1 = (safe * th + y1i) * tw
    c = _bilinear(words, (base + x0i, base + x1i, base1 + x0i, base1 + x1i), fx, fy)
    return torch.where(tex_id[:, None] < 0, 1.0, c)


def ray_cone_lod(t, cos_theta, cone_angle: float, log2_texel_density) -> torch.Tensor:
    """Ray-cone mip level: footprint ≈ t · cone_angle / cos θ world units →
    lod = log2(footprint · texels per world unit). ``cone_angle`` is the
    pixel's angular size (≈ vertical fov / image height)."""
    fp = torch.clamp_min(t, 1e-6) * cone_angle / torch.clamp_min(cos_theta, 0.05)
    return torch.log2(torch.clamp_min(fp, 1e-12)) + log2_texel_density


def texel_density_log2(v0, v1, v2, uv0, uv1, uv2, tex_w: float, tex_h: float) -> np.ndarray:
    """Per-triangle log2 texel density, area-weighted (host numpy, at
    ingest)."""
    wa = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    e1 = (uv1 - uv0) * np.array([tex_w, tex_h])
    e2 = (uv2 - uv0) * np.array([tex_w, tex_h])
    ta = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    ratio = np.sqrt(np.maximum(ta, 1e-12) / np.maximum(wa, 1e-12))
    return np.log2(np.maximum(ratio, 1e-12)).astype(np.float32)
