"""The plain reference of the real-time probe-GI frame (the reference
application's ``shaders/old/`` probe stack, as the program's
``render/pipelines.probe_gi_pipeline`` runs it), in plain PyTorch, float32,
for any set of probes: the probes' G-buffer tiles, their ray budgets, their
rays, their atlas texels over the frames, their SH3 coefficients, and the
lit image and the AgX display at the pixels that read them.

A probe is one ``spacing``-by-``spacing`` tile of the screen, anchored at
its top-left pixel. Everything a probe holds depends only on its own tile's
G-buffer, its own rays and its own history: the ray budget on the tile's
normals (``structured_importance_sampling.slang:19-70``), the rays on the
anchor, the budget, the probe's texel ids and the frame's index
(``trace_probes.slang:14-77``), the atlas texels on those rays and on the
probe's texels of the frame before, the SH3 coefficients on the probe's
texels (``spherical_harmonic_conversion.slang:9-33``). A pixel reads the
four probes of its cell (``interpolate_probes.slang:11-110``). So the
reference traces only the probes the pixels it checks read.

Frozen copies of the program's rules, each where the slang files leave a
choice open or the program departs from them:

- The G-buffer (``render/gbuffer.py``) takes pixel centres, no jitter, and
  crosses its passes packed: albedo as 8-8-8 of its square root, the normal
  as 11-10-11 unorm, the emission as rgb9e5; the probe passes read the
  unpacked words. A pixel that misses keeps triangle 0's surface (the
  program clamps a miss's id to 0) and the background depth.
- The ray budget's pdf sums the tile's cosines by halving
  (``probes._sum_last``); the culled third are the lowest by a stable sort
  (ties by index), each retraced at the fine mip in the direction of its
  rank from the top.
- A probe ray leaves the anchor 5e-4 along the anchor's normal faced to the
  camera, picks up the hit's emission, one NEE sample of the light mixture
  (``render/pathtracer._nee_prepare``, the copy in ``render.py``) and the
  sky where it escapes (one bounce: ``probe_bounces`` 1).
- Where two rays of a probe land on one texel, the later ray (by texel
  index) wins (``probes._last_writers``); the slang file leaves the order
  of writes undefined.
- Frame index 0 is a camera cut: blend factor 1, and the texels no ray
  wrote go to 0 (also in the slang file). A probe anchored on the sky holds
  0 and the background depth.
- The SH projection first gives the texels never written since the cut
  their probe's mean written radiance (``probe_sh_fill``; the slang file
  counts them black).
- A pixel no probe weighs is red, a pixel on the sky black; the probes of
  the last row and column are their own neighbours (the edge pad).

``colour_dtype=torch.bfloat16`` is the control: the probe radiance, the
atlas, the SH coefficients and the lit image are rounded to bfloat16 where
they are stored; the geometry stays float32. Set
``torch.backends.cuda.matmul.allow_tf32 = False`` (``no_tf32``) before the
SH projection's products run."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rtbench.reference import bvh as bvh_mod
from rtbench.reference import camera as camera_mod
from rtbench.reference import mathx, packing, render, rng, tonemap
from rtbench.reference import scene as scene_mod

_M32 = 0xFFFFFFFF
BACKGROUND_DEPTH = mathx.BACKGROUND_DEPTH
BUDGET_FRACTION = 1.0 / 3.0
PROBE_TMIN = 5e-4  # trace_probes.slang:55
LANES_PER_CHUNK = 1 << 20


def no_tf32():
    """float32 products in float32, not TF32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Settings(NamedTuple):
    width: int
    height: int
    spacing: int  # pixels a probe side
    res: int  # octahedral texels a probe side
    blendfactor: float
    sh_fill: bool

    @property
    def grid(self) -> tuple[int, int]:
        """(probes across, probes down)."""
        return self.width // self.spacing, self.height // self.spacing


class Ctx(NamedTuple):
    scene: scene_mod.Scene
    bvh: bvh_mod.Bvh
    settings: Settings
    colour_dtype: Optional[torch.dtype]


def _rc(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    if ctx.colour_dtype is None:
        return x
    return x.to(ctx.colour_dtype).to(torch.float32)


# -- codecs (ops/packing.py) -------------------------------------------------


def _unorm(v: torch.Tensor, bits: int) -> torch.Tensor:
    """A value in [0, 1] through an unsigned ``bits``-bit word and back."""
    m = (1 << bits) - 1
    return ((torch.clamp(v, 0.0, 1.0) * m + 0.5).to(torch.int64) & m).to(torch.float32) / m


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def packed_albedo(c: torch.Tensor) -> torch.Tensor:
    """The albedo through its 8-8-8 word of square roots."""
    s = _sqrt_rn(torch.clamp_min(c, 0.0))
    u = torch.stack([_unorm(s[..., i], 8) for i in range(3)], dim=-1)
    return u * u


def packed_normal(n: torch.Tensor) -> torch.Tensor:
    """The normal through its 11-10-11 word."""
    q = torch.stack([_unorm(n[..., 0] * 0.5 + 0.5, 11), _unorm(n[..., 1] * 0.5 + 0.5, 10),
                     _unorm(n[..., 2] * 0.5 + 0.5, 11)], dim=-1) * 2.0 - 1.0
    return mathx.normalize(q)


def octa_decode(f: torch.Tensor) -> torch.Tensor:
    """Octahedral UV in [0, 1]² → unit direction (packing.slang:77-87)."""
    f = f * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, 0.0, 1.0)
    sign_xy = torch.where(f >= 0.0, 1.0, -1.0)
    xy = f - sign_xy * t[..., None]
    return mathx.normalize(torch.cat([xy, z[..., None]], dim=-1))


def octa_grid(res: int, device) -> torch.Tensor:
    """[res², 3] directions at the texel centres, row by row."""
    u = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    return octa_decode(torch.stack([uu, vv], dim=-1)).reshape(res * res, 3)


# -- SH3 (ops/sh.py) ------------------------------------------------------------

_C0 = 0.28209479177387814347403972578039
_C1 = 0.48860251190291992158638462283836
_C2 = 1.09254843059207907054338570580268
_C3 = 0.31539156525252000603089369029571
_C4 = 0.54627421529603953527169285290134
_COS_LOBE = (math.pi, 2.0943951023931954923, 2.0943951023931954923, 2.0943951023931954923,
             0.7853981633974483096, 0.7853981633974483096, 0.7853981633974483096,
             0.7853981633974483096, 0.7853981633974483096)


def sh3(d: torch.Tensor) -> torch.Tensor:
    """The second-order SH basis [..., 9] (spherical_harmonics.slang:30-46)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, _C0), -_C1 * y, _C1 * z, -_C1 * x, _C2 * x * y, _C2 * y * z,
                        _C3 * (3.0 * z * z - 1.0), _C2 * x * z, _C4 * (x * x - y * y)], dim=-1)


def sh3_cos_lobe(n: torch.Tensor) -> torch.Tensor:
    """The basis at ``n`` convolved with the clamped cosine
    (spherical_harmonics.slang:72-89)."""
    return sh3(n) * mathx.const(_COS_LOBE, torch.float32, n.device)


# -- the pieces ---------------------------------------------------------------


def tile_pixels(settings: Settings, probes: torch.Tensor) -> torch.Tensor:
    """[P, s², 2] pixel (x, y) of each probe's tile, row by row; pixel 0 is
    the anchor."""
    sp = settings.spacing
    px = settings.grid[0]
    a = torch.arange(sp, device=probes.device)
    ty, tx = torch.meshgrid(a, a, indexing="ij")
    x = (probes % px * sp)[:, None] + tx.reshape(1, -1)
    y = (probes // px * sp)[:, None] + ty.reshape(1, -1)
    return torch.stack([x, y], dim=-1)


def gbuffer_of(ctx: Ctx, o: torch.Tensor, d: torch.Tensor) -> dict:
    """The G-buffer of pixel-centre rays (o, d) [M, 3] through the
    reference's tree: the rays, the depth, and the albedo, normal and
    emission as the probe passes read them back from the packed words."""
    hit, t, u, v, prim = bvh_mod.trace(ctx.bvh, o, d)
    s = scene_mod.hit_surface_info(ctx.scene, prim, torch.stack([u, v], dim=-1))
    return {"o": o, "d": d, "depth": t, "albedo": packed_albedo(s.albedo), "normal": packed_normal(s.normal),
            "emissive": packing.unpack_rgb9e5(packing.pack_rgb9e5(s.emissive))}


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        y = x[..., :half] + x[..., half:2 * half]
        x = torch.cat([y, x[..., 2 * half:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def ray_budget(settings: Settings, tile_normals: torch.Tensor):
    """(direction index, fine-mip bit) [P, R²] of probes whose tiles have
    the normals ``tile_normals`` [P, s², 3]."""
    r, sp = settings.res, settings.spacing
    rr = r * r
    dirs = octa_grid(r, tile_normals.device).reshape(1, rr, 1, 3)
    tiles = tile_normals[:, None]
    dots = tiles[..., 0] * dirs[..., 0] + tiles[..., 1] * dirs[..., 1] + tiles[..., 2] * dirs[..., 2]
    pdf = torch.clamp_min(_sum_last(dots), 0.0) / (sp * sp)
    order = torch.argsort(pdf, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    culled = ranks < int(rr * BUDGET_FRACTION)
    target = torch.gather(torch.flip(order, dims=[-1]), -1, torch.clamp(ranks, 0, rr - 1))
    fine_idx = (target // r) * 2 * (2 * r) + (target % r) * 2
    base_idx = torch.arange(rr, device=pdf.device).expand(pdf.shape)
    return torch.where(culled, fine_idx, base_idx), culled.to(torch.int64)


class Rays(NamedTuple):
    """One probe's rays of one frame, [P, R²]."""

    origin: torch.Tensor  # [P, R², 3]
    direction: torch.Tensor  # [P, R², 3]
    texel: torch.Tensor  # [P, R²] the atlas texel each writes, ty·R + tx
    seed: torch.Tensor  # [P, R²] the sampler's seed words


def probe_rays(settings: Settings, probes, anchor: dict, dir_index, mip, frame_word: int) -> Rays:
    """The rays of probes ``probes`` [P] (ids in the full grid, row by row)
    with anchors ``anchor`` (each [P, ...] of the G-buffer) and budgets
    ``dir_index``, ``mip`` [P, R²] in the frame of word ``frame_word``."""
    r = settings.res
    rr = r * r
    ids = probes[:, None] * rr + torch.arange(rr, device=probes.device)
    seed = (rng.jenkins_hash(ids) + frame_word) & _M32
    sampler = rng.Sampler(seed=seed, index=0)
    u0, sampler = sampler.next1()
    u1, sampler = sampler.next1()
    uj = torch.stack([u0, u1], dim=-1)
    fine = mip == 1
    size = torch.where(fine, 2.0 * r, float(r))
    dx = torch.where(fine, dir_index % (2 * r), dir_index % r).to(torch.float32)
    dy = torch.where(fine, torch.div(dir_index, 2 * r, rounding_mode="floor"),
                     torch.div(dir_index, r, rounding_mode="floor")).to(torch.float32)
    d = octa_decode((torch.stack([dx, dy], dim=-1) + uj) / size[..., None])
    pos = anchor["o"] + anchor["d"] * anchor["depth"][:, None]
    nrm = render._face_forward(anchor["normal"], -anchor["d"])
    o = (pos + nrm * PROBE_TMIN)[:, None, :].expand(d.shape)
    tex_x = torch.clamp(dx / size * r, 0, r - 1).to(torch.int64)
    tex_y = torch.clamp(dy / size * r, 0, r - 1).to(torch.int64)
    return Rays(origin=o, direction=d, texel=tex_y * r + tex_x, seed=seed)


def probe_radiance(ctx: Ctx, o: torch.Tensor, d: torch.Tensor, seed: torch.Tensor):
    """(radiance [M, 3], hit distance [M]) of probe rays [M]: the hit's
    emission and one NEE sample, the sky where it escapes. The sampler
    continues after the ray's two jitter draws."""
    rctx = render.Ctx(scene=ctx.scene, bvh=ctx.bvh, settings=None, colour_dtype=ctx.colour_dtype)
    hit, t, u, v, prim = bvh_mod.trace(ctx.bvh, o, d)
    s = scene_mod.hit_surface_info(ctx.scene, prim, torch.stack([u, v], dim=-1))
    sampler = rng.Sampler(seed=seed, index=2)
    pos = o + t[:, None] * d
    nrm = render._face_forward(s.normal, -d)
    u3, sampler = sampler.next3()
    sh_o, sh_d, sh_t, pre_ok, contrib, _ = render._nee_prepare(rctx, pos, nrm, -d, s, u3, sampler, hit)
    blocked = bvh_mod.trace(ctx.bvh, sh_o, sh_d, t_max=sh_t, any_hit=True)[0]
    radiance = s.emissive + torch.where((pre_ok & ~blocked)[:, None], contrib, 0.0)
    return _rc(ctx, torch.where(hit[:, None], radiance, render._sample_env(ctx.scene, d))), t


def blend_atlas(ctx: Ctx, atlas, depth, texel, radiance, t, valid, cut: bool):
    """The atlas [P, R², 3] and its depths [P, R²] after one frame of each
    probe's rays (their texels, radiance and hit distances, [P, R²]), for
    probes ``valid`` [P] anchored on a surface."""
    rr = texel.shape[1]
    lane = torch.arange(rr, device=texel.device).expand(texel.shape)
    last = torch.full(texel.shape, -1, dtype=torch.int64, device=texel.device)
    last = last.scatter_reduce(1, texel, lane, reduce="amax")
    written = last >= 0
    src = last.clamp_min(0)
    new = torch.gather(radiance, 1, src[..., None].expand(src.shape + (3,)))
    new_t = torch.gather(t, 1, src)
    bf = torch.full((), 1.0 if cut else ctx.settings.blendfactor, dtype=torch.float32, device=texel.device)
    keep = torch.full((), 0.0 if cut else 1.0, dtype=torch.float32, device=texel.device)
    blended = torch.where(written[..., None], atlas + (new - atlas) * bf, atlas * keep)
    depth = torch.where(written, new_t, depth * keep)
    return (_rc(ctx, torch.where(valid[:, None, None], blended, 0.0)),
            torch.where(valid[:, None], depth, BACKGROUND_DEPTH))


def project_sh(ctx: Ctx, atlas: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """[..., 3, 9] SH3 coefficients of atlases [..., R², 3] with depths
    [..., R²]."""
    r = ctx.settings.res
    if ctx.settings.sh_fill:
        written = (depth > 0.0)[..., None]
        wsum = written.sum(dim=-2, keepdim=True).to(torch.float32)
        mean = torch.where(written, atlas, 0.0).sum(dim=-2, keepdim=True) / torch.clamp_min(wsum, 1.0)
        atlas = torch.where(written, atlas, mean)
    basis = sh3(octa_grid(r, atlas.device))
    return _rc(ctx, torch.einsum("...dc,dk->...ck", atlas, basis) * (4.0 * math.pi / (r * r)))


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def neighbours(settings: Settings, pix: torch.Tensor) -> torch.Tensor:
    """[M, 4] the probes pixel (x, y) [M, 2] reads, (0, 0), (0, 1), (1, 0),
    (1, 1) from its cell, clipped to the grid."""
    px, py = settings.grid
    cx, cy = pix[:, 0] // settings.spacing, pix[:, 1] // settings.spacing
    return torch.stack([torch.clamp(cy + oy, max=py - 1) * px + torch.clamp(cx + ox, max=px - 1)
                        for oy in (0, 1) for ox in (0, 1)], dim=-1)


def interpolate(ctx: Ctx, pix, gb: dict, anchor_depth, anchor_normal, coeffs) -> torch.Tensor:
    """The lit image [..., M, 3] at pixels ``pix`` [M, 2] with G-buffer
    ``gb`` (each [M, ...]), from the anchors' depths [M, 4] and normals
    [M, 4, 3] of the four probes each reads and their SH coefficients
    [..., M, 4, 3, 9]."""
    sp = ctx.settings.spacing
    f = torch.arange(sp, dtype=torch.float32, device=pix.device) / sp
    fx, fy = f[pix[:, 0] % sp], f[pix[:, 1] % sp]
    dep, nrm = gb["depth"], gb["normal"]
    basis = sh3_cos_lobe(nrm)
    contribs, weights = [], []
    for j, (oy, ox) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        pdep, pnrm = anchor_depth[:, j], anchor_normal[:, j]
        w_bil = (fx if ox else (1.0 - fx)) * (fy if oy else (1.0 - fy))
        wgt = torch.clamp(1.0 - torch.abs(pdep - dep) / torch.clamp_min(dep, 1e-6), 0.0, 1.0)
        wgt = wgt * torch.clamp_min((nrm * pnrm).sum(dim=-1), 0.0)
        weights.append(torch.where(pdep < BACKGROUND_DEPTH, (w_bil + 1e-3) * _pow8(wgt), 0.0))
        contribs.append(torch.clamp_min((coeffs[..., j, :, :] * basis[:, None, :]).sum(dim=-1), 0.0))
    wstack = torch.stack(weights)
    wsum = wstack.sum(dim=0)
    wnorm = wstack / torch.clamp_min(wsum, 1e-8)
    irr = sum(c * wn[..., None] for c, wn in zip(contribs, wnorm))
    light = irr * gb["albedo"] * mathx.INV_PI + gb["emissive"]
    red = torch.zeros_like(light)
    red[..., 0] = 1.0
    light = torch.where((wsum <= 1e-8)[..., None], red, light)
    return _rc(ctx, torch.where((dep >= BACKGROUND_DEPTH)[..., None], 0.0, light))


def display(light: torch.Tensor) -> torch.Tensor:
    """AgX ("punchy"), as ``postprocess.postprocess``."""
    return tonemap.agx_tonemap(light, look="punchy")


# -- frames --------------------------------------------------------------------


def frame_words(moved: list) -> list:
    """The pipeline's frame index of each frame: the film's count, which
    restarts at 0 on frame 0 and on every frame whose camera moved."""
    out, n = [], 0
    for k, m in enumerate(moved):
        n = 0 if (k == 0 or m) else n + 1
        out.append(n)
    return out


def frames(ctx: Ctx, cams: list, moved: list, pix_flat: torch.Tensor):
    """(light, display) [n, M, 3] at pixels ``pix_flat`` [M] (y·W + x) after
    each of the frames with cameras ``cams`` (one a frame) whose camera
    moved where ``moved``: only the probes those pixels read are traced.
    Frames between two moves share a pose and its G-buffer; the probe rays
    of many frames go to one launch."""
    st = ctx.settings
    dev = pix_flat.device
    rr = st.res * st.res
    sp2 = st.spacing * st.spacing
    pix = torch.stack([pix_flat % st.width, pix_flat // st.width], dim=-1)
    probes, slot = torch.unique(neighbours(st, pix), return_inverse=True)  # slot: each neighbour's row of probes
    p = probes.shape[0]
    own = slot[:, 0]  # the row of each pixel's own cell's probe, whose tile holds the pixel
    cell_of = (pix[:, 1] % st.spacing) * st.spacing + pix[:, 0] % st.spacing
    starts = [k for k, m in enumerate(moved) if k == 0 or m]
    pose_of = [sum(1 for s0 in starts if s0 <= k) - 1 for k in range(len(cams))]
    words = frame_words(moved)

    # Each pose: the probes' tiles traced (a chunk of poses to a launch),
    # kept as the anchors, the ray budgets and the checked pixels' G-buffer.
    tiles = tile_pixels(st, probes).reshape(-1, 2)
    per_chunk = max(1, LANES_PER_CHUNK // tiles.shape[0])
    poses = []
    for a in range(0, len(starts), per_chunk):
        ks = starts[a:a + per_chunk]
        o, d = zip(*(camera_mod.primary_rays(cams[k], st.width, st.height, pixel_xy=tiles) for k in ks))
        g = gbuffer_of(ctx, torch.cat(o), torch.cat(d))
        for i in range(len(ks)):
            gi = {key: v[i * tiles.shape[0]:(i + 1) * tiles.shape[0]].reshape((p, sp2) + v.shape[1:])
                  for key, v in g.items()}
            poses.append({"anchor": {key: v[:, 0] for key, v in gi.items()},
                          "budget": ray_budget(st, gi["normal"]),
                          "pixels": {key: gi[key][own, cell_of] for key in ("depth", "albedo", "normal", "emissive")}})

    # The frames in order, many to a launch of probe rays: the atlas frame
    # by frame, then the SH and the lit image of the launch's frames.
    atlas = torch.zeros((p, rr, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((p, rr), dtype=torch.float32, device=dev)
    per_launch = max(1, LANES_PER_CHUNK // (p * rr))
    lights = []
    for a in range(0, len(cams), per_launch):
        ks = range(a, min(len(cams), a + per_launch))
        rays = [probe_rays(st, probes, poses[pose_of[k]]["anchor"], *poses[pose_of[k]]["budget"], words[k])
                for k in ks]
        rad, t = probe_radiance(ctx, torch.cat([r.origin.reshape(-1, 3) for r in rays]),
                                torch.cat([r.direction.reshape(-1, 3) for r in rays]),
                                torch.cat([r.seed.reshape(-1) for r in rays]))
        rad, t = rad.reshape(len(ks), p, rr, 3), t.reshape(len(ks), p, rr)
        atlases, depths = [], []
        for i, k in enumerate(ks):
            anchor = poses[pose_of[k]]["anchor"]
            atlas, depth = blend_atlas(ctx, atlas, depth, rays[i].texel, rad[i], t[i],
                                       anchor["depth"] < BACKGROUND_DEPTH, words[k] == 0)
            atlases.append(atlas)
            depths.append(depth)
        coeffs = project_sh(ctx, torch.stack(atlases), torch.stack(depths))  # [frames, P, 3, 9]
        for i, k in enumerate(ks):
            q = poses[pose_of[k]]
            lights.append(interpolate(ctx, pix, q["pixels"], q["anchor"]["depth"][slot], q["anchor"]["normal"][slot],
                                      coeffs[i][slot]))
    light = torch.stack(lights)
    return light, display(light)
