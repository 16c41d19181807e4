"""The plain reference of the benchmark's frames: per-lane path tracing of a
sample of pixels, the progressive film and the AgX display, in plain
PyTorch, float32.

A lane is one path: (pixel, frame, sample). Its radiance depends on those
alone: the sampler is seeded by the pixel's Z-curve hash and the frame's
word, the jitter is the blue-noise texel of the pixel, and every draw comes
in the same order for every lane. So the reference traces only the pixels
it checks, for every frame of the window, and folds each frame into the
film as the program's blend does. The bounce loop follows
``raytracer3_tpu_torch/render/wavefront.py`` (split NEE launches on the
middle bounces, the last bounce and its shadow batch as one any-hit test,
the lane diet's rgb9e5 rounding at each launch where the settings ask for
it), the sky and NEE helpers ``render/pathtracer.py``, the blend
``render/pipelines._blend`` and the display ``render/postprocess`` (frozen
copies); the hits come from ``rtbench.reference.bvh``.

``colour_dtype=torch.bfloat16`` is the control: every colour quantity
(radiance, throughputs, NEE contributions, the film) is rounded to
bfloat16 where it is stored, the geometry stays float32."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rtbench.reference import brdf, bvh as bvh_mod, mathx, packing, rng, tonemap
from rtbench.reference import scene as scene_mod

_M32 = 0xFFFFFFFF
BACKGROUND_DEPTH = mathx.BACKGROUND_DEPTH


class Settings(NamedTuple):
    """The render settings the reference reads."""

    width: int
    height: int
    bounces: int
    samples: int
    radiance_clamp: float
    lane_diet: bool


class Ctx(NamedTuple):
    scene: scene_mod.Scene
    bvh: bvh_mod.Bvh
    settings: Settings
    colour_dtype: Optional[torch.dtype]


def _rc(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """A stored colour: float32, or rounded through the control's dtype."""
    if ctx.colour_dtype is None:
        return x
    return x.to(ctx.colour_dtype).to(torch.float32)


def _closest(ctx: Ctx, o, d):
    return bvh_mod.trace(ctx.bvh, o, d)


def _occluded(ctx: Ctx, o, d, t_max):
    return bvh_mod.trace(ctx.bvh, o, d, t_max=t_max, any_hit=True)[0]


def _diet(ctx: Ctx, *cols):
    """The lane diet's rounding of colour state across a launch: through
    rgb9e5 (``wavefront._diet_pack`` then ``_diet_unpack``)."""
    if not ctx.settings.lane_diet:
        return cols
    return tuple(packing.unpack_rgb9e5(packing.pack_rgb9e5(c)) for c in cols)


# -- sky and NEE (pathtracer.py) -------------------------------------------


def _texel(directions, he: int, we: int) -> torch.Tensor:
    uv = mathx.direction_to_equirect_uv(directions)
    x = torch.clamp((uv[..., 0] * we).to(torch.int64), 0, we - 1)
    y = torch.clamp((uv[..., 1] * he).to(torch.int64), 0, he - 1)
    return y * we + x


def _sample_env(scene, directions):
    he, we = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]
    packed = packing.pack_rgb9e5(scene.env_rgbp[..., 0:3].reshape(-1, 3))
    return packing.unpack_rgb9e5(packed[_texel(directions, he, we)])


def _env_radiance_pdf(scene, directions):
    he, we = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]
    env = scene.env_rgbp[..., 0:3]
    rgb = packing.unpack_rgb9e5(packing.pack_rgb9e5(env.reshape(-1, 3))[_texel(directions, he, we)])
    lum_map = 0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2]
    theta = (torch.arange(he, dtype=torch.float32, device=env.device) + 0.5) / he * math.pi
    total = torch.sum(torch.clamp_min(lum_map, 0.0) * torch.sin(theta)[:, None])
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    k = we * he / (2.0 * math.pi * math.pi * torch.clamp_min(total, 1e-12))
    return rgb, lum * k


def _env_row_consume(row, kc, u3c, he: int, we: int):
    take_alias = (u3c[:, 1] >= row[:, 0])[:, None]
    idx = torch.where(take_alias[:, 0], row[:, 1].to(torch.int64), kc)
    pdf = torch.where(take_alias[:, 0], row[:, 6], row[:, 2])
    radiance = torch.where(take_alias, row[:, 7:10], row[:, 3:6])
    y = torch.div(idx, we, rounding_mode="floor")
    x = idx % we
    ju = u3c[:, 2]
    prob = row[:, 0]
    jv = torch.where(
        take_alias[:, 0],
        (u3c[:, 1] - prob) / torch.clamp_min(1.0 - prob, 1e-9),
        u3c[:, 1] / torch.clamp_min(prob, 1e-9),
    )
    jv = torch.clamp(jv, 0.0, 0.999999)
    uv = torch.stack([(x.to(torch.float32) + ju) / we, (y.to(torch.float32) + jv) / he], dim=-1)
    return mathx.equirect_uv_to_direction(uv), radiance, pdf


def _face_forward(normal, wo_world):
    return normal * torch.where(mathx.dot(normal, wo_world) < 0.0, -1.0, 1.0)


Q_ENV = 0.5  # NEE picks the sky over the area lights with this probability


def _nee_prepare(ctx: Ctx, hit_pos, normal, wo_world, surface, u3, sampler, alive_mask):
    """One-sample NEE over the mixture of area lights and the alias-sampled
    sky, without its shadow test: (shadow_o, shadow_d, t_shadow, pre_ok,
    contrib, sampler)."""
    scene = ctx.scene
    em = scene.lights
    u_env, sampler = sampler.next3()
    u_sel, sampler = sampler.next1()
    choose_env = u_sel < Q_ENV
    tab = scene.env_sample_table
    k_env = torch.clamp((u_env[:, 0] * tab.shape[0]).to(torch.int64), 0, tab.shape[0] - 1)
    li = torch.clamp(torch.searchsorted(em.cdf, u3[:, 0].contiguous()), 0, em.cdf.shape[0] - 1)
    row = torch.cat([em.light_table, tab], dim=0)[torch.where(choose_env, em.light_table.shape[0] + k_env, li)]
    v0, e1, e2, le_a = row[:, 0:3], row[:, 3:6], row[:, 6:9], row[:, 9:12]
    su = torch.sqrt(torch.clamp_min(u3[:, 1:2], 0.0))
    b0 = 1.0 - su
    b1 = u3[:, 2:3] * su
    b2 = 1.0 - b0 - b1
    p = v0 + e1 * b1 + e2 * b2
    to_l = p - hit_pos
    dist2 = to_l[:, 0:1] * to_l[:, 0:1] + to_l[:, 1:2] * to_l[:, 1:2] + to_l[:, 2:3] * to_l[:, 2:3]
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
    wi_a = to_l / dist
    l_nrm = mathx.normalize(mathx.cross(e1, e2))
    cos_l = torch.abs(mathx.dot(l_nrm, -wi_a, keepdims=False))
    pdf_a = dist2[:, 0] / torch.clamp_min(cos_l * em.total_area, 1e-20)
    valid_a = (row[:, 12] > 0.5) & (cos_l > 1e-6) & (pdf_a > 0.0)
    t_a = dist[:, 0] * (1.0 - 1e-3)
    he, we = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]
    wi_e, le_e, pdf_e = _env_row_consume(row, k_env, u_env, he, we)
    ce3 = choose_env[:, None]
    wi_world = torch.where(ce3, wi_e, wi_a)
    le_sel = torch.where(ce3, le_e, le_a)
    pdf_sel = torch.where(choose_env, Q_ENV * pdf_e, (1.0 - Q_ENV) * pdf_a)
    valid_sel = torch.where(choose_env, pdf_e > 0.0, valid_a)
    t_shadow = torch.where(choose_env, BACKGROUND_DEPTH * 0.9, t_a)

    cos_s = mathx.dot(normal, wi_world, keepdims=False)
    onb = mathx.build_orthonormal_basis(normal)
    wo_l = mathx.to_local(onb, wo_world)
    wi_l = mathx.to_local(onb, wi_world)
    ev = brdf.surface_evaluate(surface.albedo, surface.roughness, surface.metalness, wo_l, wi_l)
    pdf_brdf = ev.pdf * torch.clamp_min(wi_l[..., 2], 0.0)
    mis_w = pdf_sel / torch.clamp_min(pdf_sel + pdf_brdf, 1e-20)
    pre_ok = valid_sel & (cos_s > 0.0) & alive_mask
    contrib = _rc(ctx, ev.value * le_sel * (cos_s * mis_w / torch.clamp_min(pdf_sel, 1e-20))[:, None])
    shadow_o = torch.where(pre_ok[:, None], hit_pos + normal * 1e-3, 1e30)
    return shadow_o, wi_world, t_shadow, pre_ok, contrib, sampler


# -- the bounce loop (wavefront.py) ----------------------------------------


class Queue(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    prev_pdf: torch.Tensor
    depth: torch.Tensor
    prim_id: torch.Tensor
    uv: torch.Tensor


def _bounce_loop(ctx: Ctx, q: Queue, sampler, rr_start: int = 3) -> torch.Tensor:
    """Radiance [M, 3] of the lanes whose first hit is recorded in ``q``."""
    scene, st = ctx.scene, ctx.settings
    nb = int(st.bounces)
    for b in range(nb):
        tail = b == nb - 1
        surface = scene_mod.hit_surface_info(scene, q.prim_id, q.uv)
        nrm = _face_forward(surface.normal, -q.direction)
        cos_l = torch.abs(mathx.dot(nrm, -q.direction, keepdims=False))
        pdf_light = (1.0 - Q_ENV) * (q.depth * q.depth) / torch.clamp_min(cos_l * scene.lights.total_area, 1e-20)
        is_emitter = torch.amax(surface.emissive, dim=-1) > 0.0
        w = q.prev_pdf / torch.clamp_min(q.prev_pdf + pdf_light, 1e-20)
        emit_w = torch.where(is_emitter & (b > 0), w, 1.0)
        radiance = _rc(ctx, q.radiance + torch.where(q.alive[:, None], q.throughput * surface.emissive * emit_w[:, None],
                                                     0.0))
        onb = mathx.build_orthonormal_basis(nrm)
        hit_pos = q.origin + q.depth[:, None] * q.direction

        u_l, sampler = sampler.next3()
        sh_o, sh_d, sh_t, pre_ok, contrib, sampler = _nee_prepare(
            ctx, hit_pos, nrm, -q.direction, surface, u_l, sampler, q.alive)
        q_throughput = q.throughput
        if not tail:
            # Split NEE: the shadow batch's own launch, the colour state
            # crossing it through the diet.
            radiance, q_thr, contrib = _diet(ctx, radiance, q.throughput, contrib)
            blocked = _occluded(ctx, sh_o, sh_d, sh_t)
            li = torch.where((pre_ok & ~blocked)[:, None], contrib, 0.0)
            radiance = _rc(ctx, radiance + torch.where(q.alive[:, None], q_thr * li, 0.0))

        u3, sampler = sampler.next3()
        s = brdf.surface_sample(surface.albedo, surface.roughness, surface.metalness,
                                mathx.to_local(onb, -q.direction), u3)
        new_dir = mathx.to_world(onb, s.wi)
        throughput = _rc(ctx, q.throughput * s.value_over_pdf)
        prev_pdf = torch.clamp_min(s.pdf * torch.abs(s.wi[..., 2]), 1e-8)
        alive = q.alive & s.valid & (torch.amax(throughput, dim=-1) > 0.0)
        u_rr, sampler = sampler.next1()
        if b >= rr_start:
            p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
            survive = u_rr < p_cont
            throughput = _rc(ctx, torch.where(survive[:, None], throughput / torch.clamp_min(p_cont, 1e-6)[:, None],
                                              throughput))
            alive = alive & survive

        park = torch.where(alive[:, None], hit_pos, 1e30)
        m = park.shape[0]
        bg = torch.full((m,), BACKGROUND_DEPTH, dtype=torch.float32, device=park.device)
        if tail:
            # The last bounce's escape test and its shadow batch: one any-hit
            # launch in the program, across which the diet rounds.
            radiance, q_throughput, contrib, throughput = _diet(ctx, radiance, q_throughput, contrib, throughput)
            blocked = _occluded(ctx, sh_o, sh_d, sh_t)
            radiance = _rc(ctx, radiance + torch.where((q.alive & pre_ok & ~blocked)[:, None], q_throughput * contrib,
                                                       0.0))
            hit = _occluded(ctx, park, new_dir, bg)
            t = bg
            prim = torch.where(hit, 0, -1)
            uv = torch.zeros((m, 2), dtype=torch.float32, device=park.device)
        else:
            radiance, throughput = _diet(ctx, radiance, throughput)
            hit, t, u, v, prim = _closest(ctx, park, new_dir)
            uv = torch.stack([u, v], dim=-1)
        env, env_pdf = _env_radiance_pdf(scene, new_dir)
        w_env = prev_pdf / torch.clamp_min(prev_pdf + Q_ENV * env_pdf, 1e-20)
        env = env * w_env[:, None]
        radiance = _rc(ctx, radiance + torch.where((alive & ~hit)[:, None], throughput * env, 0.0))
        q = Queue(origin=hit_pos, direction=new_dir, throughput=throughput, radiance=radiance, alive=alive & hit,
                  prev_pdf=prev_pdf, depth=t, prim_id=prim, uv=uv)
    return q.radiance


def primaries(ctx: Ctx, cam, pix: torch.Tensor, fi: torch.Tensor, blue_noise: torch.Tensor):
    """Primary rays (o, d) [M, 3] of lanes at pixels ``pix`` [M, 2] with
    frame words ``fi`` [M] (the frame's word · samples + the sample, as
    ``wavefront.sample_rays`` forms it) under camera ``cam``: the pixel
    centre jittered by the blue-noise texel, rotated by the frame word."""
    from rtbench.reference import camera as camera_mod

    bw = blue_noise.shape[0]
    bx = pix[:, 0].long() % bw
    by = pix[:, 1].long() % bw
    b0 = rng.animate_blue_noise(blue_noise[by, bx], fi)
    b1 = rng.animate_blue_noise(blue_noise[bx, by], (fi + 7919) & _M32)
    st = ctx.settings
    return camera_mod.primary_rays(cam, st.width, st.height, jitter=torch.stack([b0, b1], dim=-1), pixel_xy=pix)


def lane_radiance(ctx: Ctx, o, d, pix: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """Radiance [M, 3] of lanes with primary rays (o, d), at pixels ``pix``
    with frame words ``fi`` (their sampler's seeds): the primary trace, the
    bounce loop, the clamp and the sky of primary misses."""
    st = ctx.settings
    sampler = rng.Sampler.from_pixels(pix, fi)
    hit, t, u, v, prim = _closest(ctx, o, d)
    m = o.shape[0]
    one = torch.ones((m, 3), dtype=torch.float32, device=o.device)
    q = Queue(origin=o, direction=d, throughput=one, radiance=torch.zeros_like(one), alive=hit,
              prev_pdf=torch.full((m,), 1e8, dtype=torch.float32, device=o.device), depth=t, prim_id=prim,
              uv=torch.stack([u, v], dim=-1))
    radiance = _bounce_loop(ctx, q, sampler)
    if st.radiance_clamp > 0.0:
        radiance = torch.clamp_max(radiance, st.radiance_clamp)
    return _rc(ctx, radiance + torch.where(~hit[:, None], _sample_env(ctx.scene, d), 0.0))


def blend(ctx: Ctx, film: torch.Tensor, radiance: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The film after a frame: ``film + (radiance − film)·(1/(n + 1))`` with
    the frame count n a float32 tensor, as ``pipelines._blend``."""
    return _rc(ctx, film + (radiance - film) * (1.0 / (n + 1.0)))


def display(film: torch.Tensor) -> torch.Tensor:
    """AgX ("punchy") of the film, as ``postprocess.postprocess``."""
    return tonemap.agx_tonemap(film, look="punchy")
