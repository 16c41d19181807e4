"""Reference-mode path tracer and the environment and NEE helpers (port of
``raytracer3_tpu/render/pathtracer.py``).

``trace_gbuffer`` traces the primary rays into a ``GBuffer``;
``trace_radiance`` runs samples × bounces as masked steps over the whole ray
batch (refrence_mode.slang:14-66) with MIS-weighted emissive pickup, NEE
when an occlusion trace is given, env MIS on secondary misses and
``radiance_clamp``; ``render_image`` is one frame of it. The wavefront
tracer (render/wavefront.py) and the probes (render/probes.py) share the
env and NEE helpers."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from raytracer3_tpu_torch.ops import brdf, intersect, mathx, packing, rng
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.scene import types as scene_types

IntersectFn = Callable[[torch.Tensor, torch.Tensor], intersect.Hit]
OccludedFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _texel(directions, he: int, we: int) -> torch.Tensor:
    uv = mathx.direction_to_equirect_uv(directions)
    x = torch.clamp((uv[..., 0] * we).to(torch.int64), 0, we - 1)
    y = torch.clamp((uv[..., 1] * he).to(torch.int64), 0, he - 1)
    return y * we + x


def _sample_env(scene: scene_types.Scene, directions: torch.Tensor) -> torch.Tensor:
    """Equirect skybox lookup, quantised through rgb9e5 as the reference
    does (postprocess.slang:104; math.slang:6-12)."""
    if scene.env_map is None:
        return torch.zeros(directions.shape[:-1] + (3,), dtype=torch.float32, device=directions.device)
    he, we = scene.env_map.shape[0], scene.env_map.shape[1]
    packed = packing.pack_rgb9e5(scene.env_map.reshape(-1, 3))
    return packing.unpack_rgb9e5(packed[_texel(directions, he, we)])


def _env_radiance_pdf(scene: scene_types.Scene, directions: torch.Tensor):
    """(rgb9e5-quantised radiance, solid-angle pdf) of the environment along
    ``directions`` — the env-MIS lookup for BRDF-sampled escapes. The pdf is
    recomputed from the quantised luminance exactly as the reference does:
    pdf = lum · We·He / (2π² · Σ lum·sinθ)."""
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
    """Alias-table row → (direction, radiance, solid-angle pdf)."""
    take_alias = (u3c[:, 1] >= row[:, 0])[:, None]
    idx = torch.where(take_alias[:, 0], row[:, 1].to(torch.int64), kc)
    pdf = torch.where(take_alias[:, 0], row[:, 6], row[:, 2])
    radiance = torch.where(take_alias, row[:, 7:10], row[:, 3:6])
    y = torch.div(idx, we, rounding_mode="floor")
    x = idx % we
    # Jitter within the texel; jv reuses the alias-test uniform rescaled to
    # its conditional range.
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


def _env_pick(n_tex: int, u0: torch.Tensor) -> torch.Tensor:
    return torch.clamp((u0 * n_tex).to(torch.int64), 0, n_tex - 1)


def _sample_env_light(scene: scene_types.Scene, u3: torch.Tensor):
    """Importance-sample the environment via the alias table → (direction,
    radiance, solid-angle pdf)."""
    tab = scene.env_sample_table
    he, we = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]
    k = _env_pick(tab.shape[0], u3[:, 0])
    return _env_row_consume(tab[k], k, u3, he, we)


def _face_forward(normal: torch.Tensor, wo_world: torch.Tensor) -> torch.Tensor:
    """Flip shading normals facing away from the viewer (two-sided shading)."""
    return normal * torch.where(mathx.dot(normal, wo_world) < 0.0, -1.0, 1.0)


def _env_mix_q(scene: scene_types.Scene) -> float:
    """Probability of NEE picking the environment over the area lights."""
    if scene.env_sample_table is None:
        return 0.0
    if int(scene.emissive.tri_ids.shape[0]) == 0:
        return 1.0
    return 0.5


def _nee_prepare(scene, hit_pos, normal, wo_world, surface, u3, sampler: rng.Sampler,
                 settings, alive_mask=None, throughput=None):
    """One-sample NEE without the shadow traversal: sample the light mixture
    (area lights by area CDF; the alias-sampled env with probability
    ``_env_mix_q``), evaluate the BRDF toward it and MIS-weight it.

    Returns (shadow_o, shadow_d, t_shadow, pre_ok, contrib, sampler); lanes
    with invalid samples have pre_ok False and shadow_o parked at 1e30.

    ``make_scene`` pads the light list to at least one (invalid) row; an
    instanced scene whose meshes carry no emitter has an empty list and
    samples the environment alone (the mixture at q_env = 1)."""
    em = scene.emissive
    has_area = int(em.tri_ids.shape[0]) > 0
    q_env = _env_mix_q(scene)
    if not has_area:
        n = hit_pos.shape[0]
        dev = hit_pos.device
        wi_world = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        wi_world[:, 1] = 1.0
        le_sel = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        pdf_sel = torch.zeros((n,), dtype=torch.float32, device=dev)
        valid_sel = torch.zeros((n,), dtype=torch.bool, device=dev)
        t_shadow = torch.zeros((n,), dtype=torch.float32, device=dev)
        if q_env > 0.0:
            # Env-only mixture: every lane picks the alias-sampled env.
            u_env, sampler = sampler.next3()
            u_sel, sampler = sampler.next1()
            wi_env, le_env, pdf_env = _sample_env_light(scene, u_env)
            choose_env = u_sel < q_env
            ce3 = choose_env[:, None]
            wi_world = torch.where(ce3, wi_env, wi_world)
            le_sel = torch.where(ce3, le_env, le_sel)
            pdf_sel = torch.where(choose_env, q_env * pdf_env, (1.0 - q_env) * pdf_sel)
            valid_sel = torch.where(choose_env, pdf_env > 0.0, valid_sel)
            t_shadow = torch.where(choose_env, mathx.BACKGROUND_DEPTH * 0.9, t_shadow)
    elif q_env > 0.0:
        # Mixture: each lane picks its source first, then reads ONE row of
        # the concatenated [area lights ; env alias] table.
        u_env, sampler = sampler.next3()
        u_sel, sampler = sampler.next1()
        choose_env = u_sel < q_env
        tab = scene.env_sample_table
        k_env = _env_pick(tab.shape[0], u_env[:, 0])
        li = torch.clamp(torch.searchsorted(em.cdf, u3[:, 0].contiguous()), 0, em.tri_ids.shape[0] - 1)
        row = torch.cat([em.light_table, tab], dim=0)[
            torch.where(choose_env, em.light_table.shape[0] + k_env, li)
        ]
        # Area-light interpretation (v0 e1 e2 le valid):
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
        # Env alias interpretation (prob alias pdf rgb pdf' rgb'):
        he, we = scene.env_rgbp.shape[0], scene.env_rgbp.shape[1]
        wi_e, le_e, pdf_e = _env_row_consume(row, k_env, u_env, he, we)
        ce3 = choose_env[:, None]
        wi_world = torch.where(ce3, wi_e, wi_a)
        le_sel = torch.where(ce3, le_e, le_a)
        pdf_sel = torch.where(choose_env, q_env * pdf_e, (1.0 - q_env) * pdf_a)
        valid_sel = torch.where(choose_env, pdf_e > 0.0, valid_a)
        t_shadow = torch.where(choose_env, mathx.BACKGROUND_DEPTH * 0.9, t_a)
    else:
        # Area lights only.
        li = torch.clamp(torch.searchsorted(em.cdf, u3[:, 0].contiguous()), 0, em.tri_ids.shape[0] - 1)
        row = em.light_table[li]
        v0, e1, e2, le_sel = row[:, 0:3], row[:, 3:6], row[:, 6:9], row[:, 9:12]
        v1 = v0 + e1
        v2 = v0 + e2
        # Uniform point on the triangle.
        su = torch.sqrt(torch.clamp_min(u3[:, 1:2], 0.0))
        b0 = 1.0 - su
        b1 = u3[:, 2:3] * su
        p = v0 * b0 + v1 * b1 + v2 * (1.0 - b0 - b1)
        to_l = p - hit_pos
        dist2 = mathx.dot(to_l, to_l)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
        wi_world = to_l / dist
        l_nrm = mathx.normalize(mathx.cross(v1 - v0, v2 - v0))
        cos_l = torch.abs(mathx.dot(l_nrm, -wi_world, keepdims=False))
        pdf_sel = dist2[:, 0] / torch.clamp_min(cos_l * em.total_area, 1e-20)
        valid_sel = (row[:, 12] > 0.5) & (cos_l > 1e-6) & (pdf_sel > 0.0)
        t_shadow = dist[:, 0] * (1.0 - 1e-3)
    return _nee_finish(
        scene, hit_pos, normal, wo_world, surface, settings, alive_mask,
        wi_world, le_sel, pdf_sel, valid_sel, t_shadow, sampler, throughput=throughput,
    )


def _nee_finish(scene, hit_pos, normal, wo_world, surface, settings, alive_mask,
                wi_world, le_sel, pdf_sel, valid_sel, t_shadow, sampler, throughput=None):
    """Shared NEE tail: BRDF toward the light sample, balance-heuristic MIS
    weight, validity mask, optional shadow-ray Russian roulette, shadow-ray
    setup."""
    cos_s = mathx.dot(normal, wi_world, keepdims=False)
    onb = mathx.build_orthonormal_basis(normal)
    wo_l = mathx.to_local(onb, wo_world)
    wi_l = mathx.to_local(onb, wi_world)
    if settings.diffuse_only:
        ev = brdf.diffuse_evaluate(surface.albedo, wi_l)
    else:
        ev = brdf.surface_evaluate(surface.albedo, surface.roughness, surface.metalness, wo_l, wi_l)
    # ev.pdf is projected-solid-angle; convert to solid angle for MIS.
    pdf_brdf = ev.pdf * torch.clamp_min(wi_l[..., 2], 0.0)
    mis_w = pdf_sel / torch.clamp_min(pdf_sel + pdf_brdf, 1e-20)

    pre_ok = valid_sel & (cos_s > 0.0)
    if alive_mask is not None:
        pre_ok = pre_ok & alive_mask
    contrib = ev.value * le_sel * (cos_s * mis_w / torch.clamp_min(pdf_sel, 1e-20))[:, None]
    if settings.nee_rr_threshold > 0.0 and throughput is not None:
        inc = torch.clamp_min(
            0.2126 * contrib[:, 0] * throughput[:, 0]
            + 0.7152 * contrib[:, 1] * throughput[:, 1]
            + 0.0722 * contrib[:, 2] * throughput[:, 2],
            0.0,
        )
        p = torch.clamp(inc / settings.nee_rr_threshold, 0.05, 1.0)
        u_rr, sampler = sampler.next1()
        pre_ok = pre_ok & (u_rr < p)
        contrib = contrib / p[:, None]
    shadow_o = torch.where(pre_ok[:, None], hit_pos + normal * 1e-3, 1e30)
    return shadow_o, wi_world, t_shadow, pre_ok, contrib, sampler


def _nee_contribution(scene, occluded_fn: OccludedFn, hit_pos, normal, wo_world, surface, u3,
                      sampler, settings, alive_mask=None, sort_shadow: bool = False,
                      sort_bounds=None, return_count: bool = False, throughput=None):
    """_nee_prepare + the shadow traversal: one-sample NEE radiance.
    sort_shadow coherence-sorts the shadow batch into the traversal and
    un-sorts the occlusion bits (the queue stays in pixel order). With
    ``settings.lane_diet`` contrib, the one [N, 3] of this function's own
    state that crosses the launch, crosses it rgb9e5-packed."""
    from raytracer3_tpu_torch.render import wavefront

    shadow_o, wi_world, t_shadow, pre_ok, contrib, sampler = _nee_prepare(
        scene, hit_pos, normal, wo_world, surface, u3, sampler, settings,
        alive_mask=alive_mask, throughput=throughput,
    )
    (contrib,) = wavefront._diet_pack(settings.lane_diet, contrib)
    if sort_shadow:
        blocked = wavefront.sorted_occlusion(occluded_fn, shadow_o, wi_world, t_shadow, pre_ok, sort_bounds)
    else:
        blocked = occluded_fn(shadow_o, wi_world, t_shadow)
    (contrib,) = wavefront._diet_unpack(settings.lane_diet, contrib)
    ok = pre_ok & ~blocked
    li_out = torch.where(ok[:, None], contrib, 0.0)
    if return_count:
        return li_out, sampler, pre_ok.sum()
    return li_out, sampler


class GBuffer(NamedTuple):
    """Primary visibility, unpacked (old/gbuffer.slang:8-20)."""

    depth: torch.Tensor  # [N] BACKGROUND_DEPTH on miss
    surface: scene_types.SurfaceInfo  # [N, ...]
    prim_id: torch.Tensor  # [N]
    hit: torch.Tensor  # [N] bool


def trace_gbuffer(scene: scene_types.Scene, intersect_fn: IntersectFn, origins, directions) -> GBuffer:
    """Primary rays → G-buffer (gbuffer.slang:8-20)."""
    h = intersect_fn(origins, directions)
    surface = scene_types.hit_surface_info(scene, h.prim_id, h.uv, h.inst)
    return GBuffer(depth=h.t, surface=surface, prim_id=h.prim_id, hit=h.hit)


def trace_radiance(scene: scene_types.Scene, intersect_fn: IntersectFn, origins, directions,
                   gbuf: GBuffer, sampler: rng.Sampler, settings, occluded_fn: OccludedFn | None = None):
    """Radiance [N, 3] of the primary rays: the sample/bounce loop of
    refrence_mode.slang:28-59 as masked steps. With ``occluded_fn`` and a
    light (emissive triangles or an env alias table) NEE with MIS runs at
    every bounce; else pure BRDF sampling like the reference shader. The
    environment of primary misses is left to the caller."""
    n = origins.shape[0]
    dev = origins.device
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    q_env = _env_mix_q(scene)
    use_nee = occluded_fn is not None and (int(scene.emissive.tri_ids.shape[0]) > 0 or q_env > 0.0)

    for _ in range(settings.samples):
        ray_o, ray_d = origins, directions
        throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
        alive = gbuf.hit
        surface = gbuf.surface
        depth = gbuf.depth
        prev_pdf = torch.full((n,), 1e8, dtype=torch.float32, device=dev)  # delta (camera) pdf
        sample_radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)

        for b in range(settings.bounces):
            nrm = _face_forward(surface.normal, -ray_d)

            # Emissive pickup; under NEE a BRDF-sampled emitter is weighted
            # against the light pdf (balance heuristic, one sample each).
            emit_w = torch.ones((n,), dtype=torch.float32, device=dev)
            if use_nee and b > 0:
                cos_l = torch.abs(mathx.dot(nrm, -ray_d, keepdims=False))
                pdf_light = (1.0 - q_env) * (depth * depth) / torch.clamp_min(
                    cos_l * scene.emissive.total_area, 1e-20)
                is_emitter = torch.amax(surface.emissive, dim=-1) > 0.0
                w = prev_pdf / torch.clamp_min(prev_pdf + pdf_light, 1e-20)
                emit_w = torch.where(is_emitter, w, 1.0)
            sample_radiance = sample_radiance + torch.where(
                alive[:, None], throughput * surface.emissive * emit_w[:, None], 0.0)

            onb = mathx.build_orthonormal_basis(nrm)
            hit_pos = ray_o + depth[:, None] * ray_d

            if use_nee:
                u_l, sampler = sampler.next3()
                li, sampler = _nee_contribution(
                    scene, occluded_fn, hit_pos, nrm, -ray_d, surface, u_l, sampler, settings,
                    alive_mask=alive, throughput=throughput,
                )
                sample_radiance = sample_radiance + torch.where(alive[:, None], throughput * li, 0.0)

            # BRDF sampling (refrence_mode.slang:41-47).
            if settings.diffuse_only:
                u2, sampler = sampler.next2()
                s = brdf.diffuse_sample(surface.albedo, u2)
            else:
                u3, sampler = sampler.next3()
                s = brdf.surface_sample(surface.albedo, surface.roughness, surface.metalness,
                                        mathx.to_local(onb, -ray_d), u3)

            ray_o = hit_pos
            ray_d = mathx.to_world(onb, s.wi)
            throughput = throughput * s.value_over_pdf
            prev_pdf = torch.clamp_min(s.pdf * torch.abs(s.wi[..., 2]), 1e-8)
            alive = alive & s.valid & (torch.amax(throughput, dim=-1) > 0.0)

            if b != settings.bounces - 1:
                h = intersect_fn(ray_o, ray_d)
                # A secondary miss picks up the environment and ends the path
                # (MIS-weighted against env NEE when that is on).
                if use_nee and q_env > 0.0:
                    env, env_pdf = _env_radiance_pdf(scene, ray_d)
                    env = env * (prev_pdf / torch.clamp_min(prev_pdf + q_env * env_pdf, 1e-20))[:, None]
                else:
                    env = _sample_env(scene, ray_d)
                sample_radiance = sample_radiance + torch.where((alive & ~h.hit)[:, None], throughput * env, 0.0)
                alive = alive & h.hit
                depth = h.t
                surface = scene_types.hit_surface_info(scene, h.prim_id, h.uv, h.inst)

        if settings.radiance_clamp > 0.0:
            sample_radiance = torch.clamp_max(sample_radiance, settings.radiance_clamp)
        radiance = radiance + sample_radiance

    return radiance / float(settings.samples)


def render_image(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                 intersect_fn: IntersectFn, occluded_fn: OccludedFn | None = None) -> torch.Tensor:
    """One frame of raw radiance [H, W, 3] before postprocess: jittered
    primaries in row order → G-buffer → ``trace_radiance``, primary misses
    filled with the environment."""
    w, h = settings.width, settings.height
    pix = camera_mod.pixel_grid(w, h, device=scene.positions.device)
    sampler = rng.Sampler.from_pixels(pix, frame_index)
    uj, sampler = sampler.next2()
    o, d = camera_mod.primary_rays(cam, w, h, jitter=uj, pixel_xy=pix)
    gbuf = trace_gbuffer(scene, intersect_fn, o, d)
    radiance = trace_radiance(scene, intersect_fn, o, d, gbuf, sampler, settings, occluded_fn)
    radiance = torch.where(gbuf.hit[:, None], radiance, _sample_env(scene, d))
    return radiance.reshape(h, w, 3)
