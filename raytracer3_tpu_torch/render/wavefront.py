"""Wavefront path tracer: the production renderer (port of
``raytracer3_tpu/render/wavefront.py``).

Rays live in flat [N] SoA queues; each bounce shades the recorded hit, runs
NEE with MIS (one any-hit launch, coherence-sorted), samples the BRDF,
applies Russian roulette and traces the next hit (one closest-hit launch,
coherence-sorted). The last bounce's hit only feeds the escape test, so it
and the final shadow batch ride ONE any-hit launch (``tail_anyhit``), in
the frame's order as in the reference: sorting it (29.5M lanes at
instanced720's shape) cost more on an H100 than it saved (PERF.md). The
reference's ``lax.scan`` over bounces is a Python loop here.

All of the reference's options are ported: a backend's own primary trace
(``primary_fn``), sample batching (``settings.sample_batch``: one wavefront
of ``samples``·W·H lanes), two-level (TLAS) backends, whose hits carry the
instance id through the queue (``RayQueue.inst``) into
``hit_surface_info``, the fused shadow+bounce launch (``fused_fn``, which
``settings.fuse_shadow`` selects where the backend has a capped trace), the
lane diet (``settings.lane_diet``), ``tail_anyhit``, ``rr_start``,
``tile_primaries``, the denoiser's G-buffer (``return_gbuffer``) and the
ray-cone mip level of atlas-textured scenes (``footprint_log2``). The
reference's XLA optimization barriers around the diet are not ported: in
eager PyTorch the packed words replace the f32 state because the code drops
its last reference to it before each launch.

On a CUDA device a bounce's shading (``_shade``: surface, emissive pickup,
NEE's light sample, BRDF sample, Russian roulette) runs as passes of one
hand-written kernel (``ops/shade_kernel``, ``csrc/shade.cu``) wherever it
covers the scene; textured scenes, scenes without shade rows and the CPU
take the PyTorch path, the kernel's plain version. On a CUDA device the IO
of each coherence-sorted launch (the sort key, the rays in sorted order,
the results back in the caller's order) runs as the three passes of
``ops/sorted_io_kernel`` (``csrc/sorted_io.cu``) around PyTorch's argsort;
elsewhere as PyTorch (``sort_key_pos_dir_plain``, ``sorted_trace_plain``,
``sorted_occlusion_plain``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import brdf, intersect, mathx, packing, rng, shade_kernel, sorted_io_kernel
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import pathtracer
from raytracer3_tpu_torch.scene import types as scene_types

_M32 = 0xFFFFFFFF


class RayQueue(NamedTuple):
    """Flat wavefront state, SoA [N]."""

    origin: torch.Tensor  # [N, 3]
    direction: torch.Tensor  # [N, 3]
    throughput: torch.Tensor  # [N, 3]
    radiance: torch.Tensor  # [N, 3] accumulated
    pixel_id: torch.Tensor  # [N] int32 (indirection to the film)
    alive: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor  # [N] solid-angle pdf of the last BRDF sample (MIS)
    depth: torch.Tensor  # [N] t of the current hit
    prim_id: torch.Tensor  # [N] int32
    uv: torch.Tensor  # [N, 2]
    inst: Optional[torch.Tensor] = None  # [N] int32 hit instance (TLAS backends)


def _sorted_io(device):
    """The library of the sorted launch IO's passes (``csrc/sorted_io.cu``)
    that tensors on ``device`` take: the nvcc build on a CUDA device, None
    (the plain versions) elsewhere."""
    return sorted_io_kernel.load_kernels() if torch.device(device).type == "cuda" else None


def _alive_bounds(pos, alive):
    """(lo, hi) [3] of the alive lanes' positions; (0, 1) on an axis
    without a finite bound (no alive lane)."""
    alive3 = alive[:, None]
    lo = torch.amin(torch.where(alive3, pos, torch.inf), dim=0)
    hi = torch.amax(torch.where(alive3, pos, -torch.inf), dim=0)
    no_alive = ~torch.isfinite(lo)
    return torch.where(no_alive, 0.0, lo), torch.where(no_alive, 1.0, hi)


def sort_key_pos_dir(pos, d, alive, bounds=None) -> torch.Tensor:
    """Coherence sort key (int32): alive rays first, then direction octant,
    then an 18-bit Morton code of the position. ``bounds=(lo, hi)`` is the
    scene AABB; without it the bounds of the alive lanes are used. A CUDA
    tensor takes ``launch_key_kernel`` (the bounds stay on the device), any
    other ``sort_key_pos_dir_plain``."""
    lib = _sorted_io(pos.device)
    if lib is None:
        return sort_key_pos_dir_plain(pos, d, alive, bounds)
    lo, hi = bounds if bounds is not None else _alive_bounds(pos, alive)
    return sorted_io_kernel.launch_key(lib, pos, d, alive, lo, hi)


def sort_key_pos_dir_plain(pos, d, alive, bounds=None) -> torch.Tensor:
    """``sort_key_pos_dir`` in PyTorch: the key kernel's plain version."""
    octant = (
        (d[:, 0] >= 0).to(torch.int32)
        + 2 * (d[:, 1] >= 0).to(torch.int32)
        + 4 * (d[:, 2] >= 0).to(torch.int32)
    )
    lo, hi = bounds if bounds is not None else _alive_bounds(pos, alive)
    norm = (pos - lo) / torch.clamp_min(hi - lo, 1e-6)
    qz = torch.clamp(norm * 63.0, 0, 63).to(torch.int32)
    morton = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for b in range(6):
        morton = (
            morton
            | (((qz[:, 0] >> b) & 1) << (3 * b + 2))
            | (((qz[:, 1] >> b) & 1) << (3 * b + 1))
            | (((qz[:, 2] >> b) & 1) << (3 * b))
        )
    dead_penalty = torch.where(alive, 0, 1 << 30).to(torch.int32)
    return dead_penalty + (octant << 18) + morton


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """argsort(perm) of a permutation, as one scatter."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def sorted_trace(intersect_fn, origins, directions, alive, bounds=None) -> intersect.Hit:
    """Trace with coherence-sorted IO, results in the caller's ray order. A
    CUDA tensor takes the sorted IO's kernels around the launch (the key,
    PyTorch's stable argsort, ``launch_in_kernel``'s gather of the rays,
    ``launch_out_kernel``'s scatter of the ``Hit``), any other
    ``sorted_trace_plain``."""
    lib = _sorted_io(origins.device)
    if lib is None:
        return sorted_trace_plain(intersect_fn, origins, directions, alive, bounds)
    perm = torch.argsort(sort_key_pos_dir(origins, directions, alive, bounds), stable=True)
    o_s, d_s, _ = sorted_io_kernel.launch_in(lib, perm, origins, directions)
    return sorted_io_kernel.launch_out_hit(lib, perm, intersect_fn(o_s, d_s))


def sorted_trace_plain(intersect_fn, origins, directions, alive, bounds=None) -> intersect.Hit:
    """``sorted_trace`` in PyTorch: one [N, 6] gather in, one [N, 4] gather
    out (prim_id, and the instance id of a two-level trace as a fifth
    column, travel bit-cast through float32)."""
    perm = torch.argsort(sort_key_pos_dir_plain(origins, directions, alive, bounds), stable=True)
    packed = torch.cat([origins, directions], dim=1)[perm]
    h = intersect_fn(packed[:, 0:3], packed[:, 3:6])
    cols = [h.t[:, None], h.uv, h.prim_id.to(torch.int32).view(torch.float32)[:, None]]
    if h.inst is not None:
        cols.append(h.inst.to(torch.int32).view(torch.float32)[:, None])
    hp = torch.cat(cols, dim=1)[inverse_permutation(perm)]
    prim_id = hp[:, 3].contiguous().view(torch.int32)
    inst = None if h.inst is None else hp[:, 4].contiguous().view(torch.int32)
    return intersect.Hit(t=hp[:, 0], uv=hp[:, 1:3], prim_id=prim_id, hit=prim_id >= 0, inst=inst)


def sorted_occlusion(occluded_fn, origins, directions, t_max, alive, bounds=None) -> torch.Tensor:
    """Any-hit trace with coherence-sorted IO (the NEE shadow batch), the
    occlusion bits in the caller's ray order. Lanes not ``alive`` sort
    last. An any-hit answer does not depend on the order the rays are
    traced in, so the bits are those of the unsorted launch. A CUDA tensor
    takes the sorted IO's kernels around the launch (the key, PyTorch's
    stable argsort, ``launch_in_kernel``'s gather of the rays and caps,
    ``launch_out_kernel``'s scatter of the bits), any other
    ``sorted_occlusion_plain``."""
    lib = _sorted_io(origins.device)
    if lib is None:
        return sorted_occlusion_plain(occluded_fn, origins, directions, t_max, alive, bounds)
    perm = torch.argsort(sort_key_pos_dir(origins, directions, alive, bounds), stable=True)
    o_s, d_s, cap_s = sorted_io_kernel.launch_in(lib, perm, origins, directions, t_max)
    return sorted_io_kernel.launch_out_bits(lib, perm, occluded_fn(o_s, d_s, cap_s))


def sorted_occlusion_plain(occluded_fn, origins, directions, t_max, alive, bounds=None) -> torch.Tensor:
    """``sorted_occlusion`` in PyTorch: one [N, 7] gather in (origin,
    direction, cap) and one scatter of the bits out."""
    perm = torch.argsort(sort_key_pos_dir_plain(origins, directions, alive, bounds), stable=True)
    packed = torch.cat([origins, directions, t_max[:, None]], dim=1)[perm]
    blocked_s = occluded_fn(packed[:, 0:3], packed[:, 3:6], packed[:, 6])
    blocked = torch.empty_like(blocked_s)
    blocked[perm] = blocked_s
    return blocked


def _diet_pack(diet: bool, *cols):
    """Lane diet (``settings.lane_diet``), half 1: rgb9e5-pack the
    non-negative colour state [N, 3] f32 → one int32 word per lane, so that
    4 bytes instead of 12 cross the traversal launch. The caller rebinds its
    names to the result and holds no other reference to the f32 tensors,
    else they stay alive across the launch all the same. Off: the columns
    unchanged."""
    if not diet:
        return cols
    words = (packing.pack_rgb9e5(c) for c in cols)  # uint32 values in int64
    return tuple(torch.where(w >= 2**31, w - 2**32, w).to(torch.int32) for w in words)


def _diet_unpack(diet: bool, *cols):
    """Half 2, after the launch: the rounded f32 colours (the rounding is
    the diet's one numeric effect, ≤ 2^-9 of a lane's largest channel per
    crossing)."""
    if not diet:
        return cols
    return tuple(packing.unpack_rgb9e5(c) for c in cols)


class _Shaded(NamedTuple):
    """What of a shaded bounce crosses its next-hit launch."""

    radiance: torch.Tensor  # [N, 3]
    q_throughput: Optional[torch.Tensor]  # the incoming throughput, when a deferred shadow batch needs it
    hit_pos: torch.Tensor  # [N, 3] the next queue's origins
    new_dir: torch.Tensor  # [N, 3]
    throughput: torch.Tensor  # [N, 3] after the BRDF sample and Russian roulette
    prev_pdf: torch.Tensor  # [N]
    alive: torch.Tensor  # [N] bool
    shadow: Optional[tuple]  # deferred NEE batch (o, d, t_max, pre_ok, contrib)
    n_shadow: object  # shadow lanes traced (0-dim tensor or 0)
    sampler: rng.Sampler


def footprint_log2(scene, prim_id, direction, depth, b: int, settings) -> torch.Tensor:
    """log2 of the ray-cone footprint at bounce ``b``'s hits [N]: depth ·
    cone / max(|cos θ|, 0.05) against the geometric normal, the cone
    widened after each bounce (``tex_cone_angle`` · (1 + 4b), the
    reference's float32 product). ``hit_surface_info`` adds the material's
    texel density for the mip level."""
    with torch.profiler.record_function("texture:footprint"):
        cone = float(np.float32(settings.tex_cone_angle) * np.float32(1 + 4 * b))
        cos_i = torch.abs(mathx.dot(scene_types.geometric_normals(scene, prim_id), -direction, keepdims=False))
        return torch.log2(torch.clamp_min(depth * cone / torch.clamp_min(cos_i, 0.05), 1e-12))


def _shade(scene, q: RayQueue, sampler, settings, b: int, use_nee: bool, q_env: float, defer_shadow: bool,
           occluded_fn, sort_rays: bool, sort_bounds, rr_start: int) -> _Shaded:
    """One bounce up to its next-hit launch: emissive pickup (MIS-weighted
    against NEE after the first bounce), NEE (its shadow launch here, unless
    ``defer_shadow`` leaves the batch to ride the next launch), the BRDF
    sample and Russian roulette from bounce ``rr_start`` on. On a CUDA
    device, where ``shade_kernel.covers`` the scene, as the shade kernel's
    passes (``_shade_on_kernel``); else in PyTorch (``_shade_plain``)."""
    args = (scene, q, sampler, settings, b, use_nee, q_env, defer_shadow, occluded_fn, sort_rays, sort_bounds,
            rr_start)
    if shade_kernel.covers(scene, q.origin.device):
        return _shade_on_kernel(shade_kernel.load_kernels(), *args)
    return _shade_plain(*args)


def _shade_plain(scene, q: RayQueue, sampler, settings, b: int, use_nee: bool, q_env: float, defer_shadow: bool,
                 occluded_fn, sort_rays: bool, sort_bounds, rr_start: int) -> _Shaded:
    """``_shade`` in PyTorch: the shade kernel's plain version. The
    bounce's other temporaries (surface, basis, sample) die when this
    returns, so they do not cross the next launch."""
    diet = settings.lane_diet
    fp_log2 = None
    if scene.tex_atlas is not None:
        fp_log2 = footprint_log2(scene, q.prim_id, q.direction, q.depth, b, settings)
    surface = scene_types.hit_surface_info(scene, q.prim_id, q.uv, q.inst, footprint_log2=fp_log2)
    nrm = pathtracer._face_forward(surface.normal, -q.direction)

    emit_w = torch.ones(q.alive.shape, dtype=torch.float32, device=q.alive.device)
    if use_nee:
        cos_l = torch.abs(mathx.dot(nrm, -q.direction, keepdims=False))
        pdf_light = (1.0 - q_env) * (q.depth * q.depth) / torch.clamp_min(
            cos_l * scene.emissive.total_area, 1e-20
        )
        is_emitter = torch.amax(surface.emissive, dim=-1) > 0.0
        w = q.prev_pdf / torch.clamp_min(q.prev_pdf + pdf_light, 1e-20)
        emit_w = torch.where(is_emitter & (b > 0), w, 1.0)
    radiance = q.radiance + torch.where(
        q.alive[:, None], q.throughput * surface.emissive * emit_w[:, None], 0.0
    )

    onb = mathx.build_orthonormal_basis(nrm)
    hit_pos = q.origin + q.depth[:, None] * q.direction

    shadow, q_throughput, n_shadow = None, None, 0
    if use_nee:
        u_l, sampler = sampler.next3()
        if defer_shadow:
            # The shadow batch rides the next launch (same sampler draws as
            # the split path).
            sh_o, sh_d, sh_t, pre_ok, contrib, sampler = pathtracer._nee_prepare(
                scene, hit_pos, nrm, -q.direction, surface, u_l, sampler, settings,
                alive_mask=q.alive, throughput=q.throughput,
            )
            shadow = (sh_o, sh_d, sh_t, pre_ok, contrib)
            q_throughput = q.throughput
            n_shadow = pre_ok.sum()
        else:
            # Lane diet around the shadow launch (``_nee_contribution``
            # packs its own contrib). The BRDF step below reads the incoming
            # throughput unrounded, as the reference does, so its f32 stays.
            radiance, q_thr = _diet_pack(diet, radiance, q.throughput)
            li, sampler, n_shadow = pathtracer._nee_contribution(
                scene, occluded_fn, hit_pos, nrm, -q.direction, surface, u_l, sampler, settings,
                alive_mask=q.alive, sort_shadow=sort_rays, sort_bounds=sort_bounds, return_count=True,
                throughput=q.throughput,
            )
            radiance, q_thr = _diet_unpack(diet, radiance, q_thr)
            radiance = radiance + torch.where(q.alive[:, None], q_thr * li, 0.0)

    if settings.diffuse_only:
        u2, sampler = sampler.next2()
        s = brdf.diffuse_sample(surface.albedo, u2)
    else:
        u3, sampler = sampler.next3()
        s = brdf.surface_sample(
            surface.albedo, surface.roughness, surface.metalness,
            mathx.to_local(onb, -q.direction), u3,
        )
    new_dir = mathx.to_world(onb, s.wi)
    throughput = q.throughput * s.value_over_pdf
    prev_pdf = torch.clamp_min(s.pdf * torch.abs(s.wi[..., 2]), 1e-8)
    alive = q.alive & s.valid & (torch.amax(throughput, dim=-1) > 0.0)

    # Russian roulette (static start; probability = max throughput). The
    # draw is taken on every bounce, as in the reference.
    u_rr, sampler = sampler.next1()
    if b >= rr_start:
        p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
        survive = u_rr < p_cont
        throughput = torch.where(
            survive[:, None], throughput / torch.clamp_min(p_cont, 1e-6)[:, None], throughput
        )
        alive = alive & survive
    return _Shaded(radiance, q_throughput, hit_pos, new_dir, throughput, prev_pdf, alive, shadow, n_shadow,
                   sampler)


def _shade_on_kernel(lib, scene, q: RayQueue, sampler, settings, b: int, use_nee: bool, q_env: float,
                     defer_shadow: bool, occluded_fn, sort_rays: bool, sort_bounds, rr_start: int) -> _Shaded:
    """``_shade`` as passes of the shade kernel built as ``lib``: one pass
    where there is no NEE or its shadow batch rides the next launch, else
    pass A, the bounce's shadow launch, pass B. The kernel takes the same
    draws in the same order (the returned sampler has advanced as far), and
    pass A and the launch hold no more lane state than the PyTorch path
    does across it."""
    q = q._replace(prim_id=q.prim_id.to(torch.int32), inst=None if q.inst is None else q.inst.to(torch.int32))
    mode = shade_kernel.nee_mode(scene, use_nee, q_env)
    n_nee = shade_kernel.nee_draws(mode, settings)
    after = rng.Sampler(sampler.seed, (sampler.index + n_nee + shade_kernel.brdf_draws(settings)) & _M32)
    kw = dict(emit_mis=use_nee and b > 0, roulette=b >= rr_start, q_env=q_env)
    if not use_nee or defer_shadow:
        p = shade_kernel.launch(lib, "deferred", mode, scene, q, sampler.seed, sampler.index, settings, **kw)
        shadow, q_throughput, n_shadow = None, None, 0
        if use_nee:
            shadow = (p.shadow_o, p.shadow_d, p.shadow_t, p.pre_ok, p.contrib)
            q_throughput, n_shadow = q.throughput, p.pre_ok.sum()
        return _Shaded(p.radiance, q_throughput, p.hit_pos, p.new_dir, p.throughput, p.prev_pdf, p.alive, shadow,
                       n_shadow, after)
    pa = shade_kernel.launch(lib, "split_a", mode, scene, q, sampler.seed, sampler.index, settings, **kw)
    radiance, sh_o, sh_d, sh_t, pre_ok, contrib = pa.radiance, pa.shadow_o, pa.shadow_d, pa.shadow_t, pa.pre_ok, \
        pa.contrib
    del pa
    if sort_rays:
        blocked = sorted_occlusion(occluded_fn, sh_o, sh_d, sh_t, pre_ok, sort_bounds)
    else:
        blocked = occluded_fn(sh_o, sh_d, sh_t)
    del sh_o, sh_d, sh_t
    n_shadow = pre_ok.sum()
    p = shade_kernel.launch(lib, "split_b", mode, scene, q, sampler.seed, sampler.index + n_nee, settings,
                            radiance_a=radiance, contrib_a=contrib, pre_ok_a=pre_ok, blocked=blocked, **kw)
    return _Shaded(p.radiance, None, p.hit_pos, p.new_dir, p.throughput, p.prev_pdf, p.alive, None, n_shadow, after)


def trace_wavefront(scene: scene_types.Scene, intersect_fn, q: RayQueue, sampler: rng.Sampler,
                    settings, occluded_fn=None, sort_rays: bool = False, rr_start: int = 3,
                    fused_fn=None, tail_anyhit: bool = True):
    """Run the bounce loop on a wavefront whose first hit is recorded in
    (depth, prim_id, uv, alive). Returns (final queue, traced-ray count).

    ``fused_fn`` (a backend's ``bind_capped``: ``(o, d, t_max[N],
    anyhit[N]) -> Hit``): with NEE, each bounce but the tail traces its
    shadow batch and its next-bounce rays in ONE launch of 2N lanes,
    ``[shadow ; bounce]``; the shadow lanes carry the light distance as
    their cap and the any-hit flag, and only their ``Hit.hit`` is read (a
    flagged lane that retires early records t = 0). Radiance is
    bit-compatible with the split path: same sampler draws, same
    occlusion bits.

    ``tail_anyhit``: the last bounce's hit only feeds the escape test, so it
    and the final shadow batch ride ONE any-hit launch (bit-compatible: the
    occlusion bit is the closest hit's hit bit). False traces the last
    bounce as the middle ones: a closest-hit launch and its own shadow
    batch.

    ``settings.lane_diet`` rgb9e5-packs the colour lane state (radiance,
    throughputs, NEE contrib) across every launch, where the reference
    packs it; not bit-compatible with the default path."""
    q_env = pathtracer._env_mix_q(scene)
    use_nee = occluded_fn is not None and (
        int(scene.emissive.tri_ids.shape[0]) > 0 or q_env > 0.0
    )
    sort_bounds = (torch.amin(scene.positions, dim=0), torch.amax(scene.positions, dim=0))
    diet = settings.lane_diet
    nb = int(settings.bounces)
    traced = torch.zeros((), dtype=torch.int64, device=q.origin.device)

    for b in range(nb):
        tail_any = b == nb - 1 and tail_anyhit and occluded_fn is not None
        fuse = fused_fn is not None and use_nee and not tail_any
        (radiance, q_throughput, hit_pos, new_dir, throughput, prev_pdf, alive, shadow, n_shadow,
         sampler) = _shade(scene, q, sampler, settings, b, use_nee, q_env, tail_any or fuse, occluded_fn,
                           sort_rays, sort_bounds, rr_start)
        # Nothing f32 of the old queue crosses the launch below.
        pixel_id, q_alive, two_level = q.pixel_id, q.alive, q.inst is not None
        del q

        # Next hit. Dead lanes are parked far outside the scene.
        park = torch.where(alive[:, None], hit_pos, 1e30)
        m = park.shape[0]
        dev = park.device
        bg = torch.full((m,), mathx.BACKGROUND_DEPTH, dtype=torch.float32, device=dev)
        if (tail_any or fuse) and use_nee:
            # ONE launch: [shadow batch ; bounce rays]. Tail: any hit, the
            # bounce half capped at the background (its hit bit is all the
            # escape test needs). Fused: the capped closest hit, shadow
            # lanes flagged any-hit.
            sh_o, sh_d, sh_t, pre_ok, contrib = shadow
            o2, d2, cap2 = torch.cat([sh_o, park]), torch.cat([sh_d, new_dir]), torch.cat([sh_t, bg])
            del shadow, sh_o, sh_d, sh_t, park
            radiance, q_throughput, contrib, throughput = _diet_pack(
                diet, radiance, q_throughput, contrib, throughput)
            if tail_any:
                hit2 = occluded_fn(o2, d2, cap2)
            else:
                ah2 = torch.cat([torch.ones((m,), dtype=torch.bool, device=dev),
                                 torch.zeros((m,), dtype=torch.bool, device=dev)])
                h2 = fused_fn(o2, d2, cap2, ah2)
                hit2 = h2.hit
            del o2, d2, cap2
            radiance, q_throughput, contrib, throughput = _diet_unpack(
                diet, radiance, q_throughput, contrib, throughput)
            ok = pre_ok & ~hit2[:m]
            radiance = radiance + torch.where((q_alive & ok)[:, None], q_throughput * contrib, 0.0)
            del q_throughput, contrib, pre_ok, ok
            if tail_any:
                h = _escape_hit(hit2[m:], bg, two_level)
            else:
                h = intersect.Hit(*(None if x is None else x[m:] for x in h2))
                del h2
            del hit2
        else:
            radiance, throughput = _diet_pack(diet, radiance, throughput)
            if tail_any:
                h = _escape_hit(occluded_fn(park, new_dir, bg), bg, two_level)
            elif sort_rays:
                h = sorted_trace(intersect_fn, park, new_dir, alive, sort_bounds)
            else:
                h = intersect_fn(park, new_dir)
            del park
            radiance, throughput = _diet_unpack(diet, radiance, throughput)
        if use_nee and q_env > 0.0:
            # BRDF-sampled env escape, MIS-weighted against env NEE.
            env, env_pdf = pathtracer._env_radiance_pdf(scene, new_dir)
            w_env = prev_pdf / torch.clamp_min(prev_pdf + q_env * env_pdf, 1e-20)
            env = env * w_env[:, None]
        else:
            env = pathtracer._sample_env(scene, new_dir)
        radiance = radiance + torch.where((alive & ~h.hit)[:, None], throughput * env, 0.0)
        # Ray meter: lanes alive entering the next-hit trace + shadow lanes
        # that actually traversed.
        traced = traced + alive.sum() + n_shadow

        q = RayQueue(
            origin=hit_pos, direction=new_dir, throughput=throughput, radiance=radiance,
            pixel_id=pixel_id, alive=alive & h.hit, prev_pdf=prev_pdf, depth=h.t,
            prim_id=h.prim_id, uv=h.uv, inst=h.inst,
        )
    return q, traced


def _escape_hit(hit_bit, bg, two_level: bool) -> intersect.Hit:
    """The tail's any-hit answer as a ``Hit``: only ``hit`` is meaningful
    (the loop ends; nothing shades it)."""
    m = hit_bit.shape[0]
    return intersect.Hit(
        t=bg,
        uv=torch.zeros((m, 2), dtype=torch.float32, device=bg.device),
        prim_id=torch.where(hit_bit, 0, -1).to(torch.int32),
        hit=hit_bit,
        inst=torch.zeros((m,), dtype=torch.int32, device=bg.device) if two_level else None,
    )


TILE_W, TILE_H = 128, 64


def pick_tile(width: int, height: int):
    """Largest packet-friendly tile dims dividing the image (None if none)."""
    tw = next((t for t in (128, 64, 32) if width % t == 0), None)
    th = next((t for t in (64, 32, 16, 8) if height % t == 0), None)
    return (tw, th) if (tw and th) else None


def tiled_pixel_order(width: int, height: int, tile_w: int = TILE_W, tile_h: int = TILE_H,
                      *, device) -> torch.Tensor:
    """Pixel coords [N, 2] int32 in tile-swizzled order: consecutive rays
    form tile_w×tile_h screen tiles (host numpy, then one upload)."""
    txs = -(-width // tile_w)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    x = xs.ravel()
    y = ys.ravel()
    tile = (y // tile_h) * txs + (x // tile_w)
    within = (y % tile_h) * tile_w + (x % tile_w)
    order = np.argsort(tile * (tile_w * tile_h) + within, kind="stable")
    return torch.as_tensor(np.stack([x[order], y[order]], axis=-1).astype(np.int32), device=device)


@functools.lru_cache(maxsize=8)
def frame_pixels(width: int, height: int, device: torch.device, tile_primaries: bool = True):
    """(tile, pixel coords [N, 2] int32) of a frame, built once per size and
    device: tile-swizzled when ``tile_primaries`` and a packet-sized tile
    divides the image (tile is its (w, h)), else row-major (tile None). The
    reference builds this order once, when it traces the frame under jit;
    built per frame here it costs a host argsort of every pixel and an
    upload. Callers must not write to the returned tensor."""
    tile = pick_tile(width, height) if tile_primaries else None
    if tile is None:
        return None, camera_mod.pixel_grid(width, height, device=device)
    return tile, tiled_pixel_order(width, height, tile_w=tile[0], tile_h=tile[1], device=device)


def sample_rays(cam: camera_mod.Camera, settings, frame_index, s_i: int,
                blue_noise: Optional[torch.Tensor] = None, tile_primaries: bool = True):
    """Primary rays [W·H, 3] in the frame's pixel order (``frame_pixels``)
    and the per-lane sampler of sample ``s_i`` of a frame; the jitter is
    decorrelated per sample via the scrambled frame index (an int, or a
    0-d integer tensor under a compiled step)."""
    w, h = settings.width, settings.height
    _, pix = frame_pixels(w, h, cam.position.device, tile_primaries)
    fi = (rng.frame_word(frame_index) * settings.samples + s_i) & _M32
    sampler = rng.Sampler.from_pixels(pix, fi)
    if blue_noise is None:
        uj, sampler = sampler.next2()
    else:
        # Blue-noise subpixel jitter: tiled texture, rotated per frame.
        bw = blue_noise.shape[0]
        bx = pix[:, 0].long() % bw
        by = pix[:, 1].long() % bw
        b0 = rng.animate_blue_noise(blue_noise[by, bx], fi)
        b1 = rng.animate_blue_noise(blue_noise[bx, by], (fi + 7919) & _M32)
        uj = torch.stack([b0, b1], dim=-1)
    o, d = camera_mod.primary_rays(cam, w, h, jitter=uj, pixel_xy=pix)
    return o, d, sampler


def _unswizzle(x, tile, h: int, w: int):
    """[W·H, C] in the frame's pixel order → [H, W, C]: reshapes undo the
    tile swizzle."""
    c = x.shape[-1]
    if tile is None:
        return x.reshape(h, w, c)
    tw_, th_ = tile
    return x.reshape(h // th_, w // tw_, th_, tw_, c).permute(0, 2, 1, 3, 4).reshape(h, w, c)


def render_frame(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                 intersect_fn, occluded_fn=None, sort_rays: bool = False,
                 blue_noise: Optional[torch.Tensor] = None, tile_primaries: bool = True,
                 return_stats: bool = False, primary_fn=None, return_gbuffer: bool = False,
                 fused_fn=None, tail_anyhit: bool = True):
    """One frame: primary rays → wavefront bounce loop → [H, W, 3] raw
    radiance.

    ``tile_primaries`` orders the primaries in packet-sized screen tiles
    where one divides the image. ``return_stats=True`` also returns the
    traced-ray count (a 0-dim int64 tensor): primaries + alive closest-hit
    lanes + NEE shadow lanes. ``return_gbuffer=True`` also returns (depth
    [H, W], geometric normal [H, W, 3], zero on a miss) of sample 0's
    primary hits, the denoiser's edge-stopping inputs; with both, the order
    is (radiance, count, gbuffer). ``primary_fn`` (a backend's
    ``bind_primary``) traces the primaries in place of ``intersect_fn``;
    ``fused_fn`` and ``tail_anyhit`` as in ``trace_wavefront``. With
    ``settings.sample_batch`` and samples > 1 the samples run as ONE
    wavefront of samples·W·H lanes (sampler seeds concatenated per sample),
    else one after another."""
    w, h = settings.width, settings.height
    n = w * h
    dev = scene.positions.device
    tile, pix = frame_pixels(w, h, dev, tile_primaries)

    def run_wavefront(o, d, sampler, m):
        """Trace one wavefront of m = n·k lanes → (per-lane radiance with
        the primary-miss env, traced-ray count, primary hit)."""
        hit0 = (primary_fn or intersect_fn)(o, d)
        # The first bounce only reads the queue's constant columns: views of
        # one row, so that no [m] colour state of the caller's queue stays
        # alive across the frame's launches.
        one = torch.ones((1, 3), dtype=torch.float32, device=dev)
        q = RayQueue(
            origin=o, direction=d, throughput=one.expand(m, 3), radiance=torch.zeros_like(one).expand(m, 3),
            pixel_id=(pix[:, 1] * w + pix[:, 0]).to(torch.int32).repeat(m // n),
            alive=hit0.hit,
            prev_pdf=torch.full((1,), 1e8, dtype=torch.float32, device=dev).expand(m),
            depth=hit0.t, prim_id=hit0.prim_id, uv=hit0.uv, inst=hit0.inst,
        )
        q, traced = trace_wavefront(scene, intersect_fn, q, sampler, settings, occluded_fn, sort_rays,
                                    fused_fn=fused_fn, tail_anyhit=tail_anyhit)
        radiance = q.radiance
        del q
        if settings.radiance_clamp > 0.0:
            radiance = torch.clamp_max(radiance, settings.radiance_clamp)
        env = pathtracer._sample_env(scene, d)
        return radiance + torch.where(~hit0.hit[:, None], env, 0.0), traced + m, hit0

    if settings.sample_batch and settings.samples > 1:
        parts = [sample_rays(cam, settings, frame_index, s_i, blue_noise, tile_primaries)
                 for s_i in range(settings.samples)]
        o = torch.cat([p[0] for p in parts])
        d = torch.cat([p[1] for p in parts])
        sampler = rng.Sampler(seed=torch.cat([p[2].seed for p in parts]), index=parts[0][2].index)
        del parts
        radiance, traced_total, hit0 = run_wavefront(o, d, sampler, n * settings.samples)
        del o, d, sampler
        total = radiance.reshape(settings.samples, n, 3).sum(dim=0)
        del radiance
    else:
        total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        traced_total = torch.zeros((), dtype=torch.int64, device=dev)
        hit0 = None
        for s_i in range(settings.samples):
            radiance, traced, h0 = run_wavefront(
                *sample_rays(cam, settings, frame_index, s_i, blue_noise, tile_primaries), n)
            hit0 = h0 if hit0 is None else hit0
            total = total + radiance
            traced_total = traced_total + traced

    total = _unswizzle(total / float(settings.samples), tile, h, w)
    outs = [total]
    if return_stats:
        outs.append(traced_total)
    if return_gbuffer:
        # Sample 0's primary hits, un-swizzled as the film is.
        nrm = torch.where(hit0.hit[:n, None], scene_types.geometric_normals(scene, hit0.prim_id[:n]), 0.0)
        gb = _unswizzle(torch.cat([hit0.t[:n, None], nrm], dim=1), tile, h, w)
        outs.append((gb[..., 0], gb[..., 1:4]))
    return total if len(outs) == 1 else tuple(outs)
