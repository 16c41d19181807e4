"""Wavefront path tracer: the production renderer (port of
``raytracer3_tpu/render/wavefront.py``).

Rays live in flat [N] SoA queues; each bounce shades the recorded hit, runs
NEE with MIS (one any-hit launch, coherence-sorted), samples the BRDF,
applies Russian roulette and traces the next hit (one closest-hit launch,
coherence-sorted). The last bounce's hit only feeds the escape test, so it
and the final shadow batch ride ONE any-hit launch, in the frame's order as
in the reference: sorting it (29.5M lanes at instanced720's shape) cost
more on an H100 than it saved (PERF.md). The reference's
``lax.scan`` over bounces is a Python loop here.

Ported: the split path with the tail any-hit launch, a backend's own
primary trace (``primary_fn``) and sample batching (``settings.sample_batch``:
one wavefront of ``samples``·W·H lanes), and two-level (TLAS) backends,
whose hits carry the instance id through the queue (``RayQueue.inst``) into
``hit_surface_info``. Not yet, each raising
``NotImplementedError``: the fused shadow+bounce launch
(``settings.fuse_shadow``; K3 has its mixed-hit shape now, the wavefront's
wiring is ROADMAP M4b) and the lane diet (``settings.lane_diet``, not
bit-compatible).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import brdf, intersect, mathx, rng
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import pathtracer
from raytracer3_tpu_torch.scene import types as scene_types

_M32 = 0xFFFFFFFF
RR_START = 3  # first bounce with Russian roulette (the reference's default)


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


def sort_key_pos_dir(pos, d, alive, bounds=None) -> torch.Tensor:
    """Coherence sort key (int32): alive rays first, then direction octant,
    then an 18-bit Morton code of the position. ``bounds=(lo, hi)`` is the
    scene AABB; without it the bounds of the alive lanes are used."""
    octant = (
        (d[:, 0] >= 0).to(torch.int32)
        + 2 * (d[:, 1] >= 0).to(torch.int32)
        + 4 * (d[:, 2] >= 0).to(torch.int32)
    )
    if bounds is not None:
        lo, hi = bounds
    else:
        alive3 = alive[:, None]
        lo = torch.amin(torch.where(alive3, pos, torch.inf), dim=0)
        hi = torch.amax(torch.where(alive3, pos, -torch.inf), dim=0)
        no_alive = ~torch.isfinite(lo)
        lo = torch.where(no_alive, 0.0, lo)
        hi = torch.where(no_alive, 1.0, hi)
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
    """Trace with coherence-sorted IO, results in the caller's ray order:
    one [N, 6] gather in, one [N, 4] gather out (prim_id, and the instance
    id of a two-level trace as a fifth column, travel bit-cast through
    float32)."""
    perm = torch.argsort(sort_key_pos_dir(origins, directions, alive, bounds), stable=True)
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
    occlusion bits in the caller's ray order: one [N, 7] gather in (origin,
    direction, cap) and one scatter of the bits out. Lanes not ``alive``
    sort last. An any-hit answer does not depend on the order the rays are
    traced in, so the bits are those of the unsorted launch."""
    perm = torch.argsort(sort_key_pos_dir(origins, directions, alive, bounds), stable=True)
    packed = torch.cat([origins, directions, t_max[:, None]], dim=1)[perm]
    blocked_s = occluded_fn(packed[:, 0:3], packed[:, 3:6], packed[:, 6])
    blocked = torch.empty_like(blocked_s)
    blocked[perm] = blocked_s
    return blocked


def _check_settings(settings):
    if settings.lane_diet:
        raise NotImplementedError(
            "settings.lane_diet is not ported (not bit-compatible with the default path; ROADMAP M4b)"
        )
    if settings.fuse_shadow:
        raise NotImplementedError(
            "settings.fuse_shadow is not ported: K3 has the mixed-hit launch shape "
            "(TraceBackend.bind_capped), the wavefront's fused launch is ROADMAP M4b"
        )


def trace_wavefront(scene: scene_types.Scene, intersect_fn, q: RayQueue, sampler: rng.Sampler,
                    settings, occluded_fn=None, sort_rays: bool = False):
    """Run the bounce loop on a wavefront whose first hit is recorded in
    (depth, prim_id, uv, alive). Returns (final queue, traced-ray count)."""
    _check_settings(settings)
    q_env = pathtracer._env_mix_q(scene)
    use_nee = occluded_fn is not None and (
        int(scene.emissive.tri_ids.shape[0]) > 0 or q_env > 0.0
    )
    sort_bounds = (torch.amin(scene.positions, dim=0), torch.amax(scene.positions, dim=0))
    nb = int(settings.bounces)
    traced = torch.zeros((), dtype=torch.int64, device=q.origin.device)

    for b in range(nb):
        # Tail bounce: its hit only feeds the escape test → any-hit launch.
        last = b == nb - 1
        tail_any = last and occluded_fn is not None
        n_shadow = 0
        surface = scene_types.hit_surface_info(scene, q.prim_id, q.uv, q.inst)
        nrm = pathtracer._face_forward(surface.normal, -q.direction)

        # Emissive pickup, MIS-weighted against NEE after the first bounce.
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

        shadow = None
        if use_nee:
            u_l, sampler = sampler.next3()
            if tail_any:
                # Deferred: the shadow batch rides the tail any-hit launch.
                shadow = pathtracer._nee_prepare(
                    scene, hit_pos, nrm, -q.direction, surface, u_l, sampler, settings,
                    alive_mask=q.alive, throughput=q.throughput,
                )
                sampler = shadow[5]
                n_shadow = shadow[3].sum()
            else:
                li, sampler, n_shadow = pathtracer._nee_contribution(
                    scene, occluded_fn, hit_pos, nrm, -q.direction, surface, u_l,
                    sampler, settings, alive_mask=q.alive, sort_shadow=sort_rays,
                    sort_bounds=sort_bounds, return_count=True, throughput=q.throughput,
                )
                radiance = radiance + torch.where(q.alive[:, None], q.throughput * li, 0.0)

        # BRDF sample.
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

        # Russian roulette (static start; probability = max throughput).
        u_rr, sampler = sampler.next1()
        if b >= RR_START:
            p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
            survive = u_rr < p_cont
            throughput = torch.where(
                survive[:, None], throughput / torch.clamp_min(p_cont, 1e-6)[:, None], throughput
            )
            alive = alive & survive

        # Next hit. Dead lanes are parked far outside the scene.
        alive_at_trace = alive
        park = torch.where(alive[:, None], hit_pos, 1e30)
        m = park.shape[0]
        if tail_any:
            # ONE any-hit launch: [final NEE shadow batch ; escape probes].
            bg = torch.full((m,), mathx.BACKGROUND_DEPTH, dtype=torch.float32, device=park.device)
            if use_nee:
                sh_o, sh_d, sh_t, pre_ok, contrib, _ = shadow
                blocked2 = occluded_fn(
                    torch.cat([sh_o, park]), torch.cat([sh_d, new_dir]), torch.cat([sh_t, bg])
                )
                ok = pre_ok & ~blocked2[:m]
                radiance = radiance + torch.where((q.alive & ok)[:, None], q.throughput * contrib, 0.0)
                hit_bit = blocked2[m:]
            else:
                hit_bit = occluded_fn(park, new_dir, bg)
            h = intersect.Hit(
                t=bg,
                uv=torch.zeros((m, 2), dtype=torch.float32, device=park.device),
                prim_id=torch.where(hit_bit, 0, -1).to(torch.int32),
                hit=hit_bit,
                inst=None if q.inst is None else torch.zeros((m,), dtype=torch.int32, device=park.device),
            )
        elif sort_rays:
            h = sorted_trace(intersect_fn, park, new_dir, alive, sort_bounds)
        else:
            h = intersect_fn(park, new_dir)
        if use_nee and q_env > 0.0:
            # BRDF-sampled env escape, MIS-weighted against env NEE.
            env, env_pdf = pathtracer._env_radiance_pdf(scene, new_dir)
            w_env = prev_pdf / torch.clamp_min(prev_pdf + q_env * env_pdf, 1e-20)
            env = env * w_env[:, None]
        else:
            env = pathtracer._sample_env(scene, new_dir)
        radiance = radiance + torch.where((alive & ~h.hit)[:, None], throughput * env, 0.0)
        alive = alive & h.hit

        q = RayQueue(
            origin=hit_pos, direction=new_dir, throughput=throughput, radiance=radiance,
            pixel_id=q.pixel_id, alive=alive, prev_pdf=prev_pdf, depth=h.t,
            prim_id=h.prim_id, uv=h.uv, inst=h.inst,
        )
        # Ray meter: lanes alive entering the closest-hit trace + shadow
        # lanes that actually traversed.
        traced = traced + alive_at_trace.sum() + n_shadow
    return q, traced


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
def frame_pixels(width: int, height: int, device: torch.device):
    """(tile, pixel coords [N, 2] int32) of a frame, built once per size and
    device: tile-swizzled when a packet-sized tile divides the image (tile
    is its (w, h)), else row-major (tile None). The reference builds this
    order once, when it traces the frame under jit; built per frame here it
    costs a host argsort of every pixel and an upload. Callers must not
    write to the returned tensor."""
    tile = pick_tile(width, height)
    if tile is None:
        return None, camera_mod.pixel_grid(width, height, device=device)
    return tile, tiled_pixel_order(width, height, tile_w=tile[0], tile_h=tile[1], device=device)


def sample_rays(cam: camera_mod.Camera, settings, frame_index, s_i: int,
                blue_noise: Optional[torch.Tensor] = None):
    """Primary rays [W·H, 3] in the frame's pixel order (tile-swizzled where
    a tile fits) and the per-lane sampler of sample ``s_i`` of a frame; the
    jitter is decorrelated per sample via the scrambled frame index."""
    w, h = settings.width, settings.height
    _, pix = frame_pixels(w, h, cam.position.device)
    fi = ((int(frame_index) & _M32) * settings.samples + s_i) & _M32
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


def render_frame(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                 intersect_fn, occluded_fn=None, sort_rays: bool = False,
                 blue_noise: Optional[torch.Tensor] = None, return_stats: bool = False,
                 primary_fn=None):
    """One frame: primary rays → wavefront bounce loop → [H, W, 3] raw
    radiance. return_stats=True also returns the traced-ray count (a 0-dim
    int64 tensor): primaries + alive closest-hit lanes + NEE shadow lanes.
    primary_fn (a backend's ``bind_primary``) traces the tile-ordered
    primaries in place of ``intersect_fn``. With ``settings.sample_batch``
    and samples > 1 the samples run as ONE wavefront of samples·W·H lanes
    (sampler seeds concatenated per sample), else one after another."""
    _check_settings(settings)
    w, h = settings.width, settings.height
    n = w * h
    dev = scene.positions.device
    tile, pix = frame_pixels(w, h, dev)

    def run_wavefront(o, d, sampler, m):
        """Trace one wavefront of m = n·k lanes → (per-lane radiance with
        the primary-miss env, traced-ray count)."""
        hit0 = (primary_fn or intersect_fn)(o, d)
        q = RayQueue(
            origin=o, direction=d,
            throughput=torch.ones((m, 3), dtype=torch.float32, device=dev),
            radiance=torch.zeros((m, 3), dtype=torch.float32, device=dev),
            pixel_id=(pix[:, 1] * w + pix[:, 0]).to(torch.int32).repeat(m // n),
            alive=hit0.hit,
            prev_pdf=torch.full((m,), 1e8, dtype=torch.float32, device=dev),
            depth=hit0.t, prim_id=hit0.prim_id, uv=hit0.uv, inst=hit0.inst,
        )
        q, traced = trace_wavefront(scene, intersect_fn, q, sampler, settings, occluded_fn, sort_rays)
        radiance = q.radiance
        if settings.radiance_clamp > 0.0:
            radiance = torch.clamp_max(radiance, settings.radiance_clamp)
        env = pathtracer._sample_env(scene, d)
        return radiance + torch.where(~hit0.hit[:, None], env, 0.0), traced + m

    if settings.sample_batch and settings.samples > 1:
        parts = [sample_rays(cam, settings, frame_index, s_i, blue_noise) for s_i in range(settings.samples)]
        o = torch.cat([p[0] for p in parts])
        d = torch.cat([p[1] for p in parts])
        sampler = rng.Sampler(seed=torch.cat([p[2].seed for p in parts]), index=parts[0][2].index)
        del parts
        radiance, traced_total = run_wavefront(o, d, sampler, n * settings.samples)
        total = radiance.reshape(settings.samples, n, 3).sum(dim=0)
    else:
        total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        traced_total = torch.zeros((), dtype=torch.int64, device=dev)
        for s_i in range(settings.samples):
            radiance, traced = run_wavefront(*sample_rays(cam, settings, frame_index, s_i, blue_noise), n)
            total = total + radiance
            traced_total = traced_total + traced

    total = total / float(settings.samples)
    if tile is not None:
        # Undo the tile swizzle with reshapes.
        tw_, th_ = tile
        total = total.reshape(h // th_, w // tw_, th_, tw_, 3).permute(0, 2, 1, 3, 4).reshape(h, w, 3)
    else:
        total = total.reshape(h, w, 3)
    if return_stats:
        return total, traced_total
    return total
