"""The wavefront frame path, which a configuration without ``"frame"``
takes: the viewer's default progressive frame
(``app/viewer.make_default_frame_fn`` over
``render/pipelines.wavefront_pipeline``'s compiled step: trace, blend,
post; one CUDA graph a frame on the card), its film as the colour state,
and the plain reference of it (``rtbench.reference``).

The reference replays the traffic's controls through its own copy of the
viewer's camera update, traces every frame's paths at the sampled pixels
through its own BVH, blends them into its own film (reset where the camera
moved) and tone-maps it."""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import bvh as bvh_mod
from rtbench.reference import camera as camera_mod
from rtbench.reference import render as ref
from rtbench.reference import scene as scene_mod

LANES_PER_CHUNK = 1 << 20
# The compiled step's ``pass_order``: pass marker I runs before PASSES[I].
PASSES = ("trace", "blend", "post")


def frame_fn(program):
    """``make_default_frame_fn`` on the program's scene, render settings,
    backend and blue noise; it counts its traced rays."""
    from raytracer3_tpu_torch.app import viewer as viewer_mod

    return viewer_mod.make_default_frame_fn(program.scene, program.settings, backend=program.backend,
                                            blue_noise=program.blue_noise)


def colour_state(viewer):
    """The film's accumulation."""
    return viewer.film.accum


def reference_state(mesh: dict, sky: np.ndarray, device):
    """The reference's own scene and tree, from the raw inputs."""
    return scene_mod.make_scene(mesh, sky, device=device), bvh_mod.build(mesh["positions"], mesh["indices"],
                                                                         device=device)


def cameras(config: dict, schedule, n_frames: int, device):
    """(camera, moved) of window frames 0 .. n−1: the start pose, then the
    viewer's camera update for each frame whose controls move."""
    r = config["render"]
    cam = camera_mod.Camera.create(position=tuple(schedule.start_position),
                                   direction=tuple(schedule.start_direction), fov_y_deg=r["fov_y_deg"],
                                   aspect=r["width"] / r["height"], device=device)
    out = []
    for k in range(n_frames):
        ctl = schedule.controls(k)
        moved = any(abs(v) > 1e-9 for v in ctl)
        if moved:
            cam = camera_mod.orbit_camera(cam, -ctl[3] * 1.0, -ctl[4] * 1.0, ctl[0:3], schedule.dt)
        out.append((cam, moved))
    return out


def reference_frames(config: dict, traffic: dict, state, blue_noise: torch.Tensor, schedule, base_index: int,
                     n_frames: int, pix_flat: torch.Tensor, colour_dtype=None):
    """(film, display) [n, P, 3] of the reference at the sampled pixels
    after each window frame."""
    scene, tree = state
    r = config["render"]
    settings = ref.Settings(width=r["width"], height=r["height"], bounces=r["bounces"], samples=traffic["samples"],
                            radiance_clamp=r["radiance_clamp"], lane_diet=traffic["lane_diet"])
    ctx = ref.Ctx(scene=scene, bvh=tree, settings=settings, colour_dtype=colour_dtype)
    dev = pix_flat.device
    p = pix_flat.shape[0]
    s = settings.samples
    pix = torch.stack([pix_flat % r["width"], pix_flat // r["width"]], dim=-1)
    cams = cameras(config, schedule, n_frames, dev)

    # Lanes in (frame, sample, pixel) order, as many frames to a wavefront
    # as a chunk holds, each frame's primaries under its own camera; the
    # frame word as wavefront.sample_rays forms it.
    per_frame = s * p
    spp = torch.arange(s, device=dev)
    lane_pix = pix[None].expand(s, p, 2).reshape(-1, 2)
    totals = []
    for k0 in range(0, n_frames, max(1, LANES_PER_CHUNK // per_frame)):
        ks = range(k0, min(n_frames, k0 + max(1, LANES_PER_CHUNK // per_frame)))
        o, d, fis = [], [], []
        for k in ks:
            fw = (((k + base_index) & 0xFFFFFFFF) * s + spp) & 0xFFFFFFFF
            fi = fw[:, None].expand(s, p).reshape(-1)
            ok, dk = ref.primaries(ctx, cams[k][0], lane_pix, fi, blue_noise)
            o.append(ok)
            d.append(dk)
            fis.append(fi)
        rad = ref.lane_radiance(ctx, torch.cat(o), torch.cat(d), lane_pix.repeat(len(ks), 1), torch.cat(fis))
        rad = rad.reshape(len(ks), s, p, 3)
        for f in range(len(ks)):
            if traffic["sample_batch"] and s > 1:
                total = rad[f].sum(dim=0)
            else:
                total = torch.zeros((p, 3), dtype=torch.float32, device=dev)
                for si in range(s):
                    total = total + rad[f, si]
            totals.append(ref._rc(ctx, total / float(s)))

    film = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    count = 0
    films, displays = [], []
    for k in range(n_frames):
        if cams[k][1]:
            film = torch.zeros_like(film)
            count = 0
        n = torch.full((), float(count), dtype=torch.float32, device=dev)
        film = ref.blend(ctx, film, totals[k], n)
        count += 1
        films.append(film)
        displays.append(ref.display(film))
    return torch.stack(films), torch.stack(displays)
