"""How ``correct`` is decided: the film and the display that the window's
frames produced, at a sample of pixels drawn from the seed, against the
plain reference (``rtbench.reference``) given the same triangles,
materials, sky, blue noise, camera controls and frame indices.

The reference replays the traffic's controls through its own copy of the
viewer's camera update, traces every frame's paths at the sampled pixels
through its own BVH, blends them into its own film (reset where the camera
moved) and tone-maps it. Two numbers are compared, each with a limit of the
cell's own (``limits/<cell>.json``):

- ``film_err_p50``: the median over (frame, pixel) of the film's relative
  error, max over channels of |program − reference| / max(|reference|,
  1e-3). Paths that the two sides trace alike agree to the bit, so it
  reads the precision of the radiance, the blend and the lane state.
- ``worst_frame_bad_pct``: over the frames, the largest share of pixels
  whose display differs from the reference's by more than 1/255 in a
  channel (or is not finite). A path whose hit differs by rounding changes
  its pixel whole; a frame that is wrong shows in most of its pixels.

Each frame that goes over the second limit counts as ``failed``."""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import bvh as bvh_mod
from rtbench.reference import camera as camera_mod
from rtbench.reference import render as ref
from rtbench.reference import scene as scene_mod

DISPLAY_STEP = 1.0 / 255.0
FILM_FLOOR = 1e-3
LANES_PER_CHUNK = 1 << 20


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


def numbers(films, displays, ref_films, ref_displays) -> dict:
    """The compared numbers of program (or control) against reference:
    ``film_err_p50`` and ``worst_frame_bad_pct``, and the share of bad
    pixels of each frame."""
    den = torch.clamp_min(ref_films.abs().amax(dim=-1), FILM_FLOOR)
    rel = ((films - ref_films).abs().amax(dim=-1) / den).nan_to_num(nan=float("inf"))
    ddiff = (displays - ref_displays).abs().amax(dim=-1)
    bad = ~(ddiff <= DISPLAY_STEP)  # NaN counts as bad
    per_frame = bad.to(torch.float64).mean(dim=1) * 100.0
    return {"film_err_p50": float(rel.reshape(-1).median()), "worst_frame_bad_pct": float(per_frame.max()),
            "per_frame_bad_pct": per_frame.cpu().tolist()}


def judge(readings: dict, limits: dict) -> tuple[bool, list, int]:
    """(correct, lines "name number limit", failed frames) of readings
    against the cell's limits."""
    lines, ok = [], True
    for name in ("film_err_p50", "worst_frame_bad_pct"):
        v, lim = readings[name], limits[name]
        ok = ok and v <= lim
        lines.append((name, v, lim))
    failed = sum(1 for x in readings["per_frame_bad_pct"] if not x <= limits["worst_frame_bad_pct"])
    return ok, lines, failed


def compare(config, traffic, mesh, sky, bn_np, schedule, record, pix_flat, device, colour_dtype=None,
            state=None) -> dict:
    """Readings of a window's record (its gathered frames) against the
    reference; with ``colour_dtype`` the control's readings in the
    program's place instead."""
    state = state or reference_state(mesh, sky, device)
    bn = torch.as_tensor(bn_np, dtype=torch.float32, device=device)
    n = len(record.call)
    rf, rd = reference_frames(config, traffic, state, bn, schedule, record.base_index, n, pix_flat)
    idx = torch.as_tensor(record.gathered, dtype=torch.int64, device=device)
    if colour_dtype is None:
        films = torch.stack(record.films).to(device)
        displays = torch.stack(record.displays).to(device)
    else:
        cf, cd = reference_frames(config, traffic, state, bn, schedule, record.base_index, n, pix_flat,
                                  colour_dtype=colour_dtype)
        films, displays = cf[idx], cd[idx]
    return numbers(films, displays, rf[idx], rd[idx])
