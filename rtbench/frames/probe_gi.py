"""The probe-GI frame path: the reference application's real-time GI mode
(screen-space octahedral radiance probes, ``shaders/old/``), the viewer's
``app/viewer.make_probe_frame_fn`` over
``render/pipelines.probe_gi_pipeline``'s compiled step (gbuffer, sis,
probe_trace, sh, interpolate, post; one CUDA graph a frame on the card),
its lit image before AgX as the colour state, and the plain reference of
it (``rtbench.reference.probes``).

The configuration's ``"probe"`` block sets the probe layout and the blend
factor on top of its render block. The pipeline's frame index is the
film's count: each moved frame is a camera cut. The reference replays the
traffic's controls through its own copy of the viewer's camera update and
traces only the probes that the sampled pixels read: their tiles once a
pose, their rays every frame."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench.frames import wavefront
from rtbench.reference import probes as ref

# The compiled step's ``pass_order``: pass marker I runs before PASSES[I].
PASSES = ("gbuffer", "sis", "probe_trace", "sh", "interpolate", "post")


def probe_settings(program_settings, probe: dict):
    """The program's render settings with the configuration's probe block."""
    return dataclasses.replace(program_settings, probe_spacing=probe["probe_spacing"], probe_res=probe["probe_res"],
                               probe_texel_splits=probe["probe_texel_splits"], probe_bounces=probe["probe_bounces"],
                               probe_sh_fill=probe["probe_sh_fill"])


def frame_fn(program):
    """``make_probe_frame_fn`` on the program's scene and backend, with the
    configuration's probe block; it counts its traced rays."""
    from raytracer3_tpu_torch.app import viewer as viewer_mod

    probe = program.config["probe"]
    return viewer_mod.make_probe_frame_fn(program.scene, probe_settings(program.settings, probe),
                                          backend=program.backend, blendfactor=probe["blendfactor"])


def colour_state(viewer):
    """The film's accumulation: the frame's lit image before AgX."""
    return viewer.film.accum


def reference_state(mesh: dict, sky: np.ndarray, device):
    """The reference's own scene and tree, from the raw inputs."""
    return wavefront.reference_state(mesh, sky, device)


def reference_settings(config: dict) -> ref.Settings:
    """The reference's settings; it covers one bounce and every texel
    traced every frame, and refuses anything else."""
    r, probe = config["render"], config["probe"]
    if probe["probe_texel_splits"] != 1 or probe["probe_bounces"] != 1:
        raise ValueError("the probe reference traces every texel every frame, one bounce: "
                         f"probe_texel_splits {probe['probe_texel_splits']}, probe_bounces {probe['probe_bounces']}")
    return ref.Settings(width=r["width"], height=r["height"], spacing=probe["probe_spacing"], res=probe["probe_res"],
                        blendfactor=probe["blendfactor"], sh_fill=probe["probe_sh_fill"])


def reference_frames(config: dict, traffic: dict, state, blue_noise: torch.Tensor, schedule, base_index: int,
                     n_frames: int, pix_flat: torch.Tensor, colour_dtype=None):
    """(film, display) [n, P, 3] of the reference at the sampled pixels
    after each window frame: the lit image and its AgX display. The
    pipeline's frame index restarts with the film, so ``base_index`` and
    the blue noise (the probe frame jitters nothing) are not read."""
    scene, tree = state
    ref.no_tf32()
    ctx = ref.Ctx(scene=scene, bvh=tree, settings=reference_settings(config), colour_dtype=colour_dtype)
    poses = wavefront.cameras(config, schedule, n_frames, pix_flat.device)
    return ref.frames(ctx, [c for c, _ in poses], [m for _, m in poses], pix_flat)
