"""The probe-GI frame path (``frames/probe_gi.py``): its ``PASSES`` are the
port's probe pipeline's pass order, and the check's cut-down reference
(the sampled pixels and the probes they read) equals the whole frame's
reference at those pixels."""

from __future__ import annotations

import numpy as np
import torch

from rtbench import inputs, program, spec
from rtbench.frames import probe_gi
from rtbench.reference import camera as rcamera
from rtbench.reference import probes as rprobes

W, H = 64, 48
PROBE = {"probe_spacing": 16, "probe_res": 8, "probe_texel_splits": 1, "probe_bounces": 1, "probe_sh_fill": True,
         "blendfactor": 0.15}
CONFIG = {"name": "probe_gi_test", "scene": {"generator": "atrium", "detail": 1, "seed": 0, "ingest": "direct",
                                             "sky": [64, 128]},
          "render": {"width": W, "height": H, "fov_y_deg": 65.0, "blue_noise": 16}, "probe": PROBE}


def test_passes_are_the_pipelines_pass_order():
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.utils.config import RenderSettings

    mesh, sky, _ = inputs.scene_inputs(CONFIG)
    w = program.build_world(CONFIG, mesh, sky)
    s = probe_gi.probe_settings(RenderSettings(width=W, height=H, bounces=1, samples=1), PROBE)
    for make in (pipelines.probe_gi_pipeline, pipelines.hybrid_gi_pipeline):
        step, _ = make(w.scene(device="cpu"), s, backend=w.trace_backend("brute", device="cpu"), device="cpu")
        assert step.pass_order == probe_gi.PASSES
    assert spec.frame_path("probe_gi").PASSES == probe_gi.PASSES


def test_cut_down_reference_equals_whole_frame_at_the_sampled_pixels():
    """Five frames, a move (a camera cut) at frame 2: the reference at 12
    sampled pixels (the probes they read, their tiles and rays) against the
    reference of every pixel (every probe), film and display, bit for bit."""
    mesh, sky, _ = inputs.scene_inputs(CONFIG)
    scene, tree = probe_gi.reference_state(mesh, sky, "cpu")
    ctx = rprobes.Ctx(scene=scene, bvh=tree, settings=probe_gi.reference_settings(CONFIG), colour_dtype=None)
    cam = rcamera.Camera.create(position=(-10.0, 2.2, 0.0), direction=(1.0, 0.08, 0.05), fov_y_deg=65.0,
                                aspect=W / H, device="cpu")
    cams, moved = [], []
    for k in range(5):
        if k == 2:
            cam = rcamera.orbit_camera(cam, 0.05, 0.0, (0.0, 0.0, 1.0), 1 / 60)
        cams.append(cam)
        moved.append(k == 2)
    light, disp = rprobes.frames(ctx, cams, moved, torch.arange(W * H))
    pix = torch.as_tensor(np.sort(np.random.default_rng(3).choice(W * H, 12, replace=False)))
    light_cut, disp_cut = rprobes.frames(ctx, cams, moved, pix)
    assert torch.equal(light_cut, light[:, pix]) and torch.equal(disp_cut, disp[:, pix])
    assert float(light.max()) > 0.0
    assert rprobes.frame_words(moved) == [0, 1, 0, 1, 2]
