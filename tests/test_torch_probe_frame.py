"""The probe-GI frame on the viewer's normal path: ``render/pipelines``'
split probe pipeline, ``app/viewer.make_probe_frame_fn`` and the probe
frame's traced-ray count, held to the benchmark's plain probe reference
(``rtbench/reference/probes.py``, which imports nothing of either package).

- The split pipeline (gbuffer, sis, probe_trace, sh, interpolate, post)
  against the one-pass body it replaced (``probe_gi_from_gbuffer`` /
  ``hybrid_gi_from_gbuffer`` in one ``probe_gi`` / ``hybrid_gi`` pass),
  bit for bit, probe and hybrid, eager on the CPU, through a cut.
- ``make_probe_frame_fn`` through a ``Viewer`` at 256x128 (16x8 probes) on
  the atrium at detail 1, six frames with a move at frame 3, against the
  reference at every pixel; the cut-down reference (the pixels of a
  sample and the probes they read) against the whole frame's.
- ``rays_traced`` against the lanes handed to the backend.
- On the card (``gpu``): the benchmark's ``sponza1080probe`` frame through
  ``Viewer.step``, one captured graph a frame with no sync inside, equal to
  the eager pipeline.

~100 s alone on one CPU thread (the cluster backend's plain walk)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.app import viewer as tviewer
from raytracer3_tpu_torch.graph import FrameGraph
from raytracer3_tpu_torch.ops import backend as tbackend
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import gbuffer as tgbuffer
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import postprocess as tpost
from raytracer3_tpu_torch.render import probes as tprobes
from raytracer3_tpu_torch.utils.config import RenderSettings
from rtbench import inputs, program
from rtbench.frames import probe_gi
from rtbench.reference import camera as rcamera
from rtbench.reference import probes as rprobes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

PROBE = {"probe_spacing": 16, "probe_res": 8, "probe_texel_splits": 1, "probe_bounces": 1, "probe_sh_fill": True,
         "blendfactor": 0.15}
START = ((-10.0, 2.2, 0.0), (1.0, 0.08, 0.05))


def _config(width, height):
    return {"name": "probe_frame_test", "scene": {"generator": "atrium", "detail": 1, "seed": 0, "ingest": "direct",
                                                 "sky": [64, 128]},
            "render": {"width": width, "height": height, "fov_y_deg": 65.0, "blue_noise": 16}, "probe": PROBE}


@pytest.fixture(scope="module")
def atrium():
    """The atrium at detail 1 (the benchmark's frozen generator) as a
    ``World`` on the CPU with the cluster backend, and the reference's own
    scene and tree from the same inputs."""
    cfg = _config(256, 128)
    mesh, sky, _ = inputs.scene_inputs(cfg)
    w = program.build_world(cfg, mesh, sky)
    return dict(scene=w.scene(device="cpu"), backend=w.trace_backend("cluster", device="cpu"),
                ref=probe_gi.reference_state(mesh, sky, "cpu"))


def _settings(width, height):
    return probe_gi.probe_settings(RenderSettings(width=width, height=height, bounces=1, samples=1), PROBE)


def _camera(width, height, device="cpu"):
    return tcamera.Camera.create(position=START[0], direction=START[1], fov_y_deg=65.0, aspect=width / height,
                                 device=device)


def _one_pass(scene, settings, backend, hybrid):
    """The probe pipeline as one ``probe_gi`` (or ``hybrid_gi``) pass between
    gbuffer and post: the body that the split replaced."""
    px, py = settings.probe_grid
    r_, w, h = settings.probe_res, settings.width, settings.height
    isect, occl = backend.bind(backend.arrays)
    primary = backend.bind_primary(backend.arrays)
    gi_fn = tprobes.hybrid_gi_from_gbuffer if hybrid else tprobes.probe_gi_from_gbuffer
    g = FrameGraph()
    g.image("gbuf_data", (h, w, 4), dtype=torch.int64)
    g.image("gbuf_depth", (h, w))
    g.temporal("probe_atlas", (py * r_, px * r_, 3))
    g.temporal("probe_depth", (py * r_, px * r_))
    if hybrid:
        g.temporal("direct_hist", (h, w, 3))
    g.image("light", (h, w, 3))
    g.image("display", (h, w, 3))
    g.image("sh", (py, px, 3, 9))

    def gbuffer(r, cam, frame_index):
        packed, _ = tprobes.trace_packed_gbuffer(scene, isect, cam, settings, primary_fn=primary)
        return {"gbuf_data": packed.data, "gbuf_depth": packed.depth}

    def gi(r, cam, frame_index):
        prev = tprobes.ProbeState(atlas=r["probe_atlas@prev"], depth=r["probe_depth@prev"],
                                  sh_coeffs=torch.zeros((py, px, 3, 9)))
        packed = tgbuffer.PackedGBuffer(data=r["gbuf_data"], depth=r["gbuf_depth"])
        bf = 1.0 if frame_index == 0 else 0.15
        light, st, aux = gi_fn(scene, isect, cam, packed, prev, settings, frame_index, blendfactor=bf,
                               occluded_fn=occl)
        out = {"probe_atlas": st.atlas, "probe_depth": st.depth, "sh": st.sh_coeffs}
        if hybrid:
            prev_direct = r["direct_hist@prev"]
            direct = prev_direct + ((light - aux["indirect"]) - prev_direct) * bf
            light = aux["indirect"] + direct
            out["direct_hist"] = direct
        out["light"] = light
        return out

    reads = ["gbuf_data", "gbuf_depth", "probe_atlas@prev", "probe_depth@prev"] + (
        ["direct_hist@prev"] if hybrid else [])
    writes = ["light", "probe_atlas", "probe_depth", "sh"] + (["direct_hist"] if hybrid else [])
    g.add_pass("gbuffer", gbuffer, writes=["gbuf_data", "gbuf_depth"])
    g.add_pass("hybrid_gi" if hybrid else "probe_gi", gi, reads=reads, writes=writes)
    g.add_pass("post", lambda r, cam, frame_index: {"display": tpost.postprocess(r["light"])}, reads=["light"],
               writes=["display"])
    return g.compile(output="display", jit=False), lambda: g.init_state("cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


@pytest.mark.parametrize("hybrid", [False, True], ids=["probe", "hybrid"])
def test_split_pipeline_bit_equal_to_one_pass(atrium, hybrid):
    """128x64 (8x4 probes), frames 0, 1, 2, a cut, 1: every display, the
    atlas, its depths and the hybrid's direct history bit for bit; the
    split pipeline's ``light`` is the display's input; its passes are the
    frame path's ``PASSES``."""
    s = _settings(128, 64)
    make = tpipelines.hybrid_gi_pipeline if hybrid else tpipelines.probe_gi_pipeline
    step, init = make(atrium["scene"], s, backend=atrium["backend"], device="cpu")
    assert step.pass_order == probe_gi.PASSES
    old_step, old_init = _one_pass(atrium["scene"], s, atrium["backend"], hybrid)
    cam = _camera(128, 64)
    st, old = init(), old_init()
    for fi in (0, 1, 2, 0, 1):
        disp, st = step(st, cam, fi)
        old_disp, old = old_step(old, cam=cam, frame_index=fi)
        np.testing.assert_array_equal(_bits(disp), _bits(old_disp))
        np.testing.assert_array_equal(_bits(tpost.postprocess(st["light"])), _bits(disp))
        for k in old:
            np.testing.assert_array_equal(_bits(st[k]), _bits(old[k]), err_msg=k)
    assert float(st["probe_atlas"].max()) > 0.0


def _relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-3)


def test_probe_viewer_matches_plain_reference(atrium):
    """``make_probe_frame_fn`` through a ``Viewer`` (3 in flight), six frames
    with a move at frame 3 (a camera cut), against the plain reference at
    every pixel of 256x128, the film (the lit image) and the display.

    Tolerances: the two sides trace different trees and sum the SH
    products and the pixel's four weights in another order, so a pixel
    whose hit or weight parts by rounding moves; the rest agree to the
    bit. Per frame the median relative error is 0 (measured 0), at least
    99.9% of pixels lie within 1e-5 relative (measured 99.99%) and every
    pixel within 1e-2 (measured 9.0e-4 at worst); every display pixel lies
    within one step of 1/255 (the check's display rule; measured all)."""
    w, h = 256, 128
    s = _settings(w, h)
    fn = tviewer.make_probe_frame_fn(atrium["scene"], s, backend=atrium["backend"], blendfactor=PROBE["blendfactor"])
    v = tviewer.Viewer(fn, _camera(w, h), s, frames_in_flight=3, device="cpu")
    cams, moved, films, displays = [], [], [], []
    for k in range(6):
        v.controls.move_z, v.controls.look_dx = (0.5, 0.05) if k == 3 else (0.0, 0.0)
        displays.append(v.step(dt=1 / 60).clone())
        cams.append(rcamera.Camera(*v.cam))
        moved.append(k == 3)
        films.append(v.film.accum.clone())
    v.drain()
    assert v.film.frame_index == 3
    scene, tree = atrium["ref"]
    ctx = rprobes.Ctx(scene=scene, bvh=tree, settings=probe_gi.reference_settings(_config(w, h)), colour_dtype=None)
    light, disp = rprobes.frames(ctx, cams, moved, torch.arange(w * h))
    film = torch.stack(films).reshape(6, -1, 3)
    shown = torch.stack(displays).reshape(6, -1, 3)
    for k in range(6):
        rel = _relative(film[k], light[k])
        assert float(rel.median()) == 0.0, k
        assert float((rel <= 1e-5).float().mean()) >= 0.999, k
        assert float(rel.max()) <= 1e-2, k
        assert bool(((shown[k] - disp[k]).abs().amax(-1) <= 1.0 / 255.0).all()), k
    # The check's cut: 32 pixels and the probes they read, equal to the
    # whole frame's reference at those pixels.
    pix = torch.as_tensor(np.sort(np.random.default_rng(7).choice(w * h, 32, replace=False)))
    light_cut, disp_cut = rprobes.frames(ctx, cams, moved, pix)
    torch.testing.assert_close(light_cut, light[:, pix], rtol=0.0, atol=0.0)
    torch.testing.assert_close(disp_cut, disp[:, pix], rtol=0.0, atol=0.0)


def _counting(backend):
    """The backend with every trace counting the lanes it traverses (those
    not parked at 1e30), and the count."""
    seen = [0]

    def live(o):
        seen[0] += int((o.abs() < 1e29).all(dim=-1).sum())

    def isect(arrays, o, d):
        live(o)
        return backend.intersect_fn(arrays, o, d)

    def occl(arrays, o, d, t):
        live(o)
        return backend.occluded_fn(arrays, o, d, t)

    def primary(arrays, o, d):
        live(o)
        return (backend.primary_fn or backend.intersect_fn)(arrays, o, d)

    return tbackend.TraceBackend(backend.arrays, isect, occl, primary_fn=primary), seen


@pytest.mark.parametrize("hybrid", [False, True], ids=["probe", "hybrid"])
def test_rays_traced_counts_the_lanes_launched(atrium, hybrid):
    """After three frames (a cut at the second) the pipeline's
    ``rays_traced`` equals the lanes handed to the backend that traverse:
    every G-buffer primary and probe ray, the shadow lanes not parked (and
    the hybrid's direct shadow lanes); the cut does not clear it. The probe
    frame function hands the same count on through a ``Viewer``."""
    s = _settings(128, 64)
    be, seen = _counting(atrium["backend"])
    make = tpipelines.hybrid_gi_pipeline if hybrid else tpipelines.probe_gi_pipeline
    step, init = make(atrium["scene"], s, backend=be, device="cpu")
    st, cam = init(), _camera(128, 64)
    for fi in (0, 0, 1):
        _, st = step(st, cam, fi)
    px, py = s.probe_grid
    assert int(st["rays_traced"]) == seen[0]
    assert seen[0] > 3 * (128 * 64 + px * py * s.probe_res ** 2)
    if hybrid:
        return
    seen[0] = 0
    v = tviewer.Viewer(tviewer.make_probe_frame_fn(atrium["scene"], s, backend=be), _camera(128, 64), s,
                       device="cpu")
    for k in range(3):
        v.controls.move_z = 0.5 if k == 1 else 0.0
        v.step()
    v.drain()
    assert v.rays_traced() == seen[0]


@pytest.mark.gpu
def test_compiled_probe_frame_on_card_equals_eager():
    """The benchmark's ``sponza1080probe`` configuration (1920x1088, the
    299,508-triangle atrium through GLB ingest and the treelet backend) on
    the card: ``make_probe_frame_fn`` through ``Viewer.step``, a frame one
    replay of one captured graph (2 + 1 K3 launches, no host sync under
    ``set_sync_debug_mode("error")``), equal bit for bit to the eager
    pipeline on frames 0-2, a cut and the frame after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from rtbench import spec, traffic

    cell = spec.cell("sponza1080probe.walk1")
    cfg, dev = cell.config, torch.device("cuda")
    mesh, sky, bn = inputs.scene_inputs(cfg)
    prog = program.Program(cfg, cell.traffic, mesh, sky, bn, dev, cell.frame)
    sched = traffic.Schedule(cell.traffic, 5)
    v = tviewer.Viewer(prog.frame_fn, prog.camera(sched.start_position, sched.start_direction), prog.settings,
                       frames_in_flight=8, device=dev)
    shown = []
    for k in range(5):
        v.controls.move_z = 0.5 if k == 3 else 0.0
        if k == 2:
            torch.cuda.synchronize()
            before = dict(tk.LAUNCHES)
            torch.cuda.set_sync_debug_mode("error")
        try:
            disp = v.step()
            shown.append((v.cam, v.film.frame_index - 1, disp, v.film.accum.clone()))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    v.drain()
    launched = {k: n - before.get(k, 0) for k, n in tk.LAUNCHES.items() if n != before.get(k, 0)}
    assert launched.get("seg_closest") == 2 * 3 and launched.get("seg_any") == 3, launched
    assert v.rays_traced() > 5 * 1920 * 1088
    s = probe_gi.probe_settings(prog.settings, cfg["probe"])
    eager, init = tpipelines.probe_gi_pipeline(prog.scene, s, backend=prog.backend, device=dev, jit=False)
    est = init()
    for k, (cam, film_index, disp, light) in enumerate(shown):
        edisp, est = eager(est, cam, film_index)
        assert torch.equal(disp, edisp), k
        assert torch.equal(light, est["light"]), k
