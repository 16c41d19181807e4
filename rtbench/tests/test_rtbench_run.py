"""Whole runs of the tiny CPU cells through the harness (its look for a
card skipped): the result line's shape, ``correct`` true for the program
and false when the timed path is broken underneath, the traced stretch's
ray count, the exit without a card, and no JAX module loaded."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from rtbench import faults, inputs, program, run, spec, traffic
from rtbench.tests import helpers


def _run(name, seed=11, seconds=4.0, trace=False, frame_wrapper=None):
    return run.run_cell(helpers.cell(name), seed, seconds, trace, "cpu", time.perf_counter(),
                        frame_wrapper=frame_wrapper, log=lambda *a, **k: None)


@pytest.mark.parametrize("name", ["tiny.tinywalk1", "tiny.tinystill16"])
def test_result_line_shape_and_correct(name):
    res, lines = _run(name)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"frame_ms", "setup_s"} | ({"latency_ms_p95"} if name.endswith("walk1") else set())
    assert want <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["checks"]) == {"film_err_p50", "worst_frame_bad_pct"}
    assert [ln.split()[1] for ln in lines] == list(res["checks"])
    json.loads(json.dumps(res))


def test_traced_line_shape():
    res, _ = _run("tiny.tinywalk1", seed=12, seconds=6.0, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"} and list(res)[-1] == "checks"
    assert all(len(v) <= 10 for v in res["breakdown"].values())


def _eager_rays(prog, cam, frame_index: int) -> int:
    """A frame's traced rays as the harness once counted them: an eager
    ``render_frame`` of the viewer's frame with that camera and index."""
    from raytracer3_tpu_torch.render import wavefront

    b = prog.backend
    isect, occl = b.bind(b.arrays)
    _, n = wavefront.render_frame(prog.scene, cam, prog.settings, frame_index, isect, occl,
                                  sort_rays=not b.self_sorting, blue_noise=prog.blue_noise, return_stats=True,
                                  primary_fn=b.bind_primary(b.arrays))
    return int(n)


def _program(cell):
    mesh, sky, bn = inputs.scene_inputs(cell.config)
    return program.Program(cell.config, cell.traffic, mesh, sky, bn, "cpu", cell.frame)


@pytest.mark.parametrize("name", ["tiny.tinywalk1", "tiny.tinystill16"])
def test_stretch_rays_are_the_frame_functions_count(name):
    """The traced stretch's rays, read from ``Viewer.rays_traced()`` at its
    two drained ends, equal the eager per-frame counts summed."""
    cell = helpers.cell(name)
    tr, r = cell.traffic, cell.config["render"]
    prog = _program(cell)
    schedule = traffic.Schedule(tr, 14)
    viewer = prog.viewer(schedule)
    base = program.warm_up(viewer, schedule)
    pix = torch.as_tensor(traffic.pixel_sample(14, tr["check_pixels"], r["height"], r["width"]))
    rec = program.run_window(viewer, schedule, 4.0, pix, base, cell.frame.colour_state,
                             stretch_frames=int(tr["trace_frames"]), profile_fn=contextlib.nullcontext)
    st = rec.stretch
    assert st is not None and len(st["cams"]) == tr["trace_frames"]
    eager = sum(_eager_rays(prog, c, fi) for c, fi in zip(st["cams"], st["frame_indices"]))
    assert st["rays"] == eager > 0


def test_the_wavefront_passes_are_the_pipelines_pass_order():
    """``frames/wavefront.PASSES``, by which the pass readers name what
    they read, is the order the wavefront pipeline's compiled step marks:
    a pass reordered or inserted there fails here."""
    from raytracer3_tpu_torch.render import pipelines

    cell = helpers.cell("tiny.tinywalk1")
    prog = _program(cell)
    step, _ = pipelines.wavefront_pipeline(prog.scene, prog.settings, backend=prog.backend,
                                           sort_rays=not prog.backend.self_sorting, blue_noise=prog.blue_noise,
                                           device="cpu")
    assert spec.frame_path("wavefront").PASSES == step.pass_order
    assert cell.frame.PASSES == step.pass_order


def test_a_frame_path_that_counts_no_rays_is_refused(tmp_path):
    here = tmp_path / "rtbench"
    shutil.copytree(helpers.DATA, here)
    (here / "frames" / "nocount.py").write_text(
        "from rtbench.frames import wavefront\n"
        "from rtbench.frames.wavefront import colour_state, reference_frames, reference_state  # noqa: F401\n\n\n"
        "def frame_fn(program):\n"
        "    inner = wavefront.frame_fn(program)\n"
        "    return lambda film, cam, fi: inner(film, cam, fi)\n")
    cell = helpers.cell("tiny.tinywalk1")
    cell = dataclasses.replace(cell, frame=spec.frame_path("nocount", here=str(here)))
    with pytest.raises(RuntimeError, match="nocount.py"):
        _program(cell)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["tiny.tinywalk1", "tiny.tinystill16"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res, _ = _run(name, seed=13, seconds=6.0, frame_wrapper=faults.FAULTS[fault])
    assert res["attempted"] >= 2
    assert res["correct"] is False and res["failed"] >= 1


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(helpers.ROOT, "rtbench", "run.py"), "--workload",
                           "atrium1080.walk1", "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          cwd=helpers.ROOT, timeout=300)
    assert proc.returncode == 3 and proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_no_jax_module_is_loaded():
    """After the harness and its reference are imported and a tiny cell has
    run, no module whose top-level name is jax's or the JAX package's is
    loaded; the port's own name passes the whole-name compare."""
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);\n"
            "import rtbench.run, rtbench.check, rtbench.program, rtbench.tracing, rtbench.calibrate\n"
            "import rtbench.reference.render, rtbench.reference.bvh\n"
            "from rtbench.tests import helpers\n"
            "rtbench.run.run_cell(helpers.cell('tiny.tinywalk1'), 3, 1.0, False, 'cpu', time.perf_counter(),"
            " log=lambda *a, **k: None)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'raytracer3_tpu_torch')[:1])\n"
            "print(rtbench.run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code, helpers.ROOT], capture_output=True, text=True,
                          cwd=helpers.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    port, found = proc.stdout.strip().splitlines()[-2:]
    assert port == "['raytracer3_tpu_torch']" and found == "[]"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("raytracer3_tpu_torch_fake_probe", sys)
    try:
        assert "raytracer3_tpu_torch_fake_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["raytracer3_tpu_torch_fake_probe"]
