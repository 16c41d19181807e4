"""The port's interactive viewer (``app/viewer.py``) and the camera pieces it
drives (``camera.orbit_camera``, the camera matrices, ``film.reset``)
against the JAX reference.

- ``tests/test_app_utils.py::TestViewer``'s three cases on the port (the
  Cornell box through the brute-force backend).
- A scripted 16×16 path (frames, a move, frames, a look, frames) through
  the port's ``Viewer`` and the reference's, the same scene, camera and
  settings: every display holds ≥ 99% of its pixels within 1e-4 of the
  reference's (the display rule of ``test_torch_wavefront.py``).
- ``orbit_camera`` and the view / projection matrices and their inverses
  at rtol 1e-6 (atol 1e-6 for entries that are 0 in one package and a
  rounding residue in the other).
- ``InteractiveSession.handle`` on one script prints the same status lines
  in both packages (``fps`` apart: it is a wall-clock rate); ``run`` reads
  an ``os.pipe`` stream; ``main`` runs as a subprocess on the CPU;
  ``save`` writes a PNG through PIL.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.app import viewer as jviewer
from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.utils.config import RenderSettings as JSettings
from raytracer3_tpu_torch.app import viewer as tviewer
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import film as tfilm
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.scene import types as ttypes
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cornell():
    jscene = janalytic.cornell_box()
    jcam = janalytic.default_camera()
    tscene = ttypes.scene_from_numpy(jscene._asdict(), "cpu")
    tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
    return jscene, jcam, tscene, tcam


def _tiny_setup():
    # test_app_utils.py's tiny_setup on the port.
    scene = tanalytic.cornell_box(device=CPU)
    cam = tanalytic.default_camera(device=CPU)
    v0, v1, v2 = scene.tri_vertices()
    settings = RenderSettings(width=8, height=8, bounces=1, samples=1, diffuse_only=True)
    return scene, cam, settings, lambda o, d: tintersect.intersect_bruteforce(o, d, v0, v1, v2)


# ---------------------------------------------------------------------------
# test_app_utils.py::TestViewer on the port
# ---------------------------------------------------------------------------


def test_progressive_accumulates():
    scene, cam, settings, isect = _tiny_setup()
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, settings, isect, None), cam, settings, device=CPU)
    for _ in range(3):
        v.step()
    v.drain()
    assert v.film.frame_index == 3
    assert bool(v.film.accum.isfinite().all())


def test_camera_move_resets_accumulation():
    scene, cam, settings, isect = _tiny_setup()
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, settings, isect, None), cam, settings, device=CPU)
    v.step()
    v.step()
    assert v.film.frame_index == 2
    v.controls.move_z = 1.0  # W held
    v.step()
    v.controls.move_z = 0.0
    # The reset happened before the new frame: the count restarted at 1.
    assert v.film.frame_index == 1
    assert float(torch.linalg.vector_norm(v.cam.position - cam.position)) > 0.01


def test_orbit_look():
    cam = tanalytic.default_camera(device=CPU)
    cam2 = tcamera.orbit_camera(cam, 0.3, 0.1, torch.zeros(3), 1 / 60)
    assert float(torch.linalg.vector_norm(cam2.direction - cam.direction)) > 0.01
    np.testing.assert_allclose(float(torch.linalg.vector_norm(cam2.direction)), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Camera pieces against the reference
# ---------------------------------------------------------------------------

ORBITS = [
    (0.3, 0.1, (0.0, 0.0, 0.0), 1 / 60),
    (-1.2, -0.4, (1.0, 0.0, 1.0), 0.05),
    (0.0, 0.0, (0.0, -1.0, 0.3), 1 / 30),
    (2.5, 1.4, (0.5, 0.5, -1.0), 0.1),  # pitches past the pole: the clamp keeps the yawed direction
    (0.05, -1.5, (0.0, 0.0, 1.0), 1 / 60),
]


@pytest.mark.parametrize("yaw, pitch, move, dt", ORBITS)
def test_orbit_camera_matches_reference(cornell, yaw, pitch, move, dt):
    _, jcam, _, tcam = cornell
    for _ in range(3):  # chained updates, as a held key gives
        jcam = jcamera.orbit_camera(jcam, jnp.asarray(yaw), jnp.asarray(pitch), jnp.asarray(move, jnp.float32),
                                    jnp.asarray(dt, jnp.float32))
        tcam = tcamera.orbit_camera(tcam, yaw, pitch, move, dt)
        for name in ("position", "direction"):
            np.testing.assert_allclose(getattr(tcam, name).numpy(), np.asarray(getattr(jcam, name)), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_camera_matrices_match_reference(cornell):
    _, jcam, _, tcam = cornell
    jcam = jcamera.orbit_camera(jcam, jnp.asarray(0.4), jnp.asarray(0.2), jnp.asarray([1.0, 0.5, 2.0], jnp.float32),
                                jnp.asarray(0.1, jnp.float32))
    tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
    for got, ref in zip(tcam.matrices(), jcam.matrices()):
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_film_reset_matches_reference():
    from raytracer3_tpu.render import film as jfilm

    f = tfilm.Film(accum=torch.ones(4, 4, 3), frame_index=9)
    r = tfilm.reset(f)
    ref = jfilm.reset(jfilm.Film(accum=jnp.ones((4, 4, 3)), frame_index=jnp.asarray(9, jnp.int32)))
    assert r.frame_index == int(ref.frame_index) == 0
    np.testing.assert_array_equal(r.accum.numpy(), np.asarray(ref.accum))
    assert f.frame_index == 9 and bool((f.accum == 1).all())


# ---------------------------------------------------------------------------
# The Viewer on a scripted path against the reference's
# ---------------------------------------------------------------------------

# (controls set before the step; None holds still)
SCRIPT = [None, None, None, dict(move_z=1.0), dict(move_z=0.0), None, dict(look_dx=0.2, look_dy=-0.05), None, None]


def _drive(viewer, script):
    displays = []
    for c in script:
        for k, val in (c or {}).items():
            setattr(viewer.controls, k, val)
        d = viewer.step()
        displays.append(d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d))
    viewer.drain()
    return displays


@pytest.fixture(scope="module")
def scripted(cornell):
    jscene, jcam, tscene, tcam = cornell
    s = RenderSettings(width=16, height=16, bounces=2, samples=1)
    js = JSettings(width=16, height=16, bounces=2, samples=1)
    jv = jviewer.Viewer(jviewer.make_default_frame_fn(jscene, js, backend=jintersect.brute_backend(scene=jscene)),
                        jcam, js)
    tv = tviewer.Viewer(tviewer.make_default_frame_fn(tscene, s, backend=tintersect.brute_backend(
        scene=tscene, device=CPU)), tcam, s, device=CPU)
    return _drive(jv, SCRIPT), _drive(tv, SCRIPT), jv, tv


def test_viewer_displays_match_reference(scripted):
    jd, td, jv, tv = scripted
    assert len(jd) == len(td) == len(SCRIPT)
    for i, (ref, got) in enumerate(zip(jd, td)):
        assert got.shape == (16, 16, 3) and np.isfinite(got).all()
        share = (np.abs(got - ref).max(-1) <= 1e-4).mean()
        assert share >= 0.99, (i, share)
    # The move reset the film at step 3; the look at step 6.
    assert tv.film.frame_index == int(jv.film.frame_index) == 3
    assert tv.frame_index == jv.frame_index == len(SCRIPT)
    np.testing.assert_allclose(tv.cam.position.numpy(), np.asarray(jv.cam.position), rtol=1e-6)
    np.testing.assert_allclose(tv.cam.direction.numpy(), np.asarray(jv.cam.direction), rtol=1e-6, atol=1e-7)


def test_viewer_is_the_reference_composition(cornell):
    # The frame function is render_frame → accumulate_progressive →
    # postprocess, with film.reset on a move: composed here by hand, the
    # displays are bit-equal.
    from raytracer3_tpu_torch.render import postprocess, wavefront

    _, _, tscene, tcam = cornell
    s = RenderSettings(width=16, height=16, bounces=2, samples=1)
    b = tintersect.brute_backend(scene=tscene, device=CPU)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(tscene, s, backend=b), tcam, s, frames_in_flight=1, device=CPU)
    isect, occl = b.bind(b.arrays)
    film, cam = tfilm.Film.create(16, 16, device=CPU), tcam
    for i, c in enumerate(SCRIPT):
        for k, val in (c or {}).items():
            setattr(v.controls, k, val)
        if v.controls.moving:
            yaw, pitch = v.controls.look_dx, v.controls.look_dy
            cam = tcamera.orbit_camera(cam, -yaw, -pitch, (v.controls.move_x, v.controls.move_y, v.controls.move_z),
                                       1 / 60)
            film = tfilm.reset(film)
        display = v.step()
        film = tfilm.accumulate_progressive(film, wavefront.render_frame(tscene, cam, s, i, isect, occl,
                                                                         sort_rays=True))
        assert torch.equal(display, postprocess.postprocess(film.accum)), i
    assert film.frame_index == v.film.frame_index


def test_drain_twice_keeps_the_last_display(cornell):
    _, _, tscene, tcam = cornell
    s = RenderSettings(width=8, height=8, bounces=1, samples=1)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(tscene, s, backend=tintersect.brute_backend(
        scene=tscene, device=CPU)), tcam, s, device=CPU)
    assert v.drain() is None and v.fps == 0.0
    last = v.step()
    assert v.drain() is last and v.drain() is last
    # One finished frame has no rate yet; a second one gives it.
    assert v.fps == 0.0
    last = v.step()
    assert v.drain() is last and v.drain() is last
    assert v.fps > 0.0


def test_denoised_frame_fn(cornell):
    _, _, tscene, tcam = cornell
    s = RenderSettings(width=16, height=16, bounces=2, samples=1)
    b = tintersect.brute_backend(scene=tscene, device=CPU)
    plain = tviewer.make_default_frame_fn(tscene, s, backend=b)
    den = tviewer.make_default_frame_fn(tscene, s, backend=b, denoise=True)
    film = tfilm.Film.create(16, 16, device=CPU)
    f1, d1 = plain(film, tcam, 0)
    f2, d2 = den(film, tcam, 0)
    # The film stays unfiltered; only the display goes through the filter.
    assert torch.equal(f1.accum, f2.accum) and f2.frame_index == 1
    assert bool(d2.isfinite().all()) and not torch.equal(d1, d2)


def test_render_offline_resets_on_a_camera_path(cornell, tmp_path):
    _, _, tscene, tcam = cornell
    s = RenderSettings(width=8, height=8, bounces=1, samples=1)
    b = tintersect.brute_backend(scene=tscene, device=CPU)
    isect, occl = b.bind(b.arrays)
    moved = tcamera.orbit_camera(tcam, 0.1, 0.0, (0.0, 0.0, 0.0), 1.0)
    out = str(tmp_path / "offline.png")
    img = tviewer.render_offline(tscene, tcam, s, isect, occl, n_frames=4, out_path=out,
                                 camera_path=lambda i: moved if i == 2 else None)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and os.path.exists(out)


# ---------------------------------------------------------------------------
# The line protocol
# ---------------------------------------------------------------------------

COMMANDS = ["stats", "move 0 0 1", "stats", "stop", "stats", "look 0.4 0.05", "stats", "reset", "stats",
            "set bounces=1", "stats", "set bounces=1", "stats"]


def _session_lines(session, viewer):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for line in COMMANDS:
            assert session.handle(line)
            viewer.step()
        assert not session.handle("quit")
    return [json.loads(x) for x in out.getvalue().splitlines()]


def test_session_status_lines_match_reference(cornell):
    jscene, jcam, tscene, tcam = cornell
    s = RenderSettings(width=8, height=8, bounces=2, samples=1)
    js = JSettings(width=8, height=8, bounces=2, samples=1)
    jb = jintersect.brute_backend(scene=jscene)
    tb = tintersect.brute_backend(scene=tscene, device=CPU)

    def jrebuild(x):
        return jviewer.make_default_frame_fn(jscene, x, backend=jb)

    def trebuild(x):
        return tviewer.make_default_frame_fn(tscene, x, backend=tb)

    jv, tv = jviewer.Viewer(jrebuild(js), jcam, js), tviewer.Viewer(trebuild(s), tcam, s, device=CPU)
    ref = _session_lines(jviewer.InteractiveSession(jv, rebuild=jrebuild), jv)
    got = _session_lines(tviewer.InteractiveSession(tv, rebuild=trebuild), tv)
    assert len(got) == len(ref) == COMMANDS.count("stats")
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r) == ["fps", "frame", "spp"]
        assert isinstance(g["fps"], float) and g["fps"] >= 0.0
        assert (g["frame"], g["spp"]) == (r["frame"], r["spp"]), (got, ref)
    # The second "set bounces=1" changes nothing: the count runs on (a
    # step follows each command).
    assert got[-1]["frame"] == got[-2]["frame"] + 2 and tv.settings.bounces == 1


def test_run_reads_a_pipe():
    scene, cam, settings, isect = _tiny_setup()
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, settings, isect, None), cam, settings, device=CPU)
    session = tviewer.InteractiveSession(v)
    r, w = os.pipe()
    with os.fdopen(r) as stream, os.fdopen(w, "w") as writer:
        writer.write("stats\nmove 0 0 1\n")
        writer.flush()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            session.run(stream, max_frames=4)  # both commands, then 4 frames
            writer.write("stop\nstats\nquit\n")
            writer.flush()
            session.run(stream, max_frames=100)  # stops at quit before a frame
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [(x["frame"], x["spp"]) for x in lines] == [(0, 0), (4, 1), (4, 1), (4, 1)]
    assert v.controls.move_z == 0.0


def test_save_writes_a_png(cornell, tmp_path):
    from raytracer3_tpu_torch.utils import image

    _, _, tscene, tcam = cornell
    s = RenderSettings(width=8, height=8, bounces=1, samples=1)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(tscene, s, backend=tintersect.brute_backend(
        scene=tscene, device=CPU)), tcam, s, device=CPU)
    session = tviewer.InteractiveSession(v)
    v.step()
    v.step()
    path = str(tmp_path / "shot.png")
    assert session.handle(f"save {path}")
    img = image.read_png(path)
    assert img.shape[:2] == (8, 8)
    expected = (np.clip(v.drain().numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(np.round(img[..., :3] * 255.0).astype(np.uint8), expected)


def test_main_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tviewer.main(["--device", "cuda", "--width", "8", "--height", "8"])


def test_main_as_a_subprocess_on_the_cpu(tmp_path):
    # The module runs as a subprocess, answers ``stats`` and exits 0 on
    # ``quit``. The session answers every waiting command before its next
    # frame, so a fast exchange of polls can go by without a frame: the test
    # waits on the frame count it asserts (against a clock), never on a
    # number of polls.
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               RT3_ASSET_CACHE=str(tmp_path))
    cmd = [sys.executable, "-m", "raytracer3_tpu_torch.app.viewer", "--device", "cpu", "--width", "16",
           "--height", "16", "--bounces", "1", "--detail", "1"]
    p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         cwd=REPO, env=env)
    out, err = "", ""

    def stats():
        p.stdin.write("stats\n")
        p.stdin.flush()
        line = p.stdout.readline()
        assert line, f"the viewer closed its output (exit {p.poll()})"
        return json.loads(line)

    try:
        first = stats()
        deadline = time.monotonic() + 300.0
        now = first
        while now["frame"] < first["frame"] + 2:
            assert time.monotonic() < deadline, f"no two frames in 300 s: {first} then {now}"
            time.sleep(0.05)
            now = stats()
        out, err = p.communicate("quit\n", timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            _, err = p.communicate()
            print(err[-2000:], file=sys.stderr)
    assert p.returncode == 0, err[-2000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert sorted(last) == ["fps", "frame", "spp"]
    assert last["frame"] >= first["frame"] + 2 and last["spp"] == last["frame"] and last["fps"] > 0


@pytest.mark.gpu
def test_viewer_through_auto_backend_on_card():
    """A Viewer over World.trace_backend("auto") on the card (K1/K2) at
    64×64: 3 frames, then one move, which resets the film's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.scene import procedural

    dev = torch.device("cuda")
    w = tviewer.atrium_world(detail=1)
    scene = w.scene(device=dev)
    backend = w.trace_backend("auto", device=dev)
    s = tviewer.main_settings(64, 64, 4)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, s, backend=backend),
                       procedural.atrium_camera(aspect=1.0, device=dev), s, device=dev)
    before = dict(ttk.LAUNCHES)
    for _ in range(3):
        v.step()
    assert v.film.frame_index == 3
    v.controls.move_z = 1.0
    v.step()
    display = v.drain()
    assert v.film.frame_index == 1 and v.frame_index == 4
    assert bool(v.film.accum.isfinite().all()) and bool(display.isfinite().all())
    assert ttk.LAUNCHES["closest"] > before["closest"] and ttk.LAUNCHES["any"] > before["any"]
