"""The port's spans, pass markers and traced-ray counter
(``utils/profiling.span``, ``graph.FrameGraph``, ``app/viewer``).

- ``span`` is one shared null context when no profiler is on (no
  ``record_function`` is made) and a ``user_annotation`` range under one.
- Under a CPU profiler a ``Viewer`` step is one ``viewer:step`` with its
  ``graph:run`` inside it, and ``viewer:wait`` inside it once frames are in
  flight; ``drain``'s waits sit outside every step.
- ``Viewer.rays_traced()`` equals the sum of eager
  ``render_frame(..., return_stats=True)`` counts, integer for integer.
- The compiled step publishes its pass order; its markers do nothing on the
  CPU, and the marker's source runs under the host shim.
- ``Viewer.fps`` is a rate over the finish times (a scripted clock).

On the card (marked ``gpu``): a profiled replay holds 4 markers a frame in
order, each after its frame's ``graph:run`` began, and a captured frame with
its markers equals the eager one to the bit, its ray count included.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from raytracer3_tpu_torch.app import viewer as tviewer
from raytracer3_tpu_torch.graph import FrameGraph
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import wavefront
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.utils import profiling
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

CPU = torch.device("cpu")


def _cornell(width=8, height=8, bounces=1):
    scene = tanalytic.cornell_box(device=CPU)
    cam = tanalytic.default_camera(device=CPU)
    s = RenderSettings(width=width, height=height, bounces=bounces, samples=1)
    return scene, cam, s, tintersect.brute_backend(scene=scene, device=CPU)


def _annotations(prof, path):
    """The trace's ``user_annotation`` ranges as (name, start µs, end µs),
    in start order (the export the benchmark reads)."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in evs
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda x: x[1])


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ---------------------------------------------------------------------------
# span
# ---------------------------------------------------------------------------


def test_span_runs_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    a, b = profiling.span("viewer:step", 3), profiling.span("graph:run")
    assert a is b is profiling.pass_scope("pass:trace")
    with a:
        with b:  # the null context nests and is reused
            torch.ones(2).sum()


def test_span_is_a_user_annotation_under_a_profiler(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("viewer:step", 5):
            with profiling.pass_scope("pass:post"):
                torch.ones(8).cumsum(0)
    got = _annotations(prof, tmp_path / "t.json")
    assert [n for n, _, _ in got] == ["viewer:step", "pass:post"]
    assert _inside(got[0], got[1])
    assert profiling.span("x") is profiling.span("y")  # off again after the profile


# ---------------------------------------------------------------------------
# The viewer's spans on the CPU
# ---------------------------------------------------------------------------


def test_viewer_spans_nest_under_a_cpu_profiler(tmp_path):
    scene, cam, s, b = _cornell()
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, s, backend=b), cam, s, frames_in_flight=2, device=CPU)
    v.step()
    v.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            v.step()
        v.drain()
    got = _annotations(prof, tmp_path / "t.json")
    steps = [e for e in got if e[0] == "viewer:step"]
    runs = [e for e in got if e[0] == "graph:run"]
    waits = [e for e in got if e[0] == "viewer:wait"]
    assert len(steps) == len(runs) == 5
    for st, run in zip(steps, runs):
        assert _inside(st, run)
        assert [p for p in got if p[0].startswith("pass:") and _inside(run, p)] != []
    # 2 in flight: the first two steps only submit, the next three each wait
    # on one frame, and drain waits on the last two outside any step.
    in_step = [[w for w in waits if _inside(st, w)] for st in steps]
    assert [len(x) for x in in_step] == [0, 0, 1, 1, 1]
    outside = [w for w in waits if not any(_inside(st, w) for st in steps)]
    assert len(outside) == 2 and all(w[1] >= steps[-1][2] for w in outside)
    assert not any(_inside(run, w) for run in runs for w in waits)


# ---------------------------------------------------------------------------
# The traced-ray counter
# ---------------------------------------------------------------------------


def test_rays_traced_equals_eager_return_stats_counts():
    scene, cam, s, b = _cornell(width=16, height=16, bounces=2)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, s, backend=b), cam, s, frames_in_flight=2, device=CPU)
    cams = []
    for k in range(5):
        v.controls.move_z = 1.0 if k == 3 else 0.0  # a move resets the film, not the count
        v.step()
        cams.append(v.cam)  # the camera the step's frame was rendered with
    assert v.film.frame_index == 2
    isect, occl = b.bind(b.arrays)
    want = 0
    for k, c in enumerate(cams):
        _, n = wavefront.render_frame(scene, c, s, k, isect, occl, sort_rays=not b.self_sorting,
                                      return_stats=True, primary_fn=b.bind_primary(b.arrays))
        want += int(n)
    got = v.rays_traced()
    assert isinstance(got, int) and got == want
    assert want > 5 * 16 * 16  # primaries and more


def test_rays_traced_is_none_for_a_frame_fn_that_does_not_count():
    scene, cam, s, b = _cornell()
    frame_fn = tviewer.make_default_frame_fn(scene, s, backend=b)
    v = tviewer.Viewer(lambda film, c, i: frame_fn(film, c, i), cam, s, device=CPU)
    v.step()
    assert v.rays_traced() is None
    assert int(frame_fn.rays_traced()) > 0


# ---------------------------------------------------------------------------
# Pass order and markers on the CPU
# ---------------------------------------------------------------------------


def test_pass_order_is_published_and_markers_do_nothing_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("the kernels' library loaded on the CPU")

    monkeypatch.setattr(ttk, "load_kernels", refuse)
    assert ttk.pass_mark(0, CPU) is None and ttk.pass_mark(99, "cpu") is None
    scene, cam, s, b = _cornell()
    step, init = tpipelines.wavefront_pipeline(scene, s, backend=b, device=CPU)
    assert step.pass_order == ("trace", "blend", "post")
    display, state = step(init(), cam, 0)
    assert display.shape == (8, 8, 3) and state["rays_traced"].dtype == torch.int64
    pstep, _ = tpipelines.probe_gi_pipeline(scene, s, backend=b, device=CPU)
    assert pstep.pass_order == ("gbuffer", "sis", "probe_trace", "sh", "interpolate", "post")
    g = FrameGraph()
    g.image("a", (2,))
    g.image("b", (2,))
    g.add_pass("second", lambda r: {"b": r["a"] + 1.0}, reads=["a"], writes=["b"])
    g.add_pass("first", lambda r: {"a": torch.zeros(2)}, writes=["a"])
    for jit in (False, True):
        run = g.compile(output="b", jit=jit)
        assert run.pass_order == ("first", "second")
        assert torch.equal(run({})[0], torch.ones(2))


def test_pass_mark_source_runs_under_the_host_shim():
    lib = ttk.load_host_kernels()
    assert all(lib.rt3_pass_mark(i, None) == 0 for i in range(ttk.PASS_MARKS))
    assert lib.rt3_pass_mark(ttk.PASS_MARKS, None) != 0 and lib.rt3_pass_mark(-1, None) != 0


# ---------------------------------------------------------------------------
# Viewer.fps
# ---------------------------------------------------------------------------


def test_fps_is_a_rate_on_a_scripted_clock(monkeypatch):
    clock = iter(0.25 * k for k in range(1000))
    monkeypatch.setattr(tviewer, "_clock", lambda: next(clock))
    scene, cam, s, _ = _cornell()
    calls = []

    def frame_fn(film, c, i):
        calls.append(i)
        return film, torch.zeros((8, 8, 3))

    v = tviewer.Viewer(frame_fn, cam, s, frames_in_flight=3, device=CPU)
    for _ in range(3):
        v.step()
    assert v.fps == 0.0  # nothing finished: 3 in flight
    v.step()
    assert v.fps == 0.0  # one finished frame has no rate
    v.step()
    assert v.fps == pytest.approx(4.0)  # 1 / 0.25 s
    for _ in range(100):
        v.step()
    assert v.fps == pytest.approx(4.0) and len(v._finished) == tviewer.FPS_FRAMES
    v.drain()
    assert v.fps == pytest.approx(4.0)
    status = tviewer.InteractiveSession(v).status()
    assert status == {"frame": 105, "fps": 4.0, "spp": 0}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _atrium_on(dev, size=64):
    from raytracer3_tpu_torch.scene import procedural

    scene, tris = procedural.atrium_scene(detail=1, return_host=True, device=dev)
    cam = procedural.atrium_camera(aspect=1.0, device=dev)
    backend = ttk.packet_backend(host_tris=tris, device=dev)
    return scene, cam, backend, RenderSettings(width=size, height=size, bounces=2)


@pytest.mark.gpu
def test_replay_holds_four_markers_a_frame_in_order_on_card(tmp_path):
    dev = _card()
    scene, cam, backend, s = _atrium_on(dev)
    v = tviewer.Viewer(tviewer.make_default_frame_fn(scene, s, backend=backend), cam, s, frames_in_flight=2,
                       device=dev)
    for _ in range(2):  # the capture, then one replay
        v.step()
    v.drain()
    torch.cuda.synchronize(dev)
    n = 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            v.step()
        v.drain()
        torch.cuda.synchronize(dev)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    marks = sorted((float(e["ts"]), e["name"]) for e in evs
                   if e.get("cat") == "kernel" and "pass_mark_kernel<" in e["name"])
    order = [int(name.split("pass_mark_kernel<")[1].split(">")[0]) for _, name in marks]
    assert order == [0, 1, 2, 3] * n, order
    runs = sorted(float(e["ts"]) for e in evs if e.get("cat") == "user_annotation" and e["name"] == "graph:run")
    assert len(runs) == n
    for k in range(n):
        assert all(ts >= runs[k] for ts, _ in marks[4 * k:4 * k + 4])


@pytest.mark.gpu
def test_captured_frame_with_markers_equals_eager_on_card():
    dev = _card()
    scene, cam, backend, s = _atrium_on(dev)
    runs = []
    for jit in (False, True):
        step, init_state = tpipelines.wavefront_pipeline(scene, s, backend=backend, device=dev, jit=jit)
        state, shown = init_state(), []
        for i in range(4):
            c = cam if i < 2 else tcamera.orbit_camera(cam, 0.02 * i, 0.0, (0.0, 0.0, 0.5), 1 / 60)
            display, state = step(state, c, i)
            shown.append(display)
        torch.cuda.synchronize(dev)
        runs.append((shown, {k: t.clone() for k, t in state.items()}))
    (se, ste), (sc, stc) = runs
    assert sorted(ste) == sorted(stc) == ["film", "frame_count", "rays_traced"]
    for a, b in zip(se, sc):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for k in ste:
        assert torch.equal(ste[k], stc[k]), k
    assert int(stc["rays_traced"]) > 4 * 64 * 64
