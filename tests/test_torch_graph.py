"""The port's frame graph (``graph/graph.py``): the cases of
``tests/test_graph.py`` — ordering, the builder's assertions, temporal
ping-pong state, declared shapes and dtypes, bindings, and render passes
composed through it. The reference's jit-and-donate case has a counterpart
on a CUDA device, a CUDA graph (``compile(jit=True)``, the default; its
cases are in ``tests/test_torch_compiled.py``); on the CPU the compiled
step runs eagerly, returns fresh state tensors and leaves the caller's
state as it was, which ``test_step_returns_fresh_state`` holds. The Cornell
composition is held against the same passes run by hand (bit-equal)."""

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.graph import FrameGraph, GraphError
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


class TestValidation:
    def test_duplicate_pass_name(self):
        g = FrameGraph()
        g.image("a", (4,))
        g.add_pass("p", lambda r: {"a": torch.zeros(4)}, writes=["a"])
        with pytest.raises(GraphError, match="duplicate pass"):
            g.add_pass("p", lambda r: {}, writes=["a"])

    def test_duplicate_resource_edge(self):
        g = FrameGraph()
        g.image("a", (4,))
        with pytest.raises(GraphError, match="twice"):
            g.add_pass("p", lambda r: {}, reads=["a"], writes=["a"])

    def test_undeclared_resource(self):
        g = FrameGraph()
        with pytest.raises(GraphError, match="undeclared"):
            g.add_pass("p", lambda r: {}, writes=["ghost"])

    def test_read_from_nobody(self):
        g = FrameGraph()
        g.image("a", (4,))
        g.image("b", (4,))
        g.add_pass("p", lambda r: {"b": r["a"]}, reads=["a"], writes=["b"])
        with pytest.raises(GraphError, match="no pass writes"):
            g.compile(output="b")

    def test_two_writers_rejected(self):
        g = FrameGraph()
        g.image("a", (4,))
        g.add_pass("p1", lambda r: {"a": torch.zeros(4)}, writes=["a"])
        g.add_pass("p2", lambda r: {"a": torch.ones(4)}, writes=["a"])
        with pytest.raises(GraphError, match="written by both"):
            g.compile(output="a")

    def test_prev_requires_temporal(self):
        g = FrameGraph()
        g.image("a", (4,))
        with pytest.raises(GraphError, match="not temporal"):
            g.add_pass("p", lambda r: {"a": r["a@prev"]}, reads=["a@prev"], writes=["a"])

    def test_wrong_writes_returned(self):
        g = FrameGraph()
        g.image("a", (4,))
        g.add_pass("p", lambda r: {"zzz": torch.zeros(4)}, writes=["a"])
        step = g.compile(output="a")
        with pytest.raises(GraphError, match="declared"):
            step(g.init_state("cpu"))


class TestExecution:
    def test_order_follows_dependencies(self):
        g = FrameGraph()
        for name in "abc":
            g.image(name, (2,))
        trace = []
        g.add_pass("make_c", lambda r: (trace.append("c"), {"c": r["b"] + r["a"]})[1], reads=["a", "b"],
                   writes=["c"])
        g.add_pass("make_b", lambda r: (trace.append("b"), {"b": r["a"] * 2})[1], reads=["a"], writes=["b"])
        g.add_pass("make_a", lambda r: (trace.append("a"), {"a": torch.ones(2)})[1], writes=["a"])
        out, _ = g.compile(output="c")(g.init_state("cpu"))
        assert trace == ["a", "b", "c"]
        np.testing.assert_allclose(out.numpy(), [3.0, 3.0])

    def test_unreachable_passes_culled(self):
        g = FrameGraph()
        g.image("a", (2,))
        g.image("dead", (2,))
        trace = []
        g.add_pass("live", lambda r: (trace.append("live"), {"a": torch.ones(2)})[1], writes=["a"])
        g.add_pass("dead", lambda r: (trace.append("dead"), {"dead": torch.ones(2)})[1], writes=["dead"])
        g.compile(output="a")(g.init_state("cpu"))
        assert trace == ["live"]

    def test_temporal_ping_pong(self):
        # light = light@prev + 1 per frame: the PrevLight blend pattern.
        g = FrameGraph()
        g.temporal("light", (3,))
        g.add_pass("accum", lambda r: {"light": r["light@prev"] + 1.0}, reads=["light@prev"], writes=["light"])
        step = g.compile(output="light")
        state = g.init_state("cpu")
        assert state["light"].device.type == "cpu" and state["light"].dtype == torch.float32
        for _ in range(3):
            out, state = step(state)
        np.testing.assert_allclose(out.numpy(), [3.0, 3.0, 3.0])

    def test_step_returns_fresh_state(self):
        # On the CPU the compiled step (jit=True, donate_state=True) runs
        # eagerly: it hands back new state tensors and leaves the caller's
        # state untouched (the reference's jit-and-donate case is in
        # tests/test_torch_compiled.py).
        g = FrameGraph()
        g.temporal("film", (8, 8, 3))
        g.image("radiance", (8, 8, 3))

        def render(r, frame_index=0):
            return {"radiance": torch.full((8, 8, 3), 1.0 + frame_index)}

        def blend(r, frame_index=0):
            return {"film": r["film@prev"] * 0.5 + r["radiance"] * 0.5}

        g.add_pass("render", render, writes=["radiance"])
        g.add_pass("blend", blend, reads=["film@prev", "radiance"], writes=["film"])
        step = g.compile(output="film")
        state0 = g.init_state("cpu")
        out, state1 = step(state0, frame_index=0.0)
        out, state2 = step(state1, frame_index=1.0)
        assert state2 is not state1 and state2["film"] is not state1["film"]
        assert float(state0["film"].abs().max()) == 0.0
        np.testing.assert_allclose(state1["film"].numpy(), 0.5)
        np.testing.assert_allclose(out.numpy(), 0.25 * 1.0 + 0.5 * 2.0)


class TestEndToEndRender:
    def test_cornell_through_graph(self):
        # The port's renderer passes through the graph (primary rays →
        # G-buffer → radiance → blend), against the same calls by hand.
        from raytracer3_tpu_torch.ops import intersect, rng as rng_mod
        from raytracer3_tpu_torch.render import camera as camera_mod
        from raytracer3_tpu_torch.render import pathtracer
        from raytracer3_tpu_torch.scene import analytic
        from raytracer3_tpu_torch.utils.config import RenderSettings

        scene = analytic.cornell_box(device="cpu")
        cam = analytic.default_camera(device="cpu")
        isect = lambda o, d: intersect.intersect_bruteforce(o, d, *scene.tri_vertices())  # noqa: E731
        s = RenderSettings(width=8, height=8, bounces=2, samples=1, diffuse_only=True)

        def radiance(frame_index):
            pix = camera_mod.pixel_grid(8, 8, device="cpu")
            sampler = rng_mod.Sampler.from_pixels(pix, frame_index)
            uj, sampler = sampler.next2()
            o, d = camera_mod.primary_rays(cam, 8, 8, jitter=uj, pixel_xy=pix)
            gbuf = pathtracer.trace_gbuffer(scene, isect, o, d)
            return pathtracer.trace_radiance(scene, isect, o, d, gbuf, sampler, s)

        g = FrameGraph()
        g.image("radiance", (64, 3))
        g.temporal("film", (64, 3))

        def blend_pass(r, frame_index):
            t = 1.0 / (frame_index + 1.0)
            return {"film": r["film@prev"] + (r["radiance"] - r["film@prev"]) * t}

        g.add_pass("pt", lambda r, frame_index: {"radiance": radiance(frame_index)}, writes=["radiance"])
        g.add_pass("blend", blend_pass, reads=["film@prev", "radiance"], writes=["film"])
        step = g.compile(output="film")
        state = g.init_state("cpu")
        film = torch.zeros(64, 3)
        for i in range(3):
            out, state = step(state, frame_index=i)
            film = film + (radiance(i) - film) * (1.0 / (i + 1.0))
        assert bool(out.isfinite().all()) and float(out.max()) > 0
        assert torch.equal(out, film)


class TestDeclarationValidation:
    """The step checks written shapes and dtypes against the declarations
    and names the pass."""

    def test_shape_mismatch_raises(self):
        g = FrameGraph()
        g.image("img", (4, 4))
        g.add_pass("bad", lambda r: {"img": torch.zeros((2, 2))}, writes=["img"])
        with pytest.raises(GraphError, match="bad.*img.*\\(2, 2\\)"):
            g.compile(output="img")({})

    def test_dtype_mismatch_raises(self):
        g = FrameGraph()
        g.image("img", (4, 4), dtype=torch.int64)
        g.add_pass("bad", lambda r: {"img": torch.zeros((4, 4))}, writes=["img"])
        with pytest.raises(GraphError, match="bad.*dtype"):
            g.compile(output="img")({})

    def test_bindings_forwarded_to_passes_that_declare_them(self):
        g = FrameGraph()
        g.image("img", (2, 2))
        g.image("other", (2, 2))

        def p(r, bindings):
            return {"img": torch.full((2, 2), bindings["k"])}

        seen = []

        def q(r, **kw):
            seen.append(sorted(kw))
            return {"other": r["img"] + 1.0}

        g.add_pass("p", p, writes=["img"])
        g.add_pass("q", q, reads=["img"], writes=["other"])
        out, _ = g.compile(output="other", bindings={"k": 3.0})({})
        assert float(out[0, 0]) == 4.0 and seen == [[]]


def test_passes_are_named_in_a_profile():
    # Each pass body runs inside record_function("pass:<name>").
    g = FrameGraph()
    g.image("a", (4,))
    g.image("b", (4,))
    g.add_pass("first", lambda r: {"a": torch.ones(4)}, writes=["a"])
    g.add_pass("second", lambda r: {"b": r["a"] * 2.0}, reads=["a"], writes=["b"])
    step = g.compile(output="b")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step({})
    names = {e.key for e in prof.key_averages()}
    assert {"pass:first", "pass:second"} <= names
