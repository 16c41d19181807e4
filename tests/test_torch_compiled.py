"""The compiled step (``FrameGraph.compile(jit=True, donate_state=...)``,
``graph.capture_step``) and the frame path it captures.

On the CPU a compiled step runs eagerly, so these cases hold what capture
needs of the code it runs: the reference's jit-and-donate case gives the
same film through both packages; each of the four pipelines gives the same
film and display, bit for bit, with the frame index as a 0-d int64 tensor
(what a compiled step passes) as with a Python int; and no pass reads the
device from the host (``HostReadGuard``, the CPU's stand-in for the card's
``torch.cuda.set_sync_debug_mode("error")``). The ``gpu`` cases capture on
the card: the wavefront pipeline through K1/K2 against its eager frames,
the same over the LBVH and cluster-BVH backends (kernels A-D), and the
wide BVH's walk, which loops on a host-read flag and must raise.
"""

import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from raytracer3_tpu.graph import FrameGraph as JFrameGraph
from raytracer3_tpu_torch.graph import FrameGraph
from raytracer3_tpu_torch.graph import graph as tgraph
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import rng as trng
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


class HostReadGuard(TorchFunctionMode):
    """Records every call that reads a tensor's value on the host or waits
    on the device for a data-dependent shape: ``item``, ``__bool__``,
    ``__int__``, ``__float__``, ``__index__``, ``tolist``, ``nonzero``,
    ``argwhere``, ``masked_select``, ``unique``, a one-argument
    ``torch.where``, ``repeat_interleave`` with tensor repeats and no
    ``output_size``, ``cpu``, ``numpy``, ``to`` a CPU device, and indexing
    or index assignment with a boolean tensor or a 0-d integer tensor (read
    as a Python int). Each of these syncs a CUDA stream, which a CUDA graph
    cannot capture."""

    WATCHED = {
        torch.Tensor.item: "item", torch.Tensor.__bool__: "__bool__", torch.Tensor.__int__: "__int__",
        torch.Tensor.__float__: "__float__", torch.Tensor.__index__: "__index__", torch.Tensor.tolist: "tolist",
        torch.Tensor.nonzero: "nonzero", torch.nonzero: "nonzero", torch.Tensor.argwhere: "argwhere",
        torch.argwhere: "argwhere", torch.masked_select: "masked_select",
        torch.Tensor.masked_select: "masked_select", torch.unique: "unique", torch.Tensor.unique: "unique",
        torch.unique_consecutive: "unique_consecutive", torch.Tensor.cpu: "cpu", torch.Tensor.numpy: "numpy",
    }

    def __init__(self):
        super().__init__()
        self.found = []

    def _flag(self, func, args, kwargs):
        name = self.WATCHED.get(func)
        if name is not None:
            return name
        if func is torch.where and len(args) + len(kwargs) == 1:
            return "torch.where(condition)"
        if func in (torch.repeat_interleave, torch.Tensor.repeat_interleave):
            reps = args[1] if len(args) > 1 else kwargs.get("repeats")
            if isinstance(reps, torch.Tensor) and reps.numel() > 1 and kwargs.get("output_size") is None:
                return "repeat_interleave"
        if func is torch.Tensor.to and any(
                (isinstance(a, torch.device) and a.type == "cpu") or a == "cpu" for a in args[1:]):
            return "to(cpu)"
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            key = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(k, torch.Tensor) and k.dtype == torch.bool for k in key):
                return func.__name__ + "[bool mask]"
            # A 0-d integer tensor indexes as a Python int: its value is read.
            if any(isinstance(k, torch.Tensor) and k.ndim == 0 and not k.is_floating_point() for k in key):
                return func.__name__ + "[0-d index]"
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = self._flag(func, args, kwargs)
        if name is not None:
            where = [f"{f.filename.split('raytracer3_tpu_torch/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack() if "raytracer3_tpu_torch" in f.filename]
            self.found.append(f"{name} at {where[-1] if where else '?'}")
        return func(*args, **kwargs)


def test_guard_sees_host_reads():
    x = torch.arange(4.0)
    with HostReadGuard() as g:
        float(x[1])
        bool(x.sum() > 0)
        x[x > 1]
        torch.nonzero(x)
        x.tolist()
        y = x.clone()
        y[x > 2] = 0.0
        x[..., torch.tensor(2)]
        torch.where(x > 1, x, 0.0)  # three arguments: no read
        x.to(torch.int64)
        x.index_select(0, torch.tensor([2]))  # a device-side select: no read
    names = [f.split(" at ")[0] for f in g.found]
    assert names == ["__float__", "__bool__", "__getitem__[bool mask]", "nonzero", "tolist",
                     "__setitem__[bool mask]", "__getitem__[0-d index]"], g.found


def test_jit_compiles_and_donates_like_the_reference():
    """``tests/test_graph.py::test_jit_compiles_and_donates`` through both
    packages, ``jit=True`` (the default) on both sides."""
    films = []
    for G, full, asarray, init in (
        (JFrameGraph, jnp.full, jnp.asarray, lambda g: g.init_state()),
        (FrameGraph, torch.full, lambda v: torch.tensor(v, dtype=torch.float32), lambda g: g.init_state("cpu")),
    ):
        g = G()
        g.temporal("film", (8, 8, 3))
        g.image("radiance", (8, 8, 3))

        def render(r, frame_index=0, full=full):
            return {"radiance": full((8, 8, 3), 1.0 + frame_index)}

        def blend(r, frame_index=0):
            return {"film": r["film@prev"] * 0.5 + r["radiance"] * 0.5}

        g.add_pass("render", render, writes=["radiance"])
        g.add_pass("blend", blend, reads=["film@prev", "radiance"], writes=["film"])
        step = g.compile(output="film")
        state = init(g)
        out, state = step(state, frame_index=asarray(0.0))
        out, state = step(state, frame_index=asarray(1.0))
        films.append(np.asarray(out))
    np.testing.assert_allclose(films[1], 0.25 * 1.0 + 0.5 * 2.0)
    np.testing.assert_array_equal(films[0], films[1])


def _accum_graph():
    g = FrameGraph()
    g.temporal("film", (4, 3))
    g.image("radiance", (4, 3))
    g.add_pass("render", lambda r, frame_index: {"radiance": torch.full((4, 3), 1.0) * (frame_index + 1.0)},
               writes=["radiance"])
    g.add_pass("blend", lambda r, frame_index: {"film": r["film@prev"] + r["radiance"]},
               reads=["film@prev", "radiance"], writes=["film"])
    return g


@pytest.mark.parametrize("donate_state", [False, True])
def test_compiled_step_equals_the_eager_step_and_keeps_the_callers_state(donate_state):
    """``jit=False`` is the eager step; ``jit=True`` on the CPU runs that
    step, and ``donate_state=False`` leaves the caller's state as it was
    (on the CPU so does ``True``: only a CUDA graph reuses the buffers)."""
    g = _accum_graph()
    eager = g.compile(output="film", jit=False)
    compiled = g.compile(output="film", donate_state=donate_state)
    s_e = s_c = g.init_state("cpu")
    for i in range(3):
        kept = s_c["film"].clone()
        before = s_c
        out_e, s_e = eager(s_e, frame_index=i)
        out_c, s_c = compiled(s_c, frame_index=torch.tensor(i))
        assert torch.equal(before["film"], kept)
        assert torch.equal(out_e, out_c) and torch.equal(s_e["film"], s_c["film"])
    np.testing.assert_allclose(out_c.numpy(), 6.0)


def test_capture_step_runs_eagerly_without_a_cuda_tensor():
    calls = []

    def fn(state, x, k=2):
        calls.append(k)
        return x * k, {"acc": state["acc"] + x}

    step = tgraph.capture_step(fn)
    out, st = step({"acc": torch.zeros(3)}, x=torch.ones(3), k=5)
    assert calls == [5] and torch.equal(out, torch.full((3,), 5.0)) and torch.equal(st["acc"], torch.ones(3))


def test_signature_of_graph_inputs():
    sig = tgraph._signature_of
    assert sig(torch.zeros(2, 3)) == ((2, 3), torch.float32, torch.device("cpu"))
    assert sig(3) is int and sig(True) is bool and sig(0.5) is float
    assert sig("post") == ("value", "post") and sig(None) == ("value", None)
    assert tgraph._static_leaf(7, torch.device("cpu")).dtype == torch.int64
    assert tgraph._static_leaf(True, torch.device("cpu")).dtype == torch.bool
    assert tgraph._static_leaf(0.25, torch.device("cpu")).dtype == torch.float32


def test_frame_word_is_the_same_for_ints_and_tensors():
    for v in (0, 1, 77, 2**32 - 1, 2**32 + 5, 3 * 2**32 + 9):
        assert int(trng.frame_word(torch.tensor(v, dtype=torch.int64))) == trng.frame_word(v) == v & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The four pipelines with the frame index as a tensor, and the host reads
# ---------------------------------------------------------------------------

W = H = 32
PIPELINES = {
    "wavefront": (tpipelines.wavefront_pipeline, dict(bounces=2), {}),
    "wavefront_denoised_bluenoise": (tpipelines.wavefront_pipeline, dict(bounces=2), {"denoise": True,
                                                                                     "blue_noise": True}),
    "wavefront_batched_diet_fused": (tpipelines.wavefront_pipeline,
                                     dict(bounces=2, samples=2, sample_batch=True, lane_diet=True,
                                          fuse_shadow=True), {}),
    "reference": (tpipelines.reference_pipeline, dict(bounces=2, samples=2), {}),
    "probe_gi": (tpipelines.probe_gi_pipeline, dict(bounces=1, probe_spacing=8, probe_res=4), {}),
    "probe_gi_splits2_bounce2": (tpipelines.probe_gi_pipeline,
                                 dict(bounces=1, probe_spacing=8, probe_res=4, probe_texel_splits=2,
                                      probe_bounces=2, probe_bounce2_splits=2), {}),
    "hybrid_gi": (tpipelines.hybrid_gi_pipeline, dict(bounces=1, probe_spacing=8, probe_res=4), {}),
    "hybrid_gi_splits2": (tpipelines.hybrid_gi_pipeline,
                          dict(bounces=1, probe_spacing=8, probe_res=4, probe_texel_splits=2), {}),
}


@pytest.fixture(scope="module")
def cornell():
    scene = tanalytic.cornell_box(device="cpu")
    return scene, tanalytic.default_camera(device="cpu"), tintersect.brute_backend(scene=scene, device="cpu")


def _pipeline(name, cornell):
    make, skw, kw = PIPELINES[name]
    scene, cam, backend = cornell
    kw = dict(kw)
    if kw.pop("blue_noise", False):
        kw["blue_noise"] = torch.as_tensor(trng.generate_blue_noise(16))
    s = RenderSettings(width=W, height=H, diffuse_only=False, **skw)
    step, init_state = make(scene, s, backend=backend, device="cpu", **kw)
    return step, init_state, cam


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_tensor_frame_index_is_bit_equal_and_reads_nothing_on_the_host(name, cornell):
    """3 frames with ``frame_index`` a Python int and a 0-d int64 tensor:
    films (every temporal resource) and displays equal to the bit; frames 2
    and 3 of the tensor run under ``HostReadGuard``, which finds nothing.
    Frame 0 is the probe pipelines' camera cut (blend factor 1, on the
    device where the index is a tensor); texel splits 2 select their class
    ``frame mod 2`` on the device; the hybrid seeds its direct light with
    ``frame + 77777``."""
    step, init_state, cam = _pipeline(name, cornell)
    runs = []
    for as_tensor in (False, True):
        state, shown, found = init_state(), [], []
        for i in range(3):
            fi = torch.tensor(i, dtype=torch.int64) if as_tensor else i
            if as_tensor and i >= 1:
                with HostReadGuard() as guard:
                    display, state = step(state, cam, fi)
                found += guard.found
            else:
                display, state = step(state, cam, fi)
            shown.append(display)
        assert not found, f"{name}: host reads in frames 2-3: {sorted(set(found))}"
        runs.append((shown, state))
    (shown_i, state_i), (shown_t, state_t) = runs
    assert all(bool(d.isfinite().all()) for d in shown_i) and float(shown_i[-1].mean()) > 0
    for a, b in zip(shown_i, shown_t):
        assert torch.equal(_bits(a), _bits(b))
    assert set(state_i) == set(state_t)
    for k in state_i:
        assert torch.equal(_bits(state_i[k]), _bits(state_t[k])), k


def test_probe_cut_and_class_select_follow_the_tensor_index(cornell):
    """Texel splits 2 trace class ``frame mod 2``: frames 1 and 2 of the
    tensor run write other texels, as the int run does; a frame index of
    2**32 wraps to the cut (uint32), as the reference's ``jnp.uint32``."""
    step, init_state, cam = _pipeline("probe_gi_splits2_bounce2", cornell)
    outs = {}
    for fi in (0, 2**32, torch.tensor(2**32, dtype=torch.int64)):
        d, st = step(init_state(), cam, fi)
        outs[str(fi)] = (d, st["probe_atlas"])
    ref = outs["0"]
    for k in outs:
        assert torch.equal(outs[k][0], ref[0]) and torch.equal(outs[k][1], ref[1]), k


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_wavefront_pipeline_captured_equals_eager_on_card():
    """The wavefront pipeline through K1/K2 (atrium detail 1, 64×64, 2
    bounces, blue noise): 4 frames of the compiled step (one CUDA graph
    after the first) against 4 eager frames from the same state, films and
    displays equal to the bit and the same launches per frame."""
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.scene import procedural

    dev = _card()
    scene, tris = procedural.atrium_scene(detail=1, return_host=True, device=dev)
    cam = procedural.atrium_camera(aspect=1.0, device=dev)
    backend = ttk.packet_backend(host_tris=tris, device=dev)
    s = RenderSettings(width=64, height=64, bounces=2)
    bn = torch.as_tensor(trng.generate_blue_noise(64), device=dev)
    runs = []
    for jit in (False, True):
        step, init_state = tpipelines.wavefront_pipeline(scene, s, backend=backend, blue_noise=bn, device=dev,
                                                         jit=jit)
        state, shown = init_state(), []
        for k in ttk.LAUNCHES:
            ttk.LAUNCHES[k] = 0
        for i in range(4):
            display, state = step(state, cam, i)
            shown.append(display)
        torch.cuda.synchronize()
        runs.append((shown, state["film"].clone(), {k: v for k, v in ttk.LAUNCHES.items() if v}))
    (se, fe, le), (sc, fc, lc) = runs
    assert le == lc and le.get("closest", 0) == 4 * 2 and le.get("any", 0) == 4 * 2
    assert torch.equal(_bits(fe), _bits(fc))
    assert len({d.data_ptr() for d in sc}) == 4  # each display a tensor of its own
    for a, b in zip(se, sc):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_oracle_backend_captured_equals_eager_on_card(kind):
    """``World.backend("bvh")`` (kernels A-C) and ``World.backend("cluster")``
    (kernel D) read nothing back on the card: the compiled wavefront step
    over them captures (its warm-up under
    ``torch.cuda.set_sync_debug_mode("error")``, after an eager frame 0),
    and 3 captured frames
    are bit-equal to 3 eager frames from the same state, with the same
    launches a frame (atrium detail 1, 32×32, 2 bounces)."""
    from raytracer3_tpu_torch.app import viewer as tviewer
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.scene import procedural

    dev = _card()
    w = tviewer.atrium_world(detail=1)
    scene = w.scene(device=dev)
    isect, occl = w.backend(kind, device=dev)
    cam = procedural.atrium_camera(aspect=1.0, device=dev)
    s = RenderSettings(width=32, height=32, bounces=2)
    step_e, init_state = tpipelines.wavefront_pipeline(scene, s, isect, occl, device=dev, jit=False)
    step_c, _ = tpipelines.wavefront_pipeline(scene, s, isect, occl, device=dev)
    state0 = init_state()
    d0_e, s_e = step_e(state0, cam, 0)  # fills the caches a frame reads (its pixel order)
    torch.cuda.set_sync_debug_mode("error")
    try:
        d0_c, s_c = step_c(state0, cam, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(_bits(d0_c), _bits(d0_e))
    runs = []
    for step, st in ((step_c, s_c), (step_e, s_e)):
        for k in ttk.LAUNCHES:
            ttk.LAUNCHES[k] = 0
        shown = []
        for i in range(1, 4):
            display, st = step(st, cam, i)
            shown.append(display)
        torch.cuda.synchronize()
        runs.append((shown, st["film"].clone(), {k: v for k, v in ttk.LAUNCHES.items() if v}))
    (sc, fc, lc), (se, fe, le) = runs
    walk = "lbvh" if kind == "bvh" else "cluster"
    # Each frame also shades through the shade kernel: passes A and B of
    # bounce 0, the deferred pass of the tail; and bounce 0's sorted shadow
    # and next-hit launches each take the sorted IO's three passes.
    shade = {"shade_split_a": 3, "shade_split_b": 3, "shade_deferred": 3}
    sorted_io = {k: 3 * 2 for k in ttk.SORTED_IO_KEYS}
    assert lc == le == {f"{walk}_closest": 3 * 2, f"{walk}_any": 3 * 2, **shade, **sorted_io}
    assert torch.equal(_bits(fc), _bits(fe))
    for a, b in zip(sc, se):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_wide_backend_raises_under_jit_on_card():
    """The wide BVH's walk (``ops/wide_bvh.make_wide_backend``, kernel E)
    reads nothing back on the card: the compiled wavefront step over it
    captures (its warm-up under ``torch.cuda.set_sync_debug_mode("error")``,
    after an eager frame 0), and 3 captured frames are bit-equal to 3 eager
    frames from the same state, with the same launches a frame (atrium
    detail 1, 32×32, 2 bounces). (Before kernel E the step raised; the
    name is kept.)"""
    from raytracer3_tpu_torch.app import viewer as tviewer
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.ops import wide_bvh as twide
    from raytracer3_tpu_torch.scene import procedural

    dev = _card()
    scene = tviewer.atrium_world(detail=1).scene(device=dev)
    isect, occl, _ = twide.make_wide_backend(scene)
    cam = procedural.atrium_camera(aspect=1.0, device=dev)
    s = RenderSettings(width=32, height=32, bounces=2)
    step_e, init_state = tpipelines.wavefront_pipeline(scene, s, isect, occl, device=dev, jit=False)
    step_c, _ = tpipelines.wavefront_pipeline(scene, s, isect, occl, device=dev)
    state0 = init_state()
    d0_e, s_e = step_e(state0, cam, 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        d0_c, s_c = step_c(state0, cam, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(_bits(d0_c), _bits(d0_e))
    runs = []
    for step, st in ((step_c, s_c), (step_e, s_e)):
        for k in ttk.LAUNCHES:
            ttk.LAUNCHES[k] = 0
        shown = []
        for i in range(1, 4):
            display, st = step(st, cam, i)
            shown.append(display)
        torch.cuda.synchronize()
        runs.append((shown, st["film"].clone(), {k: v for k, v in ttk.LAUNCHES.items() if v}))
    (sc, fc, lc), (se, fe, le) = runs
    shade = {"shade_split_a": 3, "shade_split_b": 3, "shade_deferred": 3}  # the shade kernel's passes
    sorted_io = {k: 3 * 2 for k in ttk.SORTED_IO_KEYS}  # bounce 0's two sorted launches
    assert lc == le == {"wide_closest": 3 * 2, "wide_any": 3 * 2, **shade, **sorted_io}
    assert torch.equal(_bits(fc), _bits(fe))
    for a, b in zip(sc, se):
        assert torch.equal(_bits(a), _bits(b))
