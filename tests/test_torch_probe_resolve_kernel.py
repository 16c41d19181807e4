"""The probe resolve's passes (``csrc/probe_resolve.cu``) against their plain
PyTorch versions in ``render/probes.py``.

On the CPU the kernels' source is built with g++ under
``csrc/host_shim.h`` (``probe_resolve_kernel.load_host_kernels()``: each
thread run in turn) and driven through ``sis_packed``, ``project_sh`` and
``interpolate_packed`` with the probe library swapped for that build
(``probes._probe_resolve``): the glue the CUDA path takes. Each case is
held against the plain versions on the same seeded G-buffer:

- SIS, to the bit: the normals of every pixel, the direction indices and
  mip bits, at spacings 16 and 12 (and 8 with 4 x 4 texels), on frames of
  whole cells and of other sizes; two tiles are flat, so that half their
  directions tie at a pdf of 0 and the stable rank by index decides.
- Interpolation: frames of whole cells and of other sizes, probe and
  hybrid (no emission), with sky pixels and a cell that no probe reaches.
- SH, with and without ``probe_sh_fill``, with a probe of no texel written
  and one of every texel written.
- The plain versions sum the SH coefficients and the irradiance through
  PyTorch's reductions (an ``einsum``, a ``sum`` over 9 terms) in the
  library's own order; the kernels sum by halving. So those two are held
  to the plain formula evaluated exactly (the plain pass on float64 texels
  or coefficients, from the same float32 inputs): each value within
  ``prk.sh_bound(R)`` or ``prk.LIGHT_BOUND`` of the sum of its terms'
  magnitudes (the plain pass in float64 on the inputs' and the basis's
  absolute values), the worst case of the kernels' own roundings (9.54e-7
  and 7.75e-7). The interpolation's weights are written out in one order
  in both, so the red and black pixels are the same.
- Frames 0-2 of ``probe_gi_pipeline`` and ``hybrid_gi_pipeline`` on the
  Cornell box: one pass of each a frame, the atlas and the traced rays to
  the bit, each sh and interpolate pass held to its exact evaluation on
  the inputs the pipeline gave it, and the displays within
  ``DISPLAY_TOL`` of the plain passes'.

Also here: the wrapper's refusals, a CPU call that takes the plain path and
counts no launch, and, marked ``gpu``, the CUDA build against the plain
path run on the card and the benchmark's ``sponza1080probe`` frame with one
launch of each pass a frame.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.ops import mathx, packing
from raytracer3_tpu_torch.ops import sh as tsh
from raytracer3_tpu_torch.ops import probe_resolve_kernel as prk
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import probes as tprobes
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

BG = mathx.BACKGROUND_DEPTH
DISPLAY_TOL = 1e-5  # |kernel - plain| of a display pixel in [0, 1] (AgX of light within the bounds above)
# (width, height, spacing, texels a side): frames of whole cells and not.
SIZES = {
    "sp16_cells": (48, 32, 16, 8),
    "sp16_generic": (56, 40, 16, 8),
    "sp12_cells": (36, 24, 12, 8),
    "sp12_generic": (44, 30, 12, 8),
    "sp8_r4_generic": (36, 20, 8, 4),
}


@pytest.fixture(scope="module")
def host_lib():
    return prk.load_host_kernels()


def _settings(w, h, sp, r, **kw):
    return RenderSettings(width=w, height=h, probe_spacing=sp, probe_res=r, **kw)


def _gbuffer(w, h, sp, seed=5, device="cpu", smooth=False):
    """A seeded packed G-buffer (words [h, w, 4], depth [h, w]): random unit
    normals (``smooth``: near +z) but on two flat tiles (every normal up,
    every normal down), albedo, emission (zero on a third of the pixels, up
    to 40 elsewhere); depths in [0.5, 30] (``smooth``: [4, 6]) with sky
    pixels."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32) + (np.float32([0.0, 0.0, 2.0]) if smooth else 0.0)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:sp, :sp] = (0.0, 1.0, 0.0)
    n[:sp, sp:2 * sp] = (0.0, -1.0, 0.0)
    albedo = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    emis = rng.uniform(0.0, 40.0, (h, w, 3)).astype(np.float32) * (rng.uniform(size=(h, w, 1)) < 0.67)
    words = torch.stack([
        packing.pack_color_888(torch.from_numpy(albedo)),
        packing.pack_normal_11_10_11(torch.from_numpy(n)),
        torch.from_numpy(rng.integers(0, 2**32, (h, w), dtype=np.int64)),
        packing.pack_rgb9e5(torch.from_numpy(emis)),
    ], dim=-1)
    depth = rng.uniform(*((4.0, 6.0) if smooth else (0.5, 30.0)), (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = BG
    return words.to(device), torch.from_numpy(depth).to(device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    assert torch.equal(_bits(got), _bits(want)), f"{what}: {int((_bits(got) != _bits(want)).sum())} values differ"


def _assert_within(got, exact, magnitude, bound: float, what: str) -> None:
    """Each value of ``got`` within ``bound`` of ``magnitude`` of ``exact``."""
    assert got.shape == exact.shape and got.dtype == torch.float32, (what, got.shape, exact.shape, got.dtype)
    err = (got.double() - exact).abs()
    off = err > bound * magnitude
    assert not off.any(), (f"{what}: {int(off.sum())} values beyond {bound:.3g} of their terms' magnitude (worst "
                           f"{float((err / magnitude.clamp_min(1e-300)).max()):.3g})")


def _sh_exact(state, s, monkeypatch):
    """(The plain projection of ``state``'s float32 texels in float64, each
    coefficient's terms' magnitude: the same on |texels| with |basis|)."""
    evaluate = tsh.sh3_evaluate
    exact = tprobes.project_sh_plain(state._replace(atlas=state.atlas.double()), s).sh_coeffs
    with monkeypatch.context() as mp:
        mp.setattr(tsh, "sh3_evaluate", lambda d: evaluate(d).abs())
        magnitude = tprobes.project_sh_plain(state._replace(atlas=state.atlas.double().abs()), s).sh_coeffs
    return exact, magnitude


def _light_exact(depth, normal, data, coeffs, s, emission, monkeypatch):
    """(The plain interpolation from ``coeffs`` in float64 (the weights stay
    float32), each value's terms' magnitude: the same from |coeffs| with
    the lobe's |basis|)."""
    transform = tsh.sh3_transform_cos_lobe
    exact = tprobes.interpolate_packed_plain(depth, normal, data, coeffs.double(), s, emission)
    with monkeypatch.context() as mp:
        mp.setattr(tsh, "sh3_transform_cos_lobe", lambda n: transform(n).abs())
        magnitude = tprobes.interpolate_packed_plain(depth, normal, data, coeffs.double().abs(), s, emission)
    return exact, magnitude


@contextlib.contextmanager
def _resolve_with(lib):
    """Every probe pass takes ``lib`` (None: the plain versions)."""
    saved = tprobes._probe_resolve
    tprobes._probe_resolve = lambda device: lib
    try:
        yield
    finally:
        tprobes._probe_resolve = saved


@pytest.mark.parametrize("size", list(SIZES))
def test_sis_matches_plain(size, host_lib):
    w, h, sp, r = SIZES[size]
    s = _settings(w, h, sp, r)
    data, _ = _gbuffer(w, h, sp)
    want = tprobes.sis_packed_plain(data, s)
    with _resolve_with(host_lib):
        got = tprobes.sis_packed(data, s)
    for name, g, wt in zip(("gbuf_normal", "probe_dir", "probe_mip"), got, want):
        _assert_same(g, wt, f"{size}: {name}")
    # The flat tiles tie at a pdf of 0 on about half their directions, and
    # every probe culls its lowest third.
    pdf = tprobes.sis_pdf(want[0], s)
    assert int((pdf[0, :2] == 0.0).sum(dim=-1).min()) >= r * r // 3
    assert (want[2].sum(dim=-1) == int(r * r / 3.0)).all()


@pytest.mark.parametrize("fill", [True, False], ids=["fill", "no_fill"])
def test_sh_matches_plain(fill, host_lib, monkeypatch):
    s = _settings(48, 32, 16, 8, probe_sh_fill=fill)
    px, py = s.probe_grid
    r = s.probe_res
    rng = np.random.default_rng(7)
    atlas = torch.from_numpy(rng.uniform(0.0, 3.0, (py * r, px * r, 3)).astype(np.float32))
    depth = rng.uniform(0.5, 9.0, (py * r, px * r)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    depth[:r, :r] = 0.0  # probe (0, 0): no texel written
    depth[r:2 * r, 2 * r:3 * r] = 4.0  # probe (1, 2): every texel written
    state = tprobes.ProbeState(atlas, torch.from_numpy(depth), None)
    with _resolve_with(host_lib):
        got = tprobes.project_sh(state, s).sh_coeffs
    _assert_within(got, *_sh_exact(state, s, monkeypatch), prk.sh_bound(r), "sh_coeffs")
    assert got.shape == (py, px, 3, 9) and float(got.abs().max()) > 0.0


@pytest.mark.parametrize("emission", [True, False], ids=["probe", "hybrid"])
@pytest.mark.parametrize("size", ["sp16_cells", "sp16_generic", "sp12_generic"])
def test_interpolate_matches_plain(size, emission, host_lib, monkeypatch):
    w, h, sp, r = SIZES[size]
    s = _settings(w, h, sp, r)
    px, py = s.probe_grid
    data, depth = _gbuffer(w, h, sp, seed=9, smooth=True)
    normal = tprobes.sis_packed_plain(data, s)[0]
    # The anchors around cell (0, 0) on the sky: no probe reaches its
    # pixels but for the sky's own.
    for y, x in ((0, 0), (0, sp), (sp, 0), (sp, sp)):
        depth[y, x] = BG
    depth[1:sp, 1:sp] = 2.5
    sh = torch.from_numpy(np.random.default_rng(11).normal(0.3, 0.2, (py, px, 3, 9)).astype(np.float32))
    with _resolve_with(host_lib):
        got = tprobes.interpolate_packed(depth, normal, data, sh, s, emission)
    _assert_within(got, *_light_exact(depth, normal, data, sh, s, emission, monkeypatch), prk.LIGHT_BOUND,
                   f"{size}: light")
    want = tprobes.interpolate_packed_plain(depth, normal, data, sh, s, emission)
    red = torch.tensor([1.0, 0.0, 0.0])
    assert torch.equal((got == red).all(dim=-1), (want == red).all(dim=-1))
    assert (got[1:sp, 1:sp] == red).all()
    assert (got[depth >= BG] == 0.0).all()
    lit = (depth < BG) & ~(got == red).all(dim=-1)
    assert int(lit.sum()) > h * w // 2 and float(got[lit].max()) > 0.0


def test_wrapper_refuses_other_devices_dtypes_and_sizes(host_lib):
    w, h, sp, r = SIZES["sp16_cells"]
    data, depth = _gbuffer(w, h, sp)
    grid = (w // sp, h // sp)
    normal = tprobes.sis_packed_plain(data, _settings(w, h, sp, r))[0]
    sh = torch.zeros((grid[1], grid[0], 3, 9))
    cuda_build = type("CudaBuild", (), {"rt3_device_type": "cuda"})()
    with pytest.raises(ValueError, match="cannot take tensors"):
        prk.sis(cuda_build, data, grid, sp, r, 21)
    with pytest.raises(ValueError, match="cannot take tensors"):
        prk.interpolate(cuda_build, depth, normal, data, sh, sp)
    with pytest.raises(ValueError, match="data must be"):
        prk.sis(host_lib, data.to(torch.int32), grid, sp, r, 21)
    with pytest.raises(ValueError, match="depth must be"):
        prk.interpolate(host_lib, depth.double(), normal, data, sh, sp)
    with pytest.raises(ValueError, match="normal must be"):
        prk.interpolate(host_lib, depth, normal[:, :, :2], data, sh, sp)
    with pytest.raises(ValueError, match="atlas must be"):
        prk.sh(host_lib, torch.zeros((2 * r, 3 * r, 3), dtype=torch.float64), torch.zeros((2 * r, 3 * r)), grid, r,
               True)
    with pytest.raises(ValueError, match="depth must be"):
        prk.sh(host_lib, torch.zeros((2 * r, 3 * r, 3)), torch.zeros((2 * r, 3 * r + 1)), grid, r, True)
    # Past the design's limits: a spacing above 32 pixels, more than 256
    # texels a probe; a grid larger than the frame.
    big, _ = _gbuffer(66, 33, 33)
    with pytest.raises(ValueError, match="spacing"):
        prk.sis(host_lib, big, (2, 1), 33, 8, 21)
    with pytest.raises(ValueError, match="texels a probe"):
        prk.sis(host_lib, data, grid, sp, 17, 96)
    with pytest.raises(ValueError, match="texels a probe"):
        prk.sh(host_lib, torch.zeros((2 * 17, 3 * 17, 3)), torch.zeros((2 * 17, 3 * 17)), grid, 17, True)
    with pytest.raises(ValueError, match="grid inside the frame"):
        prk.sis(host_lib, data, (grid[0] + 1, grid[1]), sp, r, 21)
    with pytest.raises(RuntimeError, match="probe_sis_kernel launch failed"):
        prk.sis(host_lib, data, grid, sp, r, r * r + 1)


def test_cpu_call_takes_plain_path_and_counts_no_launch(monkeypatch):
    w, h, sp, r = SIZES["sp16_generic"]
    s = _settings(w, h, sp, r)
    data, depth = _gbuffer(w, h, sp)

    def refuse(*a, **k):
        raise AssertionError("a CPU call took the probe resolve's kernels")

    for name in ("load_kernels", "load_host_kernels", "sis", "sh", "interpolate"):
        monkeypatch.setattr(prk, name, refuse)
    before = dict(ttk.LAUNCHES)
    normal, dir_index, mip = tprobes.sis_packed(data, s)
    px, py = s.probe_grid
    atlas = torch.rand((py * r, px * r, 3), generator=torch.Generator().manual_seed(3))
    coeffs = tprobes.project_sh(tprobes.ProbeState(atlas, torch.ones((py * r, px * r)), None), s).sh_coeffs
    light = tprobes.interpolate_packed(depth, normal, data, coeffs, s)
    assert ttk.LAUNCHES == before and all(ttk.LAUNCHES[k] == before[k] for k in ttk.PROBE_RESOLVE_KEYS)
    assert dir_index.dtype == mip.dtype == torch.int64 and light.shape == (h, w, 3) and float(light.max()) > 0.0


def _counting(monkeypatch) -> collections.Counter:
    """Counts each pass the wrapper launches (the host build counts none in
    ``LAUNCHES``)."""
    counts = collections.Counter()
    launch = prk.c_launch

    def counted(lib, name, dev, *args):
        counts[name] += 1
        return launch(lib, name, dev, *args)

    monkeypatch.setattr(prk, "c_launch", counted)
    return counts


@pytest.mark.parametrize("make", [tpipelines.probe_gi_pipeline, tpipelines.hybrid_gi_pipeline],
                         ids=["probe_gi", "hybrid_gi"])
def test_pipeline_step_runs_one_of_each_pass_a_frame(make, host_lib, monkeypatch):
    # The Cornell box at 64x48 (4x3 probes of 8x8 texels) through the
    # packet backend's plain walk: frames 0-2 (a cut, then two blended
    # frames) of the pipeline's step with the kernels' host build run one
    # sis, one sh and one interpolate pass a frame; the SIS's normals and
    # budgets decide the probe rays, so the atlas, its depths and the rays
    # traced are the plain passes' to the bit, and each sh and interpolate
    # pass is held to the plain pass evaluated exactly on the inputs the
    # pipeline gave it.
    scene = tanalytic.cornell_box(device="cpu")
    cam = tanalytic.default_camera(device="cpu")
    backend = ttk.packet_backend(scene=scene, device="cpu")
    s = RenderSettings(width=64, height=48, bounces=1, samples=1)
    calls = collections.defaultdict(list)

    def recording(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls[name].append((args, kw, out))
            return out

        return rec

    def frames():
        step, init_state = make(scene, s, backend=backend, device="cpu")
        state, shown = init_state(), []
        for fi in range(3):
            display, state = step(state, cam, fi)
            shown.append(display)
        return shown, state

    want = frames()
    counts = _counting(monkeypatch)
    monkeypatch.setattr(tprobes, "project_sh", recording("sh", tprobes.project_sh))
    monkeypatch.setattr(tprobes, "interpolate_packed", recording("interpolate", tprobes.interpolate_packed))
    with _resolve_with(host_lib):
        got = frames()
    assert dict(counts) == {k: 3 for k in ttk.PROBE_RESOLVE_KEYS}
    for name in ("probe_atlas", "probe_depth", "rays_traced"):
        _assert_same(got[1][name], want[1][name], f"state {name}")
    assert len(calls["sh"]) == len(calls["interpolate"]) == 3
    for (args, _, out), (iargs, ikw, light) in zip(calls["sh"], calls["interpolate"]):
        state, settings = args
        _assert_within(out.sh_coeffs, *_sh_exact(state, settings, monkeypatch), prk.sh_bound(settings.probe_res),
                       "sh_coeffs")
        assert iargs[3] is out.sh_coeffs
        _assert_within(light, *_light_exact(*iargs, ikw.get("emission", True), monkeypatch), prk.LIGHT_BOUND,
                       "light")
    for k, (g, wt) in enumerate(zip(got[0], want[0])):
        assert float((g - wt).abs().max()) <= DISPLAY_TOL, k
    assert float(got[0][-1].mean()) > 0.0


# -- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(1920, 1088, 16, 8), (1280, 720, 12, 8), (44, 30, 12, 8)],
                         ids=["sponza1080probe", "sp12_generic_720p", "sp12_generic_small"])
def test_cuda_passes_match_plain_on_card(size, monkeypatch):
    # The CUDA build against the plain path run on the card, one launch of
    # each: the SIS to the bit, the SH and the light within their bounds of
    # the exact evaluation.
    dev = _card()
    w, h, sp, r = size
    s = _settings(w, h, sp, r)
    px, py = s.probe_grid
    data, depth = _gbuffer(w, h, sp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    atlas = torch.rand((py * r, px * r, 3), generator=gen, device=dev) * 3.0
    tdepth = torch.where(torch.rand((py * r, px * r), generator=gen, device=dev) < 0.3, 0.0, 5.0)
    before = {k: ttk.LAUNCHES[k] for k in ttk.PROBE_RESOLVE_KEYS}
    sis = tprobes.sis_packed(data, s)
    coeffs = tprobes.project_sh(tprobes.ProbeState(atlas, tdepth, None), s).sh_coeffs
    light = tprobes.interpolate_packed(depth, sis[0], data, coeffs, s)
    indirect = tprobes.interpolate_packed(depth, sis[0], data, coeffs, s, emission=False)
    torch.cuda.synchronize(dev)
    launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.PROBE_RESOLVE_KEYS}
    assert launched == {"probe_sis": 1, "probe_sh": 1, "probe_interpolate": 2}, launched
    with _resolve_with(None):
        want_sis = tprobes.sis_packed(data, s)
    for name, g, wt in zip(("gbuf_normal", "probe_dir", "probe_mip"), sis, want_sis):
        _assert_same(g, wt, name)
    state = tprobes.ProbeState(atlas, tdepth, None)
    _assert_within(coeffs, *_sh_exact(state, s, monkeypatch), prk.sh_bound(r), "sh_coeffs")
    for emission, got_out in ((True, light), (False, indirect)):
        _assert_within(got_out, *_light_exact(depth, sis[0], data, coeffs, s, emission, monkeypatch),
                       prk.LIGHT_BOUND, f"light (emission {emission})")
    assert float(light.max()) > 0.0 and float(indirect.max()) > 0.0


@pytest.mark.gpu
def test_compiled_probe_frame_runs_one_of_each_pass_a_frame():
    """The benchmark's ``sponza1080probe`` frame through ``Viewer.step`` on
    the card: one ``probe_sis``, ``probe_sh`` and ``probe_interpolate``
    launch a captured frame; the frames (a cut, still frames, a move) equal
    to the bit to the eager pipeline's, and against the eager pipeline with
    the plain passes the same atlas to the bit (the SIS picks the same
    rays) and displays within ``DISPLAY_TOL``."""
    dev = _card()
    from raytracer3_tpu_torch.app import viewer as tviewer
    from rtbench import inputs, program, spec, traffic
    from rtbench.frames import probe_gi

    cell = spec.cell("sponza1080probe.walk1")
    cfg = cell.config
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
            before = dict(ttk.LAUNCHES)
        disp = v.step()
        shown.append((v.cam, v.film.frame_index - 1, disp, v.film.accum.clone()))
    v.drain()
    launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.PROBE_RESOLVE_KEYS}
    assert launched == {k: 3 for k in ttk.PROBE_RESOLVE_KEYS}, launched
    s = probe_gi.probe_settings(prog.settings, cfg["probe"])
    runs = []
    for lib in (tprobes._probe_resolve(dev), None):
        with _resolve_with(lib):
            eager, init = tpipelines.probe_gi_pipeline(prog.scene, s, backend=prog.backend, device=dev, jit=False)
            est, out = init(), []
            for cam, film_index, _, _ in shown:
                edisp, est = eager(est, cam, film_index)
                out.append((edisp, {k: v.clone() for k, v in est.items()}))
            runs.append(out)
    for k, ((_, _, disp, light), (kdisp, kst), (pdisp, pst)) in enumerate(zip(shown, *runs)):
        _assert_same(disp, kdisp, f"display {k}")
        _assert_same(light, kst["light"], f"light {k}")
        for name in ("probe_atlas", "probe_depth", "rays_traced"):
            _assert_same(kst[name], pst[name], f"{name} {k}, kernels against the plain passes")
        assert float((kdisp - pdisp).abs().max()) <= DISPLAY_TOL, k
