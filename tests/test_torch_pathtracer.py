"""The port's codecs, packed G-buffer, spherical harmonics and reference-mode
tracer against the JAX reference, on the same inputs (made from a seed with
numpy) on the CPU.

- Packed words (unorm, 11-10-11 normals, colour 888, 2×f16, rgb9e5 and the
  G-buffer's four words) bit-equal.
- Floats decoded from words: bit-equal, except where the reference's float
  path is not correctly rounded on XLA's CPU backend: its ``rsqrt`` (the
  normalisation in ``unpack_normal_11_10_11`` and ``octa_decode``) is off by
  up to one ulp and contracts the sum of squares into FMAs, so those
  outputs are held within 3 ulp; its ``exp2`` is inexact at integer
  arguments (``unpack_rgb9e5``, ``prequant_shift_11_11_10``), held within 1
  ulp or rtol 6e-7 (ROADMAP.md Queue 3).
- ``sh.*`` at rtol 1e-6 (atol 1e-6 near zero).
- ``render_image`` (diffuse, GGX with radiance clamp and two samples) frame
  by frame against the reference's; ``reference_pipeline``'s 16-frame film
  against ``tests/golden/cornell_64_16f.npy``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import packing as jpacking
from raytracer3_tpu.ops import sh as jsh
from raytracer3_tpu.render import gbuffer as jgbuffer
from raytracer3_tpu.render import pathtracer as jpathtracer
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.scene import types as jtypes
from raytracer3_tpu.utils.config import RenderSettings
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import packing as tpacking
from raytracer3_tpu_torch.ops import sh as tsh
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import gbuffer as tgbuffer
from raytracer3_tpu_torch.render import pathtracer as tpathtracer
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 100_000


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def assert_bits(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:
        np.testing.assert_array_equal(ref.astype(np.int64), got)
    else:
        np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))


def assert_ulp(ref, got, k):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    ulp = np.spacing(np.abs(got).astype(np.float32)).astype(np.float64)
    assert (np.abs(ref - got) <= k * ulp).all(), np.abs(ref - got).max()


def _codec_case(name):
    x = np.random.default_rng(1).uniform(-0.2, 1.2, N).astype(np.float32)
    w = _words(N, 2)
    n = _unit(N, 3)
    c = np.random.default_rng(4).lognormal(-1.0, 1.0, (N, 3)).astype(np.float32)
    uv = np.random.default_rng(5).uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    hx = (np.random.default_rng(6).normal(size=(N, 2)) * np.exp(np.random.default_rng(7).uniform(-16, 10, (N, 2))))
    hx = hx.astype(np.float32)
    hdr = np.exp(np.random.default_rng(8).uniform(-30, 30, (N, 3))).astype(np.float32)
    return {
        # name: (reference output, port output, rule)
        "pack_unorm": lambda: [(jpacking.pack_unorm(x, b), tpacking.pack_unorm(_t(x), b), 0) for b in (8, 10, 11, 16)],
        "unpack_unorm": lambda: [(jpacking.unpack_unorm(w, b), tpacking.unpack_unorm(_t(w), b), 0) for b in (8, 11)],
        "pack_normal_11_10_11": lambda: [(jpacking.pack_normal_11_10_11(n), tpacking.pack_normal_11_10_11(_t(n)), 0)],
        "unpack_normal_11_10_11": lambda: [
            (jpacking.unpack_normal_11_10_11(w, do_normalize=False),
             tpacking.unpack_normal_11_10_11(_t(w), do_normalize=False), 0),
            (jpacking.unpack_normal_11_10_11(w), tpacking.unpack_normal_11_10_11(_t(w)), 3),
        ],
        "pack_color_888": lambda: [(jpacking.pack_color_888(c), tpacking.pack_color_888(_t(c)), 0)],
        "unpack_color_888": lambda: [(jpacking.unpack_color_888(w), tpacking.unpack_color_888(_t(w)), 0)],
        "octa_encode": lambda: [(jpacking.octa_encode(n), tpacking.octa_encode(_t(n)), 0)],
        "octa_decode": lambda: [(jpacking.octa_decode(uv), tpacking.octa_decode(_t(uv)), 3)],
        "pack_2xf16": lambda: [(jpacking.pack_2xf16(hx), tpacking.pack_2xf16(_t(hx)), 0)],
        "unpack_2xf16": lambda: [(jpacking.unpack_2xf16(w), tpacking.unpack_2xf16(_t(w)), 0)],
        "pack_rgb9e5": lambda: [(jpacking.pack_rgb9e5(c), tpacking.pack_rgb9e5(_t(c)), 0)],
        "prequant_shift_11_11_10": lambda: [
            (jpacking.prequant_shift_11_11_10(hdr), tpacking.prequant_shift_11_11_10(_t(hdr)), 1)],
    }[name]()


@pytest.mark.parametrize("name", [
    "pack_unorm", "unpack_unorm", "pack_normal_11_10_11", "unpack_normal_11_10_11", "pack_color_888",
    "unpack_color_888", "octa_encode", "octa_decode", "pack_2xf16", "unpack_2xf16", "pack_rgb9e5",
    "prequant_shift_11_11_10",
])
def test_codec_matches_reference(name):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # f16 overflow to inf, on both sides
        cases = _codec_case(name)
    for ref, got, ulps in cases:
        assert tuple(np.asarray(ref).shape) == tuple(got.shape)
        if ulps == 0:
            assert_bits(ref, got)
        else:
            assert_ulp(ref, got, ulps)


def _surfaces(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        albedo=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        emissive=np.where(rng.uniform(size=(n, 1)) < 0.3, rng.lognormal(0.0, 2.0, (n, 3)), 0.0).astype(np.float32),
        normal=_unit(n, seed + 1),
        roughness=rng.uniform(0.0, 1.0, n).astype(np.float32),
        metalness=rng.uniform(0.0, 1.0, n).astype(np.float32),
    )


def test_gbuffer_pack_unpack_matches_reference():
    s = _surfaces(N, 11)
    depth = np.random.default_rng(12).uniform(0.1, 50.0, N).astype(np.float32)
    jp = jgbuffer.pack_surface(jtypes.SurfaceInfo(**s), depth)
    tp = tgbuffer.pack_surface(ttypes.SurfaceInfo(**{k: _t(v) for k, v in s.items()}), _t(depth))
    assert_bits(jp.data, tp.data)  # all four words, bit for bit
    assert_bits(jp.depth, tp.depth)
    # Unpack the same words.
    ju = jgbuffer.unpack_surface(jp)
    tu = tgbuffer.unpack_surface(tgbuffer.PackedGBuffer(_t(jp.data), _t(jp.depth)))
    for f in ("albedo", "roughness", "metalness"):
        assert_bits(getattr(ju, f), getattr(tu, f))
    assert_ulp(ju.normal, tu.normal, 3)  # XLA's rsqrt
    np.testing.assert_allclose(tu.emissive.numpy(), np.asarray(ju.emissive), rtol=6e-7)  # XLA's exp2
    assert_ulp(jgbuffer.unpack_normal(jp), tgbuffer.unpack_normal(tgbuffer.PackedGBuffer(_t(jp.data), None)), 3)
    assert_bits(jgbuffer.roughness_to_perceptual(s["roughness"]), tgbuffer.roughness_to_perceptual(_t(s["roughness"])))
    assert_bits(jgbuffer.perceptual_to_roughness(s["roughness"]), tgbuffer.perceptual_to_roughness(_t(s["roughness"])))


@pytest.mark.parametrize("fn", ["sh2_evaluate", "sh3_evaluate", "sh_dot", "sh3_unproject",
                                "sh3_transform_cos_lobe", "sh3_unproject_cos_lobe", "sh3_project_batch"])
def test_sh_matches_reference(fn):
    rng = np.random.default_rng(21)
    d = _unit(4096, 22)
    a9 = rng.normal(size=(4096, 9)).astype(np.float32)
    c39 = rng.normal(size=(4096, 3, 9)).astype(np.float32)
    dirs = _unit(64 * 64, 23).reshape(64, 64, 3)
    vals = rng.uniform(0.0, 2.0, (64, 64, 3)).astype(np.float32)
    args = {
        "sh2_evaluate": (d,), "sh3_evaluate": (d,), "sh_dot": (a9, a9[::-1].copy()),
        "sh3_unproject": (a9, d), "sh3_transform_cos_lobe": (d,), "sh3_unproject_cos_lobe": (c39, d),
        "sh3_project_batch": (dirs, vals),
    }[fn]
    ref = np.asarray(getattr(jsh, fn)(*args))
    got = getattr(tsh, fn)(*(_t(a) for a in args)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def cornell():
    jscene = janalytic.cornell_box()
    jcam = janalytic.default_camera()
    tscene = ttypes.scene_from_numpy(jscene._asdict(), "cpu")
    tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
    jb = jintersect.brute_backend(scene=jscene)
    tb = tintersect.brute_backend(scene=tscene, device="cpu")
    return jscene, jcam, jb, tscene, tcam, tb


@pytest.mark.parametrize("kind", ["diffuse", "ggx_clamp_2spp", "no_nee"])
def test_render_image_matches_reference(cornell, kind):
    """render_image frame by frame (its G-buffer, trace_radiance and the
    env fill): ≥ 99.5% of pixels within 1e-4 of the reference's (measured:
    all within 3e-6 on the diffuse frames). What may part is an exact tie
    at a box edge, where a ray's triangle is decided by the last ulp of t
    (ROADMAP.md Queue 3)."""
    jscene, jcam, jb, tscene, tcam, tb = cornell
    s = {
        "diffuse": RenderSettings(width=32, height=32, bounces=3, samples=1, diffuse_only=True),
        "ggx_clamp_2spp": RenderSettings(width=32, height=32, bounces=3, samples=2, radiance_clamp=5.0),
        "no_nee": RenderSettings(width=32, height=32, bounces=2, samples=1, diffuse_only=True),
    }[kind]
    use_occl = kind != "no_nee"
    jisect, joccl = jb.bind(jb.arrays)
    tisect, toccl = tb.bind(tb.arrays)
    frame = jax.jit(lambda fi: jpathtracer.render_image(jscene, jcam, s, fi, jisect, joccl if use_occl else None))
    for fi in (0, 5):
        ref = np.asarray(frame(jnp.uint32(fi)))
        got = tpathtracer.render_image(tscene, tcam, s, fi, tisect, toccl if use_occl else None).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all() and got.mean() > 0.01
        assert (np.abs(got - ref).max(-1) <= 1e-4).mean() >= 0.995


def test_reference_pipeline_matches_golden(cornell):
    """reference_pipeline's film after 16 frames (the progressive mean of
    render_image) against the reference's stored 16-frame average: mean
    relative difference < 1e-5 and every pixel within 1e-4 (tighter than
    the image rule of mean < 1e-3 and ≥ 98% within 1e-3; measured 4e-8 and
    3e-6 with the plain mean)."""
    _, _, _, tscene, tcam, tb = cornell
    s = RenderSettings(width=64, height=64, bounces=3, samples=1, diffuse_only=True)
    step, init_state = tpipelines.reference_pipeline(tscene, s, backend=tb, device="cpu")
    state = init_state()
    for fi in range(16):
        display, state = step(state, tcam, fi)
    golden = np.load(os.path.join(REPO, "tests", "golden", "cornell_64_16f.npy"))
    film = state["film"].numpy()
    d = np.abs(film - golden)
    assert d.sum() / np.abs(golden).sum() < 1e-5
    assert d.max() <= 1e-4
    assert display.shape == (64, 64, 3) and np.isfinite(display.numpy()).all()
    assert float(state["frame_count"]) == 16.0


@pytest.mark.gpu
def test_reference_pipeline_golden_on_card():
    """The Cornell golden through the packet backend's K1/K2 walks on the
    card: mean relative difference < 1e-3, ≥ 98% of pixels within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.scene import analytic as tanalytic

    scene = tanalytic.cornell_box(device="cuda")
    cam = tanalytic.default_camera(device="cuda")
    backend = ttk.packet_backend(scene=scene, device="cuda")
    s = RenderSettings(width=64, height=64, bounces=3, samples=1, diffuse_only=True)
    step, init_state = tpipelines.reference_pipeline(scene, s, backend=backend, device="cuda")
    state = init_state()
    before = dict(ttk.LAUNCHES)
    for fi in range(16):
        _, state = step(state, cam, fi)
    assert ttk.LAUNCHES["closest"] > before["closest"] and ttk.LAUNCHES["any"] > before["any"]
    golden = np.load(os.path.join(REPO, "tests", "golden", "cornell_64_16f.npy"))
    d = np.abs(state["film"].cpu().numpy() - golden)
    assert d.sum() / np.abs(golden).sum() < 1e-3
    assert (d.max(-1) <= 1e-3).mean() >= 0.98
