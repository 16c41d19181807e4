"""The wavefront tracer's remaining options and the denoiser against the JAX
reference, on the CPU: the same scene, camera and RNG counters through the
reference's function (brute-force backends, as ``tests/test_wavefront.py``
runs them) and through the port's plain path.

Tolerances, each with what this CPU measured:
- Port against reference, every option but the diet: ≥ 99% of pixels
  within 1e-4 and the summed difference within 1e-4 of the image's sum,
  the rule of ``tests/test_torch_wavefront.py`` (measured: ≤ 9.6e-7 on
  Cornell; on the atrium ≤ 2.0e-5 on all but 6 of 3,072 values, 1.2e-4 at
  most: XLA's CPU backend contracts some products into FMAs, and a lane
  whose Russian roulette or NEE threshold sits on the last bit can flip).
- The port's fused and tail-off films against its own split / tail films:
  ``rtol 1e-6, atol 1e-7``, the reference's own bound (measured: equal).
- The diet: the port's diet film against the reference's diet film within
  ``rtol 1e-5, atol 1e-6`` (measured 5.9e-7 relative; XLA's CPU ``exp2``
  in the reference's rgb9e5 unpack is ≤ 1 ulp off, the port's powers of two
  are exact), and against the port's own default film within the
  reference's bound ``rtol 0.02, atol 2e-3`` (rgb9e5 rounding).
- ``atrous_filter``, ``denoise_strength`` and the denoised display within
  ``rtol 1e-5, atol 1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import rng as jrng
from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.render import denoise as jdenoise
from raytracer3_tpu.render import pipelines as jpipelines
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu.utils.config import RenderSettings
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import mathx as tmathx
from raytracer3_tpu_torch.ops import rng as trng
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import denoise as tdenoise
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

RES = 16
FRAME = 7


class Pair:
    """One scene and camera on both sides, with brute-force backends."""

    def __init__(self, jscene, jcam):
        self.jscene, self.jcam = jscene, jcam
        self.tscene = ttypes.scene_from_numpy(jscene._asdict(), "cpu")
        self.tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
        self.jb = jintersect.brute_backend(scene=jscene)
        self.tb = tintersect.brute_backend(scene=self.tscene, device="cpu")

    def ref(self, s, fused=False, **kw):
        isect, occl = self.jb.bind(self.jb.arrays)
        fused_fn = self.jb.bind_capped(self.jb.arrays) if fused else None
        out = jax.jit(lambda fi: jwavefront.render_frame(
            self.jscene, self.jcam, s, fi, isect, occl, fused_fn=fused_fn, **kw))(jnp.uint32(FRAME))
        return jax.tree.map(np.asarray, out)

    def port(self, s, fused=False, **kw):
        isect, occl = self.tb.bind(self.tb.arrays)
        fused_fn = self.tb.bind_capped(self.tb.arrays) if fused else None
        return twavefront.render_frame(self.tscene, self.tcam, s, FRAME, isect, occl, fused_fn=fused_fn, **kw)


@pytest.fixture(scope="module")
def cornell():
    return Pair(janalytic.cornell_box(), janalytic.default_camera())


@pytest.fixture(scope="module")
def atrium():
    # detail=1 with the sky: env-mixture NEE, whose shadow lanes cap near
    # the background depth.
    jscene, _ = jprocedural.atrium_scene(detail=1, return_host=True)
    return Pair(jscene, jprocedural.atrium_camera(aspect=1.0))


def _settings(name, **kw):
    if name == "cornell":
        return RenderSettings(width=RES, height=RES, bounces=3, samples=1, diffuse_only=True, **kw)
    return RenderSettings(width=24, height=24, bounces=2, samples=1, diffuse_only=True, **kw)


def _close_to_reference(got, ref):
    # The port's rule against the reference (tests/test_torch_wavefront.py):
    # ≥ 99% of pixels within 1e-4, and the image's total within 1e-4.
    assert got.shape == ref.shape and np.isfinite(got).all()
    d = np.abs(got - ref)
    assert (d.reshape(-1, d.shape[-1]).max(-1) <= 1e-4).mean() >= 0.99
    assert d.sum() <= 1e-4 * np.abs(ref).sum()


@pytest.mark.parametrize("scene", ["cornell", "atrium"])
def test_fused_matches_split_and_reference(scene, request):
    # One capped launch of [shadow ; bounce] per bounce: the port's film
    # equals its split film and the reference's fused film.
    pair = request.getfixturevalue(scene)
    s = _settings(scene)
    split = pair.port(s).numpy()
    fused = pair.port(dataclasses.replace(s, fuse_shadow=True), fused=True).numpy()
    assert fused.max() > 0
    np.testing.assert_allclose(fused, split, rtol=1e-6, atol=1e-7)
    _close_to_reference(fused, pair.ref(dataclasses.replace(s, fuse_shadow=True), fused=True))


@pytest.mark.parametrize("scene", ["cornell", "atrium"])
def test_tail_anyhit_off_matches_tail_and_reference(scene, request):
    # The last bounce as a closest-hit launch with its own shadow batch.
    pair = request.getfixturevalue(scene)
    s = _settings(scene)
    tail = pair.port(s).numpy()
    off = pair.port(s, tail_anyhit=False).numpy()
    np.testing.assert_allclose(off, tail, rtol=1e-6, atol=1e-7)
    _close_to_reference(off, pair.ref(s, tail_anyhit=False))


@pytest.mark.parametrize("kw", [dict(sort_rays=False), dict(sort_rays=True), dict(fused=True)],
                         ids=["split", "sorted", "fused_and_tail"])
def test_lane_diet_matches_reference_diet_and_default(cornell, kw):
    s = _settings("cornell", fuse_shadow=bool(kw.get("fused")))
    diet = dataclasses.replace(s, lane_diet=True)
    got = cornell.port(diet, **kw).numpy()
    np.testing.assert_allclose(got, cornell.ref(diet, **kw), rtol=1e-5, atol=1e-6)
    default = cornell.port(s, **kw).numpy()
    np.testing.assert_allclose(got, default, rtol=0.02, atol=2e-3)
    assert np.abs(got - default).max() > 0.0  # the diet is active


def test_lane_diet_words_cross_as_int32():
    # A packed crossing holds one int32 word per lane (the packed words'
    # bit 31 wraps to the sign) and rounds as rgb9e5 does.
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.lognormal(0.0, 2.0, (4096, 3)).astype(np.float32))
    (w,) = twavefront._diet_pack(True, c)
    assert w.dtype == torch.int32 and w.shape == (4096,) and bool((w < 0).any())
    (back,) = twavefront._diet_unpack(True, w)
    # The shared exponent: each channel within 2^-8 of the lane's largest.
    assert bool(((back - c).abs() <= c.amax(-1, keepdim=True) * 2.0**-8).all())
    assert twavefront._diet_pack(False, c)[0] is c and twavefront._diet_unpack(False, c)[0] is c


def _queues(pair, s):
    """The same primary wavefront on both sides: (reference queue and
    sampler, port queue and sampler)."""
    w, h = s.width, s.height
    jpix = jcamera.pixel_grid(w, h)
    js = jrng.Sampler.from_pixels(jpix, jnp.uint32(FRAME))
    jo, jd = jcamera.primary_rays(pair.jcam, w, h, jitter=jnp.full((w * h, 2), 0.5), pixel_xy=jpix)
    jh = pair.jb.intersect(jo, jd)
    jq = jwavefront.RayQueue(
        origin=jo, direction=jd, throughput=jnp.ones((w * h, 3)), radiance=jnp.zeros((w * h, 3)),
        pixel_id=jnp.arange(w * h, dtype=jnp.int32), alive=jh.hit, prev_pdf=jnp.full((w * h,), 1e8),
        depth=jh.t, prim_id=jh.prim_id, uv=jh.uv)
    tpix = tcamera.pixel_grid(w, h, device="cpu")
    ts = trng.Sampler.from_pixels(tpix, FRAME)
    to, td = tcamera.primary_rays(pair.tcam, w, h, jitter=torch.full((w * h, 2), 0.5), pixel_xy=tpix)
    th = pair.tb.intersect(to, td)
    tq = twavefront.RayQueue(
        origin=to, direction=td, throughput=torch.ones((w * h, 3)), radiance=torch.zeros((w * h, 3)),
        pixel_id=torch.arange(w * h, dtype=torch.int32), alive=th.hit, prev_pdf=torch.full((w * h,), 1e8),
        depth=th.t, prim_id=th.prim_id, uv=th.uv)
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("rr_start", [0, 1])
def test_rr_start_matches_reference(cornell, rr_start):
    # Russian roulette from an earlier bounce: the same lanes die, the
    # survivors carry the same 1/p, the ray meter agrees.
    s = RenderSettings(width=RES, height=RES, bounces=4, samples=1, diffuse_only=True)
    (jq, js), (tq, ts) = _queues(cornell, s)
    jisect, joccl = cornell.jb.bind(cornell.jb.arrays)
    tisect, toccl = cornell.tb.bind(cornell.tb.arrays)
    jout, jn = jax.jit(lambda q: jwavefront.trace_wavefront(
        cornell.jscene, jisect, q, js, s, joccl, rr_start=rr_start))(jq)
    tout, tn = twavefront.trace_wavefront(cornell.tscene, tisect, tq, ts, s, toccl, rr_start=rr_start)
    _, tn_late = twavefront.trace_wavefront(cornell.tscene, tisect, tq, ts, s, toccl)
    # The meter and the live lanes may differ by a lane whose roulette
    # draw sits on the last bit of its probability.
    assert abs(int(tn) - int(jn)) <= 2 and int(tn) < int(tn_late)  # roulette kills lanes early
    assert int((tout.alive != torch.from_numpy(np.array(jout.alive))).sum()) <= 2
    _close_to_reference(tout.radiance.numpy(), np.asarray(jout.radiance))


@pytest.mark.parametrize("samples", [1, 2])
def test_return_gbuffer_matches_reference(atrium, samples):
    # Sample 0's primary depth and geometric normal, un-swizzled as the film
    # (96×16 takes three 32×16 tiles), next to radiance and the ray count.
    s = RenderSettings(width=96, height=16, bounces=1, samples=samples, sample_batch=samples > 1,
                       diffuse_only=True)
    jrad, jn, (jdepth, jnrm) = atrium.ref(s, return_stats=True, return_gbuffer=True)
    trad, tn, (tdepth, tnrm) = atrium.port(s, return_stats=True, return_gbuffer=True)
    assert twavefront.pick_tile(96, 16) == (32, 16) and tdepth.shape == (16, 96) and tnrm.shape == (16, 96, 3)
    assert abs(int(tn) - int(jn)) <= 2
    _close_to_reference(trad.numpy(), jrad)
    np.testing.assert_allclose(tdepth.numpy(), jdepth, rtol=1e-5)  # measured 1.0e-6
    np.testing.assert_allclose(tnrm.numpy(), jnrm, rtol=1e-6, atol=1e-7)
    lengths = np.linalg.norm(tnrm.numpy(), axis=-1)
    sky = tdepth.numpy() >= tmathx.BACKGROUND_DEPTH
    assert np.allclose(lengths[~sky], 1.0, atol=1e-5) and (lengths[sky] == 0).all()


def test_untiled_primaries_match_reference(atrium):
    s = RenderSettings(width=96, height=16, bounces=2, samples=1, diffuse_only=True)
    got = atrium.port(s, tile_primaries=False).numpy()
    _close_to_reference(got, atrium.ref(s, tile_primaries=False))
    # Each lane's RNG is keyed on its pixel, so the lane order does not move
    # the image.
    assert twavefront.frame_pixels(96, 16, torch.device("cpu"), False)[0] is None
    np.testing.assert_allclose(got, atrium.port(s).numpy(), rtol=1e-6, atol=1e-7)


def _gbuffer_inputs(seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    color = rng.lognormal(-1.0, 1.0, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 30.0, (h, w)).astype(np.float32)
    depth[:, : w // 5] = 1e30  # a sky band
    depth[rng.uniform(size=(h, w)) < 0.05] = 1e30
    n = rng.normal(size=(h, w, 3))
    n[h // 2:] += (0.0, 3.0, 0.0)  # a second, flatter region
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return color, depth, normal


@pytest.mark.parametrize("iterations", [1, 3])
def test_atrous_filter_matches_reference(iterations):
    color, depth, normal = _gbuffer_inputs(iterations)
    ref = np.asarray(jdenoise.atrous_filter(jnp.asarray(color), jnp.asarray(depth), jnp.asarray(normal),
                                            iterations=iterations))
    got = tdenoise.atrous_filter(torch.from_numpy(color), torch.from_numpy(depth), torch.from_numpy(normal),
                                 iterations=iterations).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    sky = depth >= 1e30
    assert np.array_equal(got[sky], color[sky]) and np.abs(got - color)[~sky].max() > 0.01


@pytest.mark.parametrize("count", [0.0, 1.0, 4.0, 5.0, 33.5, 64.0, 100.0])
def test_denoise_strength_matches_reference(count):
    ref = np.asarray(jdenoise.denoise_strength(jnp.float32(count)))
    assert float(tdenoise.denoise_strength(torch.tensor(count))) == float(ref)
    assert float(tdenoise.denoise_strength(count)) == float(ref)


def test_denoised_pipeline_matches_reference(cornell):
    # Three frames of wavefront_pipeline(denoise=True): the display through
    # the filter equals the reference's, and differs from the plain one.
    s = RenderSettings(width=32, height=32, bounces=2, samples=1)
    bn = jrng.generate_blue_noise(16)
    jstep, jinit = jpipelines.wavefront_pipeline(cornell.jscene, s, backend=cornell.jb,
                                                 blue_noise=jnp.asarray(bn), denoise=True)
    tstep, tinit = tpipelines.wavefront_pipeline(cornell.tscene, s, backend=cornell.tb,
                                                 blue_noise=torch.from_numpy(bn), denoise=True, device="cpu")
    pstep, pinit = tpipelines.wavefront_pipeline(cornell.tscene, s, backend=cornell.tb,
                                                 blue_noise=torch.from_numpy(bn), device="cpu")
    jstate, tstate, pstate = jinit(), tinit(), pinit()
    for i in range(3):
        jdisp, jstate = jstep(jstate, cam=cornell.jcam, frame_index=jnp.uint32(i))
        tdisp, tstate = tstep(tstate, cornell.tcam, i)
        pdisp, pstate = pstep(pstate, cornell.tcam, i)
        np.testing.assert_allclose(tdisp.numpy(), np.asarray(jdisp), rtol=1e-5, atol=1e-5)
        assert np.abs(tdisp.numpy() - pdisp.numpy()).max() > 1e-3
    # The film itself stays unfiltered.
    assert torch.equal(tstate["film"], pstate["film"]) and float(tstate["frame_count"]) == 3.0


def test_fuse_shadow_without_capped_trace_takes_the_split_path(cornell):
    # The packet backend has no capped trace: fuse_shadow leaves its frames
    # on the split path, to the bit (the reference's rule).
    backend = ttk.packet_backend(scene=cornell.tscene, device="cpu")
    assert backend.bind_capped(backend.arrays) is None
    s = RenderSettings(width=RES, height=RES, bounces=3, samples=1)
    shown = []
    for fuse in (False, True):
        step, init = tpipelines.wavefront_pipeline(cornell.tscene, dataclasses.replace(s, fuse_shadow=fuse),
                                                   backend=backend, device="cpu")
        shown.append(step(init(), cornell.tcam, 0)[0])
    assert torch.equal(shown[0], shown[1]) and float(shown[0].mean()) > 0


def test_treelet_capped_launch_matches_brute_force():
    # The treelet backend's capped trace on the CPU plain path (K3's plain
    # version, two treelets): flagged lanes answer occlusion within their
    # cap, the others the closest hit, as the brute force does.
    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    backend = ttreelets.treelet_backend(host_tris=tris, max_tris=4096, device="cpu")
    brute = tintersect.brute_backend(scene=scene, device="cpu")
    assert backend.meta.num_treelets >= 2
    rng = np.random.default_rng(9)
    n = 3000
    o = torch.from_numpy((rng.uniform(-8.0, 8.0, (n, 3)) + (0.0, 4.0, 0.0)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    cap = torch.from_numpy(rng.uniform(0.5, 20.0, n).astype(np.float32))
    flag = torch.from_numpy(rng.uniform(size=n) < 0.5)
    cap = torch.where(flag, cap, tmathx.BACKGROUND_DEPTH)
    got = backend.bind_capped(backend.arrays)(o, d, cap, flag)
    ref = brute.bind_capped(brute.arrays)(o, d, cap, flag)
    limit = max(2, n // 500)
    assert int((got.hit != ref.hit).sum()) <= limit and 0 < int(got.hit[flag].sum()) < int(flag.sum())
    both = ~flag & got.hit & ref.hit
    torch.testing.assert_close(got.t[both], ref.t[both], rtol=1e-4, atol=1e-5)
    assert int((got.prim_id[both] == ref.prim_id[both]).sum()) >= 0.99 * int(both.sum()) > 0


@pytest.mark.parametrize("aspect", [384 / 216, 1.0])
def test_ggx_oracle_camera_matches_reference(aspect):
    # The view of resources/oracle_atrium_ggx_384x216.npz.
    jcam = jprocedural.atrium_camera_ggx(aspect=aspect)
    tcam = tprocedural.atrium_camera_ggx(aspect=aspect, device="cpu")
    for field in jcam._fields:
        np.testing.assert_allclose(getattr(tcam, field).numpy(), np.asarray(getattr(jcam, field)),
                                   rtol=1e-6, atol=1e-7, err_msg=field)
