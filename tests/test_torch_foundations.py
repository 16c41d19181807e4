"""The port's foundations against the JAX reference on identical inputs made
with numpy from fixed seeds.

Integer work (RNG, Morton codes, rgb9e5 packing, sort keys, the tile order)
must be bit-equal. Float stages (mathx, BRDFs, AgX) are held to rtol 1e-5 /
atol 1e-6: the two frameworks' transcendentals (sin, cos, log2, pow, rsqrt)
and XLA's contracted multiply-adds differ by a few ulp, nothing more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import brdf as jbrdf
from raytracer3_tpu.ops import mathx as jmathx
from raytracer3_tpu.ops import packing as jpacking
from raytracer3_tpu.ops import rng as jrng
from raytracer3_tpu.ops import tonemap as jtonemap
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu_torch.ops import brdf as tbrdf
from raytracer3_tpu_torch.ops import mathx as tmathx
from raytracer3_tpu_torch.ops import packing as tpacking
from raytracer3_tpu_torch.ops import rng as trng
from raytracer3_tpu_torch.ops import tonemap as ttonemap
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import wavefront as twavefront
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

RTOL, ATOL = 1e-5, 1e-6


def _u32_words(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy → CPU tensor; uint32 words travel as int64 (the port's layout)."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _close(ref, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Bit-equal integer work
# ---------------------------------------------------------------------------


def test_jenkins_hash_bit_equal():
    a = _u32_words(np.random.default_rng(0), 20000)
    ref = np.asarray(jrng.jenkins_hash(jnp.asarray(a)))
    np.testing.assert_array_equal(trng.jenkins_hash(_t(a)).numpy(), ref.astype(np.int64))


def test_murmur3_bit_equal():
    rng = np.random.default_rng(1)
    seed, index = _u32_words(rng, 20000), _u32_words(rng, 20000)
    ref = np.asarray(jrng.murmur3(jnp.asarray(seed), jnp.asarray(index)))
    np.testing.assert_array_equal(trng.murmur3(_t(seed), _t(index)).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("frame", [0, 7, 4294967295])
def test_sampler_draws_bit_equal(frame):
    pix = np.random.default_rng(2).integers(0, 4096, (5000, 2)).astype(np.int32)
    js = jrng.Sampler.from_pixels(jnp.asarray(pix), jnp.uint32(frame))
    ts = trng.Sampler.from_pixels(torch.from_numpy(pix), frame)
    np.testing.assert_array_equal(ts.seed.numpy(), np.asarray(js.seed).astype(np.int64))
    for draw in ("next1", "next2", "next3", "next1", "next3"):
        uj, js = getattr(js, draw)()
        ut, ts = getattr(ts, draw)()
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


def test_zcurve_index_bit_equal():
    pix = np.random.default_rng(3).integers(0, 65536, (20000, 2)).astype(np.int32)
    ref = np.asarray(jmathx.zcurve_index(jnp.asarray(pix)))
    np.testing.assert_array_equal(tmathx.zcurve_index(torch.from_numpy(pix)).numpy(), ref.astype(np.int64))


def test_pack_rgb9e5_bit_equal():
    rng = np.random.default_rng(4)
    rgb = rng.lognormal(0.0, 2.0, (50000, 3)).astype(np.float32)
    rgb[:8] = 0.0
    rgb[8:16] = 1e6  # above MAX_RGB9E5: clamps
    ref = np.asarray(jpacking.pack_rgb9e5(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tpacking.pack_rgb9e5(torch.from_numpy(rgb)).numpy(), ref.astype(np.int64))


def test_unpack_rgb9e5_matches():
    # The port scales by exact powers of two; XLA's CPU exp2 is off by up
    # to ~1 ulp at integer exponents (ROADMAP.md Queue 3), hence rtol 6e-7.
    words = _u32_words(np.random.default_rng(5), 50000)
    ref = np.asarray(jpacking.unpack_rgb9e5(jnp.asarray(words)))
    got = tpacking.unpack_rgb9e5(_t(words)).numpy()
    np.testing.assert_allclose(got, ref, rtol=6e-7, atol=0.0)


@pytest.mark.parametrize("with_bounds", [False, True])
def test_sort_key_pos_dir_bit_equal(with_bounds):
    rng = np.random.default_rng(6)
    n = 20000
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.7
    pos[~alive] = 1e30  # parked lanes, as the wavefront parks them
    jb = tb = None
    if with_bounds:
        lo, hi = np.float32([-10, -10, -10]), np.float32([10, 10, 10])
        jb, tb = (jnp.asarray(lo), jnp.asarray(hi)), (torch.from_numpy(lo), torch.from_numpy(hi))
    ref = np.asarray(jwavefront.sort_key_pos_dir(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(alive), jb))
    got = twavefront.sort_key_pos_dir(torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(alive), tb)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("size", [(960, 544, 128, 32), (48, 48, 32, 16), (64, 64, 64, 64)])
def test_tiled_pixel_order_equal(size):
    w, h, tw, th = size
    ref = np.asarray(jwavefront.tiled_pixel_order(w, h, tw, th))
    np.testing.assert_array_equal(twavefront.tiled_pixel_order(w, h, tw, th, device="cpu").numpy(), ref)
    assert twavefront.pick_tile(w, h) == jwavefront.pick_tile(w, h)


# ---------------------------------------------------------------------------
# Float stages within rtol 1e-5 / atol 1e-6
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(20000, 3)).astype(np.float32)
    w = rng.normal(size=(20000, 3)).astype(np.float32)
    u2 = rng.random((20000, 2)).astype(np.float32)
    n = np.array(jmathx.normalize(jnp.asarray(v)))
    return v, w, u2, n


def test_mathx_vectors(vecs):
    v, w, _, n = vecs
    _close(jmathx.normalize(jnp.asarray(v)), tmathx.normalize(torch.from_numpy(v)))
    _close(jmathx.dot(jnp.asarray(v), jnp.asarray(w)), tmathx.dot(torch.from_numpy(v), torch.from_numpy(w)))
    _close(jnp.cross(jnp.asarray(n), jnp.asarray(w)), tmathx.cross(torch.from_numpy(n), torch.from_numpy(w)))
    onb_j = jmathx.build_orthonormal_basis(jnp.asarray(n))
    onb_t = tmathx.build_orthonormal_basis(torch.from_numpy(n))
    _close(onb_j, onb_t)
    _close(jmathx.to_world(onb_j, jnp.asarray(n)), tmathx.to_world(onb_t, torch.from_numpy(n)))
    _close(jmathx.to_local(onb_j, jnp.asarray(n)), tmathx.to_local(onb_t, torch.from_numpy(n)))
    _close(jmathx.reflect(jnp.asarray(n), jnp.asarray(n[::-1].copy())),
           tmathx.reflect(torch.from_numpy(n), torch.from_numpy(n[::-1].copy())))


@pytest.mark.parametrize("name", ["cosine_sample_hemisphere", "uniform_sample_hemisphere",
                                  "uniform_sample_sphere", "equirect_uv_to_direction"])
def test_mathx_sampling(vecs, name):
    u2 = vecs[2]
    _close(getattr(jmathx, name)(jnp.asarray(u2)), getattr(tmathx, name)(torch.from_numpy(u2)))


def test_mathx_cone_sampling(vecs):
    u2 = vecs[2]
    _close(jmathx.uniform_sample_cone(jnp.asarray(u2), 0.8), tmathx.uniform_sample_cone(torch.from_numpy(u2), 0.8))


def test_mathx_equirect_uv(vecs):
    n = vecs[3]
    _close(jmathx.direction_to_equirect_uv(jnp.asarray(n)), tmathx.direction_to_equirect_uv(torch.from_numpy(n)))


@pytest.fixture(scope="module")
def surface():
    # Roughness >= 0.5 and wo above 0.2 keep GGX well conditioned: at low
    # roughness one ulp of input moves the NDF by ~1e-5 relative.
    rng = np.random.default_rng(8)
    n = 20000
    u3 = rng.random((n, 3)).astype(np.float32)
    alb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    rough = rng.uniform(0.5, 1.0, n).astype(np.float32)
    met = (rng.random(n) < 0.3).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.2
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    return alb, rough, met, wo, u3


def test_brdf_surface_sample(surface):
    js = jbrdf.surface_sample(*(jnp.asarray(x) for x in surface))
    ts = tbrdf.surface_sample(*(torch.from_numpy(x) for x in surface))
    _close(js.wi, ts.wi)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    # pdf and weight scale with 1/cos(wi): compare off the grazing band,
    # where an ulp of wi is an ulp of the result.
    m = np.asarray(js.wi)[:, 2] > 0.1
    assert m.mean() > 0.8
    for field in ("value_over_pdf", "value", "pdf"):
        _close(np.asarray(getattr(js, field))[m], getattr(ts, field)[torch.from_numpy(m)])


def test_brdf_surface_evaluate(surface):
    alb, rough, met, wo, u3 = surface
    wi = np.array(jbrdf.surface_sample(*(jnp.asarray(x) for x in surface)).wi)
    args = (alb, rough, met, wo, wi)
    je = jbrdf.surface_evaluate(*(jnp.asarray(x) for x in args))
    te = tbrdf.surface_evaluate(*(torch.from_numpy(x) for x in args))
    for field in ("value_over_pdf", "value", "pdf"):
        _close(getattr(je, field), getattr(te, field))
    jd = jbrdf.diffuse_evaluate(jnp.asarray(alb), jnp.asarray(wi))
    td = tbrdf.diffuse_evaluate(torch.from_numpy(alb), torch.from_numpy(wi))
    _close(jd.value, td.value)


def test_agx_tonemap():
    c = np.random.default_rng(9).lognormal(0.0, 0.5, (20000, 3)).astype(np.float32)
    _close(jtonemap.agx_tonemap(jnp.asarray(c)), ttonemap.agx_tonemap(torch.from_numpy(c)))


def test_animate_blue_noise_bit_equal():
    bn = np.random.default_rng(10).random((64, 64)).astype(np.float32)
    for fi in (0, 1, 12345, 4294967295):
        ref = np.asarray(jrng.animate_blue_noise(jnp.asarray(bn), jnp.uint32(fi)))
        np.testing.assert_array_equal(trng.animate_blue_noise(torch.from_numpy(bn), fi).numpy(), ref)


def test_animate_blue_noise_tensor_frame_index_bit_equal():
    bn = np.random.default_rng(10).random((64, 64)).astype(np.float32)
    for fi in (3, 4294967295):
        ref = np.asarray(jrng.animate_blue_noise(jnp.asarray(bn), jnp.uint32(fi)))
        got = trng.animate_blue_noise(torch.from_numpy(bn), torch.tensor(fi, dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("size", [(960, 544), (48, 48), (30, 20)])
def test_frame_pixels_built_once(size):
    w, h = size
    tile, pix = twavefront.frame_pixels(w, h, torch.device("cpu"))
    assert tile == twavefront.pick_tile(w, h)
    if tile is None:
        np.testing.assert_array_equal(pix.numpy(), tcamera.pixel_grid(w, h, device="cpu").numpy())
    else:
        np.testing.assert_array_equal(pix.numpy(), np.asarray(jwavefront.tiled_pixel_order(w, h, *tile)))
    assert twavefront.frame_pixels(w, h, torch.device("cpu"))[1] is pix


def test_const_is_uploaded_once():
    c = tmathx.const((1.0, 2.5, -3.0), torch.float32, torch.device("cpu"))
    assert c.dtype == torch.float32 and c.tolist() == [1.0, 2.5, -3.0]
    assert tmathx.const((1.0, 2.5, -3.0), torch.float32, torch.device("cpu")) is c


def test_blue_noise_generator_identical():
    np.testing.assert_array_equal(trng.generate_blue_noise(16), jrng.generate_blue_noise(16))
