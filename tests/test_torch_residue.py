"""The port's helper functions outside the render paths (``ops/mathx``,
``ops/rng``, ``ops/brdf``, ``ops/intersect``) against the JAX reference on
the same inputs, made with numpy from fixed seeds.

Integer work is bit-equal: ``integer_explode3``, ``morton3d``,
``radical_inverse_vdc`` and ``hammersley`` (their floats come from exact
integer-to-float conversions and a division by a power of two or by n).
Float helpers are held to rtol 1e-5 / atol 1e-6, the foundations' rule
(``test_torch_foundations.py``): the frameworks' transcendentals and XLA's
reduction and multiply-add orders differ by a few ulp. The reference's own
cases of these helpers (``test_mathx.py``, ``test_rng_packing.py``,
``test_brdf_sh_tonemap.py``, ``test_intersect.py``) are mirrored on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import brdf as jbrdf
from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import mathx as jmathx
from raytracer3_tpu.ops import rng as jrng
from raytracer3_tpu_torch.ops import brdf as tbrdf
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import mathx as tmathx
from raytracer3_tpu_torch.ops import rng as trng
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

RTOL, ATOL = 1e-5, 1e-6


def _close(ref, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _equal(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
        got = got.astype(np.uint32)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = 20000
    return dict(
        v=rng.normal(size=(n, 3)).astype(np.float32),
        w=rng.normal(size=(n, 3)).astype(np.float32),
        rgba_b=rng.random((n, 4)).astype(np.float32),
        rgba_c=rng.random((n, 4)).astype(np.float32),
        depth=rng.uniform(0.0, 50.0, (2, n)).astype(np.float32),
        pos=rng.uniform(0.0, 1.0, n).astype(np.float32),
        unit=rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32),
        words=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        table=rng.normal(size=(97, 5)).astype(np.float32),
        idx=rng.integers(0, 97, n).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# ops/mathx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keepdims", [True, False])
def test_length_helpers(data, keepdims):
    v = data["v"]
    _close(jmathx.length(jnp.asarray(v), keepdims), tmathx.length(torch.from_numpy(v), keepdims))
    _close(jmathx.length_squared(jnp.asarray(v), keepdims), tmathx.length_squared(torch.from_numpy(v), keepdims))


def test_gather_rows_bit_equal(data):
    got = tmathx.gather_rows(torch.from_numpy(data["table"]), torch.from_numpy(data["idx"]).long())
    _equal(jmathx.gather_rows(jnp.asarray(data["table"]), jnp.asarray(data["idx"])), got)


def test_lerp_luminance_and_depth_helpers(data):
    v, w, (d0, d1), s = data["v"], data["w"], data["depth"], data["pos"]
    _close(jmathx.inverse_lerp(jnp.asarray(v), jnp.asarray(w), jnp.asarray(s)[:, None]),
           tmathx.inverse_lerp(torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(s)[:, None]),
           rtol=1e-4)  # a near-zero (maxv - minv) amplifies one ulp
    _close(jmathx.luminance(jnp.asarray(np.abs(v))), tmathx.luminance(torch.from_numpy(np.abs(v))))
    _close(jmathx.inverse_depth_relative_diff(jnp.asarray(d0), jnp.asarray(d1)),
           tmathx.inverse_depth_relative_diff(torch.from_numpy(d0), torch.from_numpy(d1)))


def test_prelerp(data):
    b, c = data["rgba_b"].copy(), data["rgba_c"].copy()
    c[:64, 3] = 0.0  # denominators at and below the cut
    b[:32, 3] = 0.0
    _close(jmathx.prelerp(jnp.asarray(b), jnp.asarray(c)), tmathx.prelerp(torch.from_numpy(b), torch.from_numpy(c)))


@pytest.mark.parametrize("scale", [0.5, 2.0, 40.0])
def test_exponential_squish(data, scale):
    x = data["depth"][0]
    s_ref = jmathx.exponential_squish(jnp.asarray(x), scale)
    s_got = tmathx.exponential_squish(torch.from_numpy(x), scale)
    _close(s_ref, s_got)
    _close(jmathx.exponential_unsquish(s_ref, scale),
           tmathx.exponential_unsquish(torch.from_numpy(np.array(s_ref)), scale))


def test_integer_explode3_bit_equal(data):
    _equal(jmathx.integer_explode3(jnp.asarray(data["words"])), tmathx.integer_explode3(torch.from_numpy(
        data["words"].astype(np.int64))))


def test_morton3d_bit_equal(data):
    # Points in and out of [0, 1)^3: the clamp at both ends.
    p = data["unit"]
    _equal(jmathx.morton3d(jnp.asarray(p)), tmathx.morton3d(torch.from_numpy(p)))


def test_morton3d_ordering():
    # test_mathx.py::TestMorton::test_morton3d_ordering on the port.
    m = tmathx.morton3d(torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]))
    assert int(m[0]) == 0 and int(m[1]) == (1 << 30) - 1


def test_mirror_mathx_misc():
    # test_mathx.py::TestMisc's prelerp identity, squish round trip and
    # luminance on the port.
    g = torch.Generator().manual_seed(0)
    a, b, c = torch.rand(64, 3, generator=g), torch.rand(64, 4, generator=g), torch.rand(64, 4, generator=g)
    d = tmathx.prelerp(b, c)
    lhs = a + (d[..., :3] - a) * d[..., 3:4]
    inner = a + (b[..., :3] - a) * b[..., 3:4]
    rhs = inner + (c[..., :3] - inner) * c[..., 3:4]
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)
    x = torch.tensor([0.01, 0.1, 1.0, 5.0])
    s = tmathx.exponential_squish(x, 2.0)
    np.testing.assert_allclose(tmathx.exponential_unsquish(s, 2.0).numpy(), x.numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(tmathx.luminance(torch.ones(3))), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/rng
# ---------------------------------------------------------------------------


def test_radical_inverse_vdc_bit_equal(data):
    words = np.concatenate([data["words"], np.array([0, 1, 2, 3, 2**31, 2**32 - 1], np.uint32)])
    _equal(jrng.radical_inverse_vdc(jnp.asarray(words)), trng.radical_inverse_vdc(torch.from_numpy(
        words.astype(np.int64))))


@pytest.mark.parametrize("n", [64, 1000, 2**20])
def test_hammersley_bit_equal(n):
    i = np.concatenate([np.arange(n), [2**32 - 1]]).astype(np.uint32)  # the last wraps to 0
    _equal(jrng.hammersley(jnp.asarray(i), n), trng.hammersley(torch.from_numpy(i.astype(np.int64)), n))


def test_r2_sequence(data):
    i = np.concatenate([np.arange(4096), data["words"][:4096] >> 8, data["words"][:4096]]).astype(np.uint32)
    _close(jrng.r2_sequence(jnp.asarray(i)), trng.r2_sequence(torch.from_numpy(i.astype(np.int64))))


def test_mirror_lds():
    # test_rng_packing.py::TestLDS on the port.
    got = trng.radical_inverse_vdc(torch.tensor([1, 2, 3]))
    np.testing.assert_allclose(got.numpy(), [0.5, 0.25, 0.75], atol=1e-7)
    pts = trng.hammersley(torch.arange(64), 64)
    assert bool((pts > 0).all()) and bool((pts <= 1.0).all())
    pts = trng.r2_sequence(torch.arange(1024)).numpy()
    assert (pts >= 0).all() and (pts < 1.0).all()
    np.testing.assert_allclose(pts.mean(axis=0), [0.5, 0.5], atol=0.01)


# ---------------------------------------------------------------------------
# ops/brdf
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lobes():
    rng = np.random.default_rng(12)
    n = 20000
    f0 = rng.uniform(0.02, 0.95, (n, 3)).astype(np.float32)
    cos = rng.uniform(-0.2, 1.0, n).astype(np.float32)
    a2 = rng.uniform(0.25, 1.0, n).astype(np.float32) ** 2
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2])
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    return f0, cos, a2, rough, wi


def test_fresnel_schlick(lobes):
    f0, cos, *_ = lobes
    _close(jbrdf.fresnel_schlick(jnp.asarray(f0), 1.0, jnp.asarray(cos)),
           tbrdf.fresnel_schlick(torch.from_numpy(f0), 1.0, torch.from_numpy(cos)))
    _close(jbrdf.fresnel_schlick(jnp.asarray(f0[:, 0]), 0.5, jnp.asarray(cos)),
           tbrdf.fresnel_schlick(torch.from_numpy(f0[:, 0]), 0.5, torch.from_numpy(cos)))


def test_pdf_ggx(lobes):
    _, cos, a2, *_ = lobes
    c = np.abs(cos)
    _close(jbrdf.pdf_ggx(jnp.asarray(a2), jnp.asarray(c)), tbrdf.pdf_ggx(torch.from_numpy(a2), torch.from_numpy(c)))


def test_diffuse_wi_to_primary_sample_space(lobes):
    wi = lobes[4]
    # x wraps at 1: a direction on the wrap's seam may land on either side.
    ref = np.asarray(jbrdf.diffuse_wi_to_primary_sample_space(jnp.asarray(wi)))
    got = tbrdf.diffuse_wi_to_primary_sample_space(torch.from_numpy(wi)).numpy()
    dx = np.abs(got[:, 0] - ref[:, 0])
    np.testing.assert_array_less(np.minimum(dx, 1.0 - dx), ATOL + RTOL)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_specular_dominant_direction(lobes, per_lane):
    _, _, _, rough, wi = lobes
    n = np.roll(wi, 1, axis=0)
    r = rough if per_lane else 0.3
    _close(jbrdf.specular_dominant_direction(jnp.asarray(n), jnp.asarray(wi), r),
           tbrdf.specular_dominant_direction(torch.from_numpy(n), torch.from_numpy(wi),
                                             torch.from_numpy(r) if per_lane else r))


def test_mirror_brdf_helpers():
    # test_brdf_sh_tonemap.py's primary-sample-space round trip and dominant
    # direction on the port.
    g = torch.Generator().manual_seed(1)
    u = torch.rand(256, 2, generator=g) * 0.98 + 0.01
    s = tbrdf.diffuse_sample(torch.ones(256, 3), u)
    np.testing.assert_allclose(tbrdf.diffuse_wi_to_primary_sample_space(s.wi).numpy(), u.numpy(), atol=1e-4)
    nrm = torch.tensor([0.0, 0.0, 1.0])
    v = tmathx.normalize(torch.tensor([0.5, 0.0, 0.7]))
    np.testing.assert_allclose(tbrdf.specular_dominant_direction(nrm, v, 0.0).numpy(),
                               tmathx.reflect(-v, nrm).numpy(), atol=1e-5)
    np.testing.assert_allclose(tbrdf.specular_dominant_direction(nrm, v, 1.0).numpy(), nrm.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# ops/intersect
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(13)
    n = 20000
    o = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16, 1:] = 0.0  # axis-aligned rays: infinite inverse components
    d[:16, 0] = 1.0
    return o, d


def test_ray_sphere(rays):
    o, d = rays
    c = np.array([0.3, -0.2, 0.5], np.float32)
    tr, hr = jintersect.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), 1.5)
    tg, hg = tintersect.ray_sphere(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(c), 1.5)
    assert 1000 < int(hg.sum()) < o.shape[0]
    _equal(hr, hg)
    _close(tr, tg)


def test_ray_aabb(rays):
    o, d = rays
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    bmin, bmax = np.array([-1.0, -0.5, -2.0], np.float32), np.array([1.5, 0.5, 1.0], np.float32)
    tr, hr = jintersect.ray_aabb(jnp.asarray(o), jnp.asarray(inv), jnp.asarray(bmin), jnp.asarray(bmax))
    tg, hg = tintersect.ray_aabb(torch.from_numpy(o), torch.from_numpy(inv), torch.from_numpy(bmin),
                                 torch.from_numpy(bmax))
    assert 1000 < int(hg.sum()) < o.shape[0]
    # min/max and products are exact: the slab test is bit-equal.
    _equal(hr, hg)
    _equal(tr, tg)


def test_hit_miss_matches_reference():
    ref = jintersect.Hit.miss((5,))
    got = tintersect.Hit.miss((5,), device="cpu")
    for name in ("t", "uv", "prim_id", "hit"):
        _equal(getattr(ref, name), getattr(got, name))
    assert got.inst is None


def test_mirror_ray_sphere_and_aabb():
    # test_intersect.py::TestRaySphere and ::TestRayAABB on the port.
    t, hit = tintersect.ray_sphere(torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
                                   torch.zeros(3), 1.0)
    assert bool(hit[0]) and abs(float(t[0]) - 2.0) < 1e-5
    t, hit = tintersect.ray_sphere(torch.zeros(1, 3), torch.tensor([[0.0, 0.0, 1.0]]), torch.zeros(3), 1.0)
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-5
    o = torch.tensor([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0]])
    inv_d = 1.0 / torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    tn, hits = tintersect.ray_aabb(o, inv_d, -torch.ones(3), torch.ones(3))
    assert bool(hits[0]) and not bool(hits[1]) and abs(float(tn[0]) - 4.0) < 1e-5
    inv_d = 1.0 / torch.tensor([[0.0, 0.0, 1.0]]).clamp_min(1e-30)
    _, hits = tintersect.ray_aabb(torch.zeros(1, 3), inv_d, -torch.ones(3), torch.ones(3))
    assert bool(hits[0])
