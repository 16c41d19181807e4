"""The port's scene, shading, camera and environment lookups against the JAX
reference.

``make_scene`` on the same numpy geometry must give bit-equal integer arrays
and float fields within 1e-6 (they are copies of the same host arrays).
Shading and rays on identical state are held to rtol 1e-5 / atol 1e-6.
Environment lookups index a texel from a direction: an ulp of atan2 can move
a lane across a texel edge, so those compare per lane with the share of
lanes that must agree stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.render import pathtracer as jpathtracer
from raytracer3_tpu.render import postprocess as jpostprocess
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu.scene import types as jtypes
from raytracer3_tpu_torch.ops import rng as trng
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import pathtracer as tpathtracer
from raytracer3_tpu_torch.render import postprocess as tpostprocess
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def atrium():
    jscene = jprocedural.atrium_scene(detail=1)
    tscene = tprocedural.atrium_scene(detail=1, device="cpu")
    return jscene, tscene


def _leaves(x, prefix=""):
    """Flatten a (nested) NamedTuple into {path: array-or-None}."""
    out = {}
    for k, v in x._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_scene_equal(jscene, tscene):
    jl, tl = _leaves(jscene), _leaves(tscene)
    for name, tv in tl.items():
        if name == "tex_words":
            # The port's packed texel words, made once per scene, have no
            # reference field (tests/test_torch_textures.py holds them
            # against the reference's pack).
            assert (tv is None) == (jl["tex_atlas"] is None and jl["textures"] is None)
            continue
        jv = jl[name]
        if tv is None:
            assert jv is None, name
            continue
        jv = np.asarray(jv)
        tv = tv.numpy()
        assert jv.shape == tv.shape, name
        if np.issubdtype(jv.dtype, np.integer):
            np.testing.assert_array_equal(tv, jv, err_msg=name)
        else:
            np.testing.assert_allclose(tv, jv, rtol=0.0, atol=1e-6, err_msg=name)
    # Everything the port leaves out is absent in the reference scene too.
    for name in set(jl) - set(tl):
        assert jl[name] is None, name


def test_make_scene_atrium_with_sky(atrium):
    jscene, tscene = atrium
    assert tscene.env_sample_table is not None
    _assert_scene_equal(jscene, tscene)


def test_make_scene_cornell():
    _assert_scene_equal(janalytic.cornell_box(), tanalytic.cornell_box(device="cpu"))


def test_scene_from_numpy_roundtrip(atrium):
    jscene, _ = atrium
    _assert_scene_equal(jscene, ttypes.scene_from_numpy(jscene._asdict(), "cpu"))


def test_build_emissive_table(atrium):
    kw = jprocedural.atrium(detail=1)
    args = [kw[k] for k in ("positions", "indices", "geo_id", "emission")]
    _assert_scene_equal(jtypes.build_emissive_table(*args, pad_to=64),
                        ttypes.build_emissive_table(*args, pad_to=64, device="cpu"))


def test_textured_scene_raises():
    # A textured scene (the legacy texture array) builds as the reference's.
    # The name is the refusal this test used to hold: a scene without shade
    # rows builds too now, and shades as the reference's slow path does.
    kw = dict(
        positions=np.zeros((3, 3)), normals=np.zeros((3, 3)), uvs=np.zeros((3, 2)),
        indices=np.asarray([[0, 1, 2]]), geo_id=np.zeros(1, np.int32),
        base_color=np.ones((1, 4)), emission=np.zeros((1, 3)), metallic=np.zeros(1),
        roughness=np.ones(1), base_color_texture=np.zeros(1, np.int32), textures=np.ones((1, 4, 4, 3), np.float32),
    )
    jscene = jtypes.make_scene(**kw)
    _assert_scene_equal(jscene, ttypes.make_scene(**kw, device="cpu"))
    slow_j = jscene._replace(shade_table=None, mat_table=None)
    slow_t = ttypes.scene_from_numpy(slow_j._asdict(), "cpu")
    assert slow_t.shade_table is None and slow_t.mat_table is None and slow_t.tex_words is not None
    uv = np.asarray([[0.2, 0.3], [0.0, 0.0], [0.5, 0.5]], np.float32)
    prim = np.zeros(3, np.int32)
    got = ttypes.hit_surface_info(slow_t, torch.from_numpy(prim), torch.from_numpy(uv))
    ref = jtypes.hit_surface_info(slow_j, prim, uv)
    for k in ("albedo", "emissive", "normal", "roughness", "metalness"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), atol=1e-6, err_msg=k)


def test_hit_surface_info(atrium):
    jscene, tscene = atrium
    rng = np.random.default_rng(0)
    n = 20000
    prim = rng.integers(-1, jscene.num_triangles, n).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    uv = np.where(uv.sum(-1, keepdims=True) > 1.0, 1.0 - uv, uv).astype(np.float32)
    js = jtypes.hit_surface_info(jscene, jnp.asarray(prim), jnp.asarray(uv))
    ts = ttypes.hit_surface_info(tscene, torch.from_numpy(prim), torch.from_numpy(uv))
    for field in ("albedo", "emissive", "roughness", "metalness"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), err_msg=field)
    np.testing.assert_allclose(ts.normal.numpy(), np.asarray(js.normal), rtol=RTOL, atol=ATOL)
    gj = jtypes.geometric_normals(jscene, jnp.asarray(prim))
    gt = ttypes.geometric_normals(tscene, torch.from_numpy(prim))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aspect", [1.0, 960 / 544])
def test_camera_and_primary_rays(aspect):
    jcam = jprocedural.atrium_camera(aspect=aspect)
    tcam = tprocedural.atrium_camera(aspect=aspect, device="cpu")
    for field in jcam._fields:
        np.testing.assert_allclose(getattr(tcam, field).numpy(), np.asarray(getattr(jcam, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    w, h = 96, 64
    jit = np.random.default_rng(1).random((w * h, 2)).astype(np.float32)
    jo, jd = jcamera.primary_rays(jcam, w, h, jitter=jnp.asarray(jit))
    to, td = tcamera.primary_rays(tcamera.camera_from_numpy(jcam._asdict(), "cpu"), w, h,
                                  jitter=torch.from_numpy(jit))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tcamera.pixel_grid(w, h, device="cpu").numpy(),
                                  np.asarray(jcamera.pixel_grid(w, h)))


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _lanes_agree(ref, got, rtol=RTOL, atol=ATOL):
    ref, got = np.asarray(ref), got.numpy()
    ok = np.abs(got - ref) <= atol + rtol * np.abs(ref)
    return ok.reshape(ok.shape[0], -1).all(-1)


def test_env_lookups(atrium):
    # ≥ 99.9% of lanes must agree; the rest sit on a texel edge.
    jscene, tscene = atrium
    d = _dirs(20000, 2)
    js = jpathtracer._sample_env(jscene, jnp.asarray(d))
    ts = tpathtracer._sample_env(tscene, torch.from_numpy(d))
    assert _lanes_agree(js, ts).mean() >= 0.999
    (jr, jp), (tr, tp) = (jpathtracer._env_radiance_pdf(jscene, jnp.asarray(d)),
                          tpathtracer._env_radiance_pdf(tscene, torch.from_numpy(d)))
    assert (_lanes_agree(jr, tr) & _lanes_agree(jp, tp, rtol=2e-5)).mean() >= 0.999


def test_env_light_sampling(atrium):
    # Alias-table sampling reads no direction, so every lane agrees.
    jscene, tscene = atrium
    u3 = np.random.default_rng(3).random((20000, 3)).astype(np.float32)
    jd, jl, jp = jpathtracer._sample_env_light(jscene, jnp.asarray(u3))
    td, tl, tp = tpathtracer._sample_env_light(tscene, torch.from_numpy(u3))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.fixture(scope="module")
def sky_only():
    kw = jprocedural.atrium(detail=1)
    kw["emission"] = np.zeros_like(kw["emission"])
    env = jprocedural.sky_equirect(64, 128)
    return (jtypes.make_scene(env_map=env, **kw), ttypes.make_scene(env_map=env, device="cpu", **kw))


@pytest.mark.parametrize("scene_name,rr", [("atrium", 0.0), ("atrium", 0.5), ("cornell", 0.0),
                                           ("sky_only", 0.0)])
def test_nee_prepare(atrium, sky_only, scene_name, rr):
    # Light sampling + BRDF + MIS on identical hit points: the mixture path
    # (atrium: area lights + sky, with and without shadow-ray roulette, and
    # a sky over no emitters, whose area samples are all invalid) and the
    # area-only path (Cornell).
    from raytracer3_tpu.ops import rng as jrng
    from raytracer3_tpu.utils.config import RenderSettings

    jscene, tscene = {
        "atrium": atrium,
        "sky_only": sky_only,
        "cornell": (janalytic.cornell_box(), tanalytic.cornell_box(device="cpu")),
    }[scene_name]
    rng = np.random.default_rng(4)
    n = 8192
    prim = rng.integers(0, jscene.num_triangles, n).astype(np.int32)
    uv = (rng.random((n, 2)) * 0.5).astype(np.float32)
    surf_j = jtypes.hit_surface_info(jscene, jnp.asarray(prim), jnp.asarray(uv))
    surf_t = ttypes.SurfaceInfo(*(torch.from_numpy(np.array(a)) for a in surf_j))
    hp = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32([0, 1, 0])
    wo = _dirs(n, 5)
    nrm = np.array(surf_j.normal)
    nrm = np.where((nrm * wo).sum(-1, keepdims=True) < 0, -nrm, nrm).astype(np.float32)
    u3 = rng.random((n, 3)).astype(np.float32)
    pix = rng.integers(0, 512, (n, 2)).astype(np.int32)
    s = RenderSettings(radiance_clamp=50.0, nee_rr_threshold=rr)
    tp = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    jo = jpathtracer._nee_prepare(jscene, jnp.asarray(hp), jnp.asarray(nrm), jnp.asarray(wo), surf_j,
                                  jnp.asarray(u3), jrng.Sampler.from_pixels(jnp.asarray(pix), 3), s,
                                  throughput=jnp.asarray(tp))
    to = tpathtracer._nee_prepare(tscene, torch.from_numpy(hp), torch.from_numpy(nrm), torch.from_numpy(wo),
                                  surf_t, torch.from_numpy(u3), trng.Sampler.from_pixels(torch.from_numpy(pix), 3), s,
                                  throughput=torch.from_numpy(tp))
    assert to[5].index == int(jo[5].index)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))  # pre_ok
    for k, name in ((0, "shadow_o"), (1, "shadow_d"), (2, "t_shadow"), (4, "contrib")):
        agree = _lanes_agree(jo[k], to[k])
        assert agree.mean() >= 0.999, (name, agree.mean())


def test_postprocess_env_fill(atrium):
    # Background pixels take the sky texel along the view ray, then AgX.
    jscene, tscene = atrium
    rng = np.random.default_rng(6)
    light = rng.lognormal(0.0, 0.5, (24, 32, 3)).astype(np.float32)
    depth = np.where(rng.random((24, 32)) < 0.3, 1e5, 3.0).astype(np.float32)
    dirs = _dirs(24 * 32, 7).reshape(24, 32, 3)
    ref = jpostprocess.postprocess(jnp.asarray(light), jnp.asarray(depth), jnp.asarray(dirs), jscene.env_map)
    got = tpostprocess.postprocess(torch.from_numpy(light), torch.from_numpy(depth), torch.from_numpy(dirs),
                                   tscene.env_map)
    agree = _lanes_agree(np.asarray(ref).reshape(-1, 3), got.reshape(-1, 3))
    assert agree.mean() >= 0.99  # the rest sit on a texel edge of the sky
