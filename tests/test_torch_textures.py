"""Textures and the ray-cone mip level of the port (``scene/textures.py``,
the textured ``make_scene``, ``hit_surface_info`` and the wavefront's
footprint) against the JAX reference, on the same inputs (made from a seed
with numpy) on the CPU.

Tolerances, each with what this CPU measured:
- ``build_texture_atlas``, ``texel_density_log2``, the meta rows, the
  shade and material rows (mat lane 9: the float64 mean of the density,
  stored as float32) and the packed texel words: bit-equal.
- Tap indices of every mip level: bit-equal (uvs in [-3, 5]: floor-mod on
  negative and > 1 coordinates; lods in [-2, 12]: both clamps).
- Sampled colours: ``rtol 1e-6, atol 1e-7`` (measured ≤ 6e-8 absolute):
  the reference's ``unpack_rgb9e5`` is ≤ 1 ulp off on XLA's CPU, where
  the port's powers of two are exact (ROADMAP.md Queue 3).
- ``hit_surface_info``'s albedo: ``rtol 1e-6, atol 1e-7``; the other
  fields as ``tests/test_torch_scene.py`` holds them.
- Both textured goldens through the port's CPU path: the reference's own
  ``rtol 1e-5, atol 1e-5`` (measured ≤ 1.9e-6 on ``textured_mip_64_8f``,
  ≤ 5.1e-6 on ``textured_64_8f``).
- Textured wavefront frames against the reference's, every path: the
  rule of ``tests/test_torch_wavefront_extras.py`` (≥ 99% of pixels within
  1e-4, the summed difference within 1e-4 of the image's sum). Measured
  on frames 0 and 5: split, fused and tail-off ≤ 1.3e-6 (2.8e-7 of the
  sum); the lane diet ≤ 1.5e-5 on single values (3.6e-3 relative: one
  rgb9e5 rounding step of its packed state, flipped by a last-bit
  difference upstream), 1.9e-7 of the sum, so the diet is not held to the
  extras test's tighter diet bound.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import packing as jpacking
from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu.scene import textures as jtextures
from raytracer3_tpu.scene import types as jtypes
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.render import pathtracer as tpathtracer
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import analytic as tanalytic
from raytracer3_tpu_torch.scene import textures as ttextures
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-7


def _checker(h, w, a=0.0, b=1.0):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = ((xx + yy) % 2).astype(np.float32)
    img = np.where(c[:, :, None] > 0.5, b, a)
    return np.broadcast_to(img, (h, w, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed=0):
    """Non-square and non-power-of-two, square, a 2-D grey image, RGBA, and
    a strip whose chain reaches the last mip slot (level 10)."""
    rng = np.random.default_rng(seed)
    return [rng.random((37, 53, 3)).astype(np.float32) * 3.0, rng.random((64, 64, 3)).astype(np.float32),
            rng.random((16, 8)).astype(np.float32), rng.random((30, 100, 4)).astype(np.float32),
            rng.random((2, 1500, 3)).astype(np.float32)]


def _textured_atrium(colors=True, seed=0):
    """Atrium detail 1 with a seeded texture on each non-emissive material
    (the chip's sponza720_textured at a small size) and seeded vertex
    colours."""
    kw = jprocedural.atrium(detail=1)
    rng = np.random.default_rng(seed)
    sizes = [(32, 32)] * 6 + [(30, 40)]
    kw["tex_images"] = [rng.random((h, w, 3)).astype(np.float32) for h, w in sizes]
    kw["base_color_texture"] = np.asarray(list(range(7)) + [-1], np.int32)
    if colors:
        kw["colors"] = (0.5 + 0.5 * rng.random((len(kw["positions"]), 3))).astype(np.float32)
    kw["env_map"] = jprocedural.sky_equirect(16, 32)
    return kw


def _assert_fields_equal(got, ref, prefix=""):
    """Every field of the port's scene bit-equal to the reference's; the
    packed texel words, which the reference has not, equal the reference's
    pack of its texels."""
    for name in got._fields:
        g = getattr(got, name)
        if name == "tex_words":
            texels = ref.tex_atlas if ref.tex_atlas is not None else ref.textures
            if texels is None:
                assert g is None
            else:
                w = np.asarray(jpacking.pack_rgb9e5(texels.reshape(-1, 3)))
                np.testing.assert_array_equal(g.numpy(), w.view(np.int32))
            continue
        r = getattr(ref, name)
        if hasattr(g, "_fields"):
            _assert_fields_equal(g, r, prefix + name + ".")
            continue
        if g is None:
            assert r is None, prefix + name
            continue
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (prefix + name, g.dtype, r.dtype, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=prefix + name)


# --- the cases of tests/test_textures.py, on the port --------------------------


def test_atlas_packing_meta():
    imgs = [_checker(64, 64), np.full((32, 16, 3), 0.25, np.float32)]
    atlas, meta = ttextures.build_texture_atlas(imgs)
    assert atlas.shape[1] == 64 + 16
    assert meta.shape == (2, 16)
    assert meta[0, 2] == 64 and meta[0, 3] == 64
    assert meta[1, 2] == 16 and meta[1, 3] == 32
    assert meta[1, 0] == 64
    np.testing.assert_array_equal(atlas[:64, :64], imgs[0])


def test_mip_chain_averages_to_mean():
    mips = ttextures._mip_chain(_checker(64, 64))
    assert mips[-1].shape[:2] == (1, 1)
    np.testing.assert_allclose(mips[1], 0.5)
    np.testing.assert_allclose(mips[-1], 0.5)


def _sample(atlas, meta, tex_id, uv, lod=None, trilinear=True):
    words = ttextures.pack_texels(_t(atlas))
    return ttextures.sample_atlas(words, atlas.shape[1], _t(meta), _t(tex_id), _t(uv),
                                  None if lod is None else _t(lod), trilinear=trilinear).numpy()


def test_sample_level0_matches_texel():
    img = np.arange(16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3) / 768.0
    atlas, meta = ttextures.build_texture_atlas([img], nearest=[True])
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    uv = np.stack([(xx.ravel() + 0.5) / 16.0, (yy.ravel() + 0.5) / 16.0], axis=-1).astype(np.float32)
    out = _sample(atlas, meta, np.zeros(256, np.int32), uv, lod=np.zeros(256, np.float32), trilinear=False)
    # rgb9e5 taps: within max_channel · 2^-9 of the texel.
    ref = img.reshape(-1, 3)
    assert (np.abs(out - ref) <= ref.max(axis=1, keepdims=True) * 2.0 ** -9 + 1e-7).all()


def test_high_lod_converges_to_mean():
    atlas, meta = ttextures.build_texture_atlas([_checker(64, 64)])
    uv = np.random.default_rng(0).uniform(0, 1, (32, 2)).astype(np.float32)
    out = _sample(atlas, meta, np.zeros(32, np.int32), uv, lod=np.full(32, 10.0, np.float32))
    np.testing.assert_allclose(out, 0.5, atol=1e-3)


def test_negative_id_is_white():
    atlas, meta = ttextures.build_texture_atlas([_checker(8, 8)])
    out = _sample(atlas, meta, np.full(4, -1, np.int32), np.full((4, 2), 0.3, np.float32),
                  lod=np.zeros(4, np.float32))
    np.testing.assert_array_equal(out, 1.0)


def test_ray_cone_lod_monotonic_in_distance():
    t = np.asarray([0.1, 1.0, 10.0, 100.0], np.float32)
    args = (np.full(4, 1.0, np.float32), 1e-3, np.full(4, 6.0, np.float32))
    got = ttextures.ray_cone_lod(_t(t), *(_t(a) if isinstance(a, np.ndarray) else a for a in args)).numpy()
    assert (np.diff(got) > 0).all()
    ref = np.asarray(jtextures.ray_cone_lod(jnp.asarray(t), *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                                                for a in args)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_texel_density_scale_invariance():
    v0, v1, v2 = (np.array([p], np.float32) for p in ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
    uv0, uv1, uv2 = (np.array([p], np.float32) for p in ([0, 0], [1, 0], [0, 1]))
    d = ttextures.texel_density_log2(v0, v1, v2, uv0, uv1, uv2, 64, 64)
    np.testing.assert_allclose(d, 6.0, atol=1e-5)
    rng = np.random.default_rng(1)
    tri = [rng.normal(size=(100, 3)).astype(np.float32) for _ in range(3)]
    uvs = [rng.random((100, 2)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(ttextures.texel_density_log2(*tri, *uvs, 37.0, 53.0),
                                  jtextures.texel_density_log2(*tri, *uvs, 37.0, 53.0))


def test_hit_surface_info_mip_path():
    """A checker quad through the atlas: distant / grazing footprints read
    the checker mean, near ones stay binary."""
    quad_pos = np.array([[0, 0, 0], [10, 0, 0], [10, 0, 10], [0, 0, 10]], np.float32)
    quad_n = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    quad_uv = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    checker = np.kron(_checker(8, 8)[:, :, 0], np.ones((8, 8), np.float32))[:, :, None].repeat(3, axis=2)
    scene = ttypes.make_scene(
        positions=quad_pos, normals=quad_n, uvs=quad_uv, indices=idx, geo_id=np.zeros(2, np.int32),
        base_color=np.ones((1, 4), np.float32), emission=np.zeros((1, 3), np.float32),
        metallic=np.zeros(1, np.float32), roughness=np.ones(1, np.float32),
        base_color_texture=np.zeros(1, np.int32), tex_images=[checker], device="cpu")
    assert scene.tex_atlas is not None and scene.textures is None
    n = 64
    prim = torch.zeros(n, dtype=torch.int32)
    uv = _t(np.random.default_rng(0).uniform(0.05, 0.45, (n, 2)).astype(np.float32))
    near = ttypes.hit_surface_info(scene, prim, uv, footprint_log2=torch.full((n,), -12.0))
    far = ttypes.hit_surface_info(scene, prim, uv, footprint_log2=torch.full((n,), 4.0))
    a_near, a_far = near.albedo.numpy()[:, 0], far.albedo.numpy()[:, 0]
    assert a_near.std() > 0.2
    assert a_far.std() < 0.02
    np.testing.assert_allclose(a_far, 0.5, atol=0.05)


# --- against the reference ----------------------------------------------------


@pytest.mark.parametrize("case", ["non_square", "pow2", "grey_2d", "rgba_nearest", "eleven_mips"])
def test_build_texture_atlas_bit_equal(case):
    imgs = _images()
    pick = {"non_square": [0], "pow2": [1], "grey_2d": [2], "rgba_nearest": [3, 0, 2], "eleven_mips": [4, 1]}[case]
    images = [imgs[i] for i in pick]
    nearest = [True, False, True] if case == "rgba_nearest" else None
    ta, tm = ttextures.build_texture_atlas(images, nearest=nearest)
    ja, jm = jtextures.build_texture_atlas(images, nearest=nearest)
    assert ta.dtype == ja.dtype and tm.dtype == jm.dtype
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tm, jm)
    for got, ref in zip(ttextures._mip_chain(images[0]), jtextures._mip_chain(images[0])):
        np.testing.assert_array_equal(got, ref)


def _ref_taps(rows, uv, level, nearest, aw):
    """The reference's tap indices of one level (its ``_bilinear_level``)."""
    x0, y0, w, h = jtextures._level_params(rows, level)
    u = uv[:, 0] * w - 0.5
    v = uv[:, 1] * h - 0.5
    u_n = jnp.where(nearest, jnp.round(uv[:, 0] * w - 0.5), jnp.floor(u))
    v_n = jnp.where(nearest, jnp.round(uv[:, 1] * h - 0.5), jnp.floor(v))
    xi0 = jnp.mod(u_n, w).astype(jnp.int32) + x0.astype(jnp.int32)
    yi0 = jnp.mod(v_n, h).astype(jnp.int32) + y0.astype(jnp.int32)
    xi1 = jnp.mod(u_n + 1, w).astype(jnp.int32) + x0.astype(jnp.int32)
    yi1 = jnp.mod(v_n + 1, h).astype(jnp.int32) + y0.astype(jnp.int32)
    return [np.asarray(i) for i in (yi0 * aw + xi0, yi0 * aw + xi1, yi1 * aw + xi0, yi1 * aw + xi1)]


@pytest.fixture(scope="module")
def lanes():
    """4,096 seeded lanes over a five-texture atlas (two nearest)."""
    rng = np.random.default_rng(7)
    atlas, meta = jtextures.build_texture_atlas(_images(), nearest=[False, True, False, True, False])
    n = 4096
    return dict(atlas=atlas, meta=meta, tex_id=rng.integers(-1, 5, n).astype(np.int32),
                uv=rng.uniform(-3.0, 5.0, (n, 2)).astype(np.float32),
                lod=rng.uniform(-2.0, 12.0, n).astype(np.float32))


def test_pack_texels_bit_equal(lanes):
    ref = np.asarray(jpacking.pack_rgb9e5(jnp.asarray(lanes["atlas"]).reshape(-1, 3)))
    got = ttextures.pack_texels(_t(lanes["atlas"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))


def test_tap_indices_bit_equal(lanes):
    meta, tex_id, uv, lod = lanes["meta"], lanes["tex_id"], lanes["uv"], lanes["lod"]
    aw = lanes["atlas"].shape[1]
    rows = meta[np.maximum(tex_id, 0)]
    n_mips = rows[:, 4]
    lodc = np.minimum(np.maximum(lod, 0.0), n_mips - 1.0)
    l0 = np.floor(lodc).astype(np.int32)
    l1 = np.minimum(l0 + 1, np.maximum(n_mips.astype(np.int32) - 1, 0))
    nearest = rows[:, 5] > 0.5
    assert nearest.any() and (~nearest).any() and (l0 == 10).any() and (uv < 0).any() and (uv > 1).any()
    for level in (l0, l1, np.zeros_like(l0)):
        taps, fu, fv = ttextures.level_taps(_t(rows), _t(uv), _t(level), _t(nearest), aw)
        ref = _ref_taps(jnp.asarray(rows), jnp.asarray(uv), jnp.asarray(level), jnp.asarray(nearest), aw)
        for got, r in zip(taps, ref):
            np.testing.assert_array_equal(got.numpy(), r.astype(np.int64))
        assert (fu.numpy()[nearest] == 0).all() and (fv.numpy()[nearest] == 0).all()


@pytest.mark.parametrize("trilinear", [True, False])
@pytest.mark.parametrize("with_lod", [True, False])
def test_sample_atlas_matches_reference(lanes, trilinear, with_lod):
    lod = lanes["lod"] if with_lod else None
    got = _sample(lanes["atlas"], lanes["meta"], lanes["tex_id"], lanes["uv"], lod, trilinear)
    ref = np.asarray(jtextures.sample_atlas(
        jnp.asarray(lanes["atlas"]), jnp.asarray(lanes["meta"]), jnp.asarray(lanes["tex_id"]),
        jnp.asarray(lanes["uv"]), None if lod is None else jnp.asarray(lod), trilinear=trilinear))
    assert np.isfinite(got).all() and (got[lanes["tex_id"] < 0] == 1.0).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_sample_texture_array_matches_reference():
    rng = np.random.default_rng(3)
    textures = rng.random((3, 12, 20, 3)).astype(np.float32) * 2.0
    n = 4096
    tex_id = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-3.0, 5.0, (n, 2)).astype(np.float32)
    got = ttextures.sample_texture_array(ttextures.pack_texels(_t(textures)), textures.shape[:3], _t(tex_id),
                                         _t(uv)).numpy()
    ref = np.asarray(jtypes.sample_texture_array(jnp.asarray(textures), jnp.asarray(tex_id), jnp.asarray(uv)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["atlas_colors", "atlas", "legacy_array", "white_colors"])
def test_make_scene_bit_equal(kind):
    kw = _textured_atrium(colors=kind == "atlas_colors")
    if kind == "legacy_array":
        kw.pop("tex_images")
        kw["textures"] = np.random.default_rng(5).random((7, 8, 8, 3)).astype(np.float32)
    elif kind == "white_colors":
        kw["colors"] = np.ones((len(kw["positions"]), 3), np.float32)
    ref = jtypes.make_scene(**kw)
    got = ttypes.make_scene(**kw, device="cpu")
    _assert_fields_equal(got, ref)
    if kind.startswith("atlas"):
        mt = got.mat_table.numpy()
        assert (mt[:7, 9] != 0).all() and mt[7, 9] == 0  # the density of every textured material
        assert got.tex_meta.shape == (7, 16)
    assert got.shade_table.shape[1] == (32 if kind == "atlas_colors" else 16)
    # The reference's scene pulled as numpy gives the same port scene.
    _assert_fields_equal(ttypes.scene_from_numpy(ref._asdict(), "cpu"), ref)


@pytest.fixture(scope="module")
def textured_pair():
    kw = _textured_atrium()
    return jtypes.make_scene(**kw), ttypes.make_scene(**kw, device="cpu")


@pytest.mark.parametrize("footprint", [True, False])
def test_hit_surface_info_matches_reference(textured_pair, footprint):
    jscene, tscene = textured_pair
    rng = np.random.default_rng(11)
    n = 20000
    prim = rng.integers(-1, jscene.num_triangles, n).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    uv = np.where(uv.sum(-1, keepdims=True) > 1.0, 1.0 - uv, uv).astype(np.float32)
    fp = rng.uniform(-14.0, 4.0, n).astype(np.float32) if footprint else None
    js = jtypes.hit_surface_info(jscene, jnp.asarray(prim), jnp.asarray(uv),
                                 footprint_log2=None if fp is None else jnp.asarray(fp))
    ts = ttypes.hit_surface_info(tscene, _t(prim), _t(uv), footprint_log2=None if fp is None else _t(fp))
    np.testing.assert_allclose(ts.albedo.numpy(), np.asarray(js.albedo), rtol=RTOL, atol=ATOL)
    for field in ("emissive", "roughness", "metalness"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), err_msg=field)
    np.testing.assert_allclose(ts.normal.numpy(), np.asarray(js.normal), rtol=1e-6, atol=1e-6)
    # The texture and the colours both reach the albedo.
    plain = ttypes.hit_surface_info(tscene._replace(tex_atlas=None, tex_words=None), _t(prim), _t(uv))
    assert (np.abs(ts.albedo.numpy() - plain.albedo.numpy()) > 1e-3).mean() > 0.5


@pytest.mark.parametrize("name", ["textured_mip_64_8f", "textured_64_8f"])
def test_textured_golden(name):
    """The reference's goldens (``tools/regen_goldens.py``) through the
    port's CPU path: the mip atlas and the ray cone in the wavefront, the
    legacy texture array in the reference-mode tracer."""
    mip = name == "textured_mip_64_8f"
    scene, cam, s = tanalytic.textured_floor(mip, device="cpu")
    backend = tintersect.brute_backend(scene=scene, device="cpu")
    isect, occl = backend.bind(backend.arrays)
    render = twavefront.render_frame if mip else tpathtracer.render_image
    acc = sum(render(scene, cam, s, i, isect, occl) for i in range(8)) / 8
    golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npy"))
    np.testing.assert_allclose(acc.numpy(), golden, rtol=1e-5, atol=1e-5)


def _mip_pair():
    """The textured_mip golden's scene on both sides (the port's from its
    own arrays), with brute-force backends."""
    tscene, tcam, s = tanalytic.textured_floor(True, device="cpu")
    jscene = jtypes.make_scene(
        **{k: np.asarray(getattr(tscene, k)) for k in ("positions", "normals", "uvs", "indices", "geo_id")},
        **{k: np.asarray(getattr(tscene.materials, k)) for k in tscene.materials._fields},
        tex_images=[np.asarray(tscene.tex_atlas)[:32, :32]])
    jcam = jcamera.Camera(**{k: jnp.asarray(getattr(tcam, k).numpy()) for k in tcam._fields})
    return jscene, jcam, tscene, tcam, s


@pytest.mark.parametrize("option", ["split", "fused", "tail_off", "lane_diet"])
def test_textured_wavefront_options_match_reference(option):
    """The footprint on every wavefront path: split, fused shadow+bounce,
    tail-off and the lane diet, frame by frame against the reference."""
    jscene, jcam, tscene, tcam, s = _mip_pair()
    s = dataclasses.replace(s, width=24, height=24, lane_diet=option == "lane_diet",
                            fuse_shadow=option == "fused")
    kw = dict(tail_anyhit=option != "tail_off")
    jb, tb = jintersect.brute_backend(scene=jscene), tintersect.brute_backend(scene=tscene, device="cpu")
    ji, jo = jb.bind(jb.arrays)
    ti, to = tb.bind(tb.arrays)
    jf = jb.bind_capped(jb.arrays) if option == "fused" else None
    tf = tb.bind_capped(tb.arrays) if option == "fused" else None
    for fi in (0, 5):
        ref = np.asarray(jax.jit(lambda f: jwavefront.render_frame(jscene, jcam, s, f, ji, jo, fused_fn=jf, **kw))(
            jnp.uint32(fi)))
        got = twavefront.render_frame(tscene, tcam, s, fi, ti, to, fused_fn=tf, **kw).numpy()
        assert np.isfinite(got).all() and got.mean() > 0
        d = np.abs(got - ref)
        assert (d.max(-1) <= 1e-4).mean() >= 0.99
        assert d.sum() <= 1e-4 * np.abs(ref).sum()


@pytest.mark.gpu
def test_textured_mip_golden_through_k1k2_on_card():
    """The textured_mip golden through the packet backend's K1/K2 on the
    card: mean relative difference < 1e-3, ≥ 98% of pixels within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk

    scene, cam, s = tanalytic.textured_floor(True, device="cuda")
    backend = ttk.packet_backend(scene=scene, device="cuda")
    isect, occl = backend.bind(backend.arrays)
    before = dict(ttk.LAUNCHES)
    acc = sum(twavefront.render_frame(scene, cam, s, i, isect, occl) for i in range(8)) / 8
    launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.LAUNCHES}
    assert launched["closest"] + launched["closest_general"] > 0 and launched["any"] + launched["any_general"] > 0
    golden = np.load(os.path.join(REPO, "tests", "golden", "textured_mip_64_8f.npy"))
    d = np.abs(acc.cpu().numpy() - golden)
    assert d.sum() / np.abs(golden).sum() < 1e-3
    assert (d.max(-1) <= 1e-3).mean() >= 0.98
