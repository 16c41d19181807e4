"""The port's LBVH and wide-BVH traversal (``raytracer3_tpu_torch/ops/
traverse.py``, ``ops/wide_bvh.wbvh_intersect``) against the JAX reference's
on the same tables and rays (numpy-seeded).

Tolerance: hit masks equal; t within rtol 1e-5 + atol 1e-7 (XLA contracts
the reference's dot products into FMAs, so t parts by a few ulps of the
O(1) terms: relative far from the ray's origin, absolute near it); prim ids
equal except on ties by the oracle rule (two triangles hit at the same t
within that tolerance, where the FMA ulp decides which one the ``t <
best`` test keeps: at most max(2, n/100) rays); uv within 1e-5 absolute
where the prims agree. Occlusion masks equal. The reference's own edges
are held exactly on a hand-built chain that needs 100 stack entries: pushes
past ``STACK_DEPTH = 64`` drop, pops above it read the top entry, so the
rays aimed at the deep triangles miss in both. ``World.backend("bvh")`` is
held to the reference's ``World.backend("bvh")``. ~40 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import bvh as jbvh
from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import traverse as jtraverse
from raytracer3_tpu.ops import wide_bvh as jwide
from raytracer3_tpu_torch.ops import bvh as tbvh
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import traverse as ttraverse
from raytracer3_tpu_torch.ops import wide_bvh as twide

from test_torch_bvh import random_tris
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def random_rays(seed, n, spread=4.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def assert_hits_match(got, ref):
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-7)
    same = got.prim_id.numpy() == np.asarray(ref.prim_id)
    # A differing prim is a tie: both hit, at t equal within the tolerance
    # just checked.
    assert got.hit.numpy()[~same].all() and (~same).sum() <= max(2, len(same) // 100), (~same).sum()
    np.testing.assert_allclose(got.uv.numpy()[same], np.asarray(ref.uv)[same], rtol=0, atol=1e-5)


def _lbvh_both(tris):
    jt = tuple(jnp.asarray(v) for v in tris)
    tt = tuple(torch.from_numpy(np.array(v, np.float32)) for v in tris)
    return jt, jbvh.build_lbvh(*jt), tt, tbvh.build_lbvh(*tt)


@pytest.mark.parametrize("t,n", [(8, 64), (128, 128)])
def test_matches_reference(t, n):
    tris = random_tris(t + n, t)
    o, d = random_rays(t * n, n)
    jt, jb, tt, tb = _lbvh_both(tris)
    got = ttraverse.bvh_intersect(tb, *tt, torch.from_numpy(o), torch.from_numpy(d))
    assert_hits_match(got, jtraverse.bvh_intersect(jb, *jt, o, d))
    # ...and the brute-force oracle (tests/test_bvh.py's check).
    hb = tintersect.intersect_bruteforce(torch.from_numpy(o), torch.from_numpy(d), *tt)
    np.testing.assert_array_equal(got.hit.numpy(), hb.hit.numpy())


def test_cornell_scene():
    from raytracer3_tpu.scene import analytic as janalytic

    tris = tuple(np.asarray(v) for v in janalytic.cornell_box().tri_vertices())
    o, d = random_rays(9, 256, spread=0.9)
    jt, jb, tt, tb = _lbvh_both(tris)
    assert_hits_match(ttraverse.bvh_intersect(tb, *tt, torch.from_numpy(o), torch.from_numpy(d)),
                      jtraverse.bvh_intersect(jb, *jt, o, d))


def test_occlusion_matches_reference():
    tris = random_tris(2, 64)
    o, d = random_rays(3, 128)
    jt, jb, tt, tb = _lbvh_both(tris)
    for tmax in (0.5, 3.0, 100.0):
        want = np.asarray(jtraverse.bvh_occluded(jb, *jt, o, d, t_max=tmax))
        got = ttraverse.bvh_occluded(tb, *tt, torch.from_numpy(o), torch.from_numpy(d), t_max=tmax)
        np.testing.assert_array_equal(got.numpy(), want)
        ob = tintersect.occluded_bruteforce(torch.from_numpy(o), torch.from_numpy(d), *tt, t_max=tmax)
        np.testing.assert_array_equal(got.numpy(), ob.numpy())


def test_per_ray_tmax():
    tris = random_tris(4, 32)
    o, d = random_rays(5, 64)
    tmax = np.random.default_rng(6).uniform(0.1, 5.0, 64).astype(np.float32)
    jt, jb, tt, tb = _lbvh_both(tris)
    want = np.asarray(jtraverse.bvh_occluded(jb, *jt, o, d, t_max=jnp.asarray(tmax)))
    got = ttraverse.bvh_occluded(tb, *tt, torch.from_numpy(o), torch.from_numpy(d), t_max=torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.numpy(), want)


def test_matches_jitted_reference():
    # tests/test_bvh.py's test_traversal_jits: the reference's jitted query.
    tris = random_tris(7, 16)
    o, d = random_rays(8, 32)
    jt, jb, tt, tb = _lbvh_both(tris)
    f = jax.jit(lambda o, d: jtraverse.bvh_intersect(jb, *jt, o, d))
    assert_hits_match(ttraverse.bvh_intersect(tb, *tt, torch.from_numpy(o), torch.from_numpy(d)), f(o, d))


def _deep_chain(t=100):
    """A binary chain whose every internal box is entered before its leaf's,
    so a ray along +x pushes one leaf per level: leaf k holds a small
    triangle in the plane x = k + 0.55 around y = k/2 - 25."""
    ni = t - 1
    node_min = np.zeros((2 * t - 1, 3), np.float32)
    node_max = np.zeros((2 * t - 1, 3), np.float32)
    node_min[:ni] = (-0.5, -30.0, -30.0)
    node_max[:ni] = (t + 1.0, 30.0, 30.0)
    k = np.arange(t, dtype=np.float32)
    node_min[ni:] = np.stack([k + 0.5, np.full(t, -30.0), np.full(t, -30.0)], -1)
    node_max[ni:] = np.stack([k + 0.6, np.full(t, 30.0), np.full(t, 30.0)], -1)
    left = (ni + np.arange(ni)).astype(np.int32)
    right = np.arange(1, t).astype(np.int32)
    right[-1] = 2 * t - 2
    tables = (node_min, node_max, left, right, np.arange(t, dtype=np.int32))
    x, y = k + 0.55, k * 0.5 - 25.0
    z = np.zeros(t, np.float32)
    tris = (np.stack([x, y - 0.1, z - 1], -1), np.stack([x, y + 0.1, z - 1], -1), np.stack([x, y, z + 1], -1))
    o = np.stack([np.full(t, -1.0), y, z], -1).astype(np.float32)
    d = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (t, 1))
    return tables, tuple(v.astype(np.float32) for v in tris), o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_stack_overflow_keeps_the_reference_semantics(any_hit):
    tables, tris, o, d = _deep_chain()
    jb = jbvh.BVH(*(jnp.asarray(a) for a in tables))
    tb = tbvh.BVH(*(torch.from_numpy(a) for a in tables))
    want = jtraverse.bvh_intersect(jb, *(jnp.asarray(v) for v in tris), o, d, any_hit=any_hit)
    got = ttraverse.bvh_intersect(tb, *(torch.from_numpy(v) for v in tris), torch.from_numpy(o),
                                  torch.from_numpy(d), any_hit=any_hit)
    assert_hits_match(got, want)
    # The chain needs 100 entries; the leaves pushed past 64 are dropped, so
    # the rays aimed at them miss, and the ones aimed at the first leaves hit.
    hit = got.hit.numpy()
    assert hit[:60].all() and not hit[70:].any()


@pytest.mark.parametrize("t,n", [(16, 64), (200, 128)])
def test_wbvh_matches_reference(t, n):
    tris = random_tris(t + n, t)
    o, d = random_rays(t * n + 1, n)
    jw = jwide.build_wide(*(jnp.asarray(v) for v in tris), leaf_size=4)
    tw = twide.build_wide(*(torch.from_numpy(v) for v in tris), leaf_size=4)
    assert_hits_match(twide.wbvh_intersect(tw, torch.from_numpy(o), torch.from_numpy(d)),
                      jwide.wbvh_intersect(jw, o, d))


def test_wbvh_cornell_and_atrium():
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu.scene import procedural as jprocedural
    from raytracer3_tpu.scene import types as jtypes

    for scene, spread in ((janalytic.cornell_box(), 0.9), (jtypes.make_scene(**jprocedural.atrium(detail=1)), 6.0)):
        tris = tuple(np.array(v) for v in scene.tri_vertices())
        o, d = random_rays(4, 128, spread=spread)
        jw = jwide.build_wide(*(jnp.asarray(v) for v in tris), leaf_size=4)
        tw = twide.build_wide(*(torch.from_numpy(v) for v in tris), leaf_size=4)
        assert_hits_match(twide.wbvh_intersect(tw, torch.from_numpy(o), torch.from_numpy(d)),
                          jwide.wbvh_intersect(jw, o, d))


def test_wbvh_occlusion():
    tris = random_tris(5, 64)
    o, d = random_rays(6, 128)
    jw = jwide.build_wide(*(jnp.asarray(v) for v in tris), leaf_size=4)
    tw = twide.build_wide(*(torch.from_numpy(v) for v in tris), leaf_size=4)
    for tmax in (0.5, 5.0):
        want = np.asarray(jwide.wbvh_intersect(jw, o, d, t_max=tmax, any_hit=True).hit)
        got = twide.wbvh_intersect(tw, torch.from_numpy(o), torch.from_numpy(d), t_max=tmax, any_hit=True).hit
        np.testing.assert_array_equal(got.numpy(), want)


def test_backends_over_a_scene():
    # make_bvh_backend and make_wide_backend over the Cornell scene on the CPU.
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu_torch.scene import analytic as tanalytic

    o, d = random_rays(11, 256, spread=0.9)
    ti, to, tb = ttraverse.make_bvh_backend(tanalytic.cornell_box(device="cpu"))
    ji, jo, jb = jtraverse.make_bvh_backend(janalytic.cornell_box())
    for name in tbvh.BVH._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    assert_hits_match(ti(torch.from_numpy(o), torch.from_numpy(d)), ji(o, d))
    tmax = np.full(256, 0.7, np.float32)
    np.testing.assert_array_equal(to(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)).numpy(),
                                  np.asarray(jo(o, d, jnp.asarray(tmax))))
    wi, wo, _ = twide.make_wide_backend(tanalytic.cornell_box(device="cpu"))
    ji, jo, _ = jwide.make_wide_backend(janalytic.cornell_box())
    assert_hits_match(wi(torch.from_numpy(o), torch.from_numpy(d)), ji(o, d))


def test_world_backend_bvh():
    # World.backend("bvh") on the CPU: the LBVH over the padded scene, as
    # the reference's World builds it.
    from raytracer3_tpu.app import world as jworld
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu_torch.app import world as tworld

    sc = janalytic.cornell_box()
    mats = [tuple(np.asarray(getattr(sc.materials, k))[i] for k in ("base_color", "emission", "metallic", "roughness"))
            for i in range(len(np.asarray(sc.materials.base_color)))]
    parts = tuple(np.asarray(getattr(sc, k)) for k in ("positions", "normals", "uvs", "indices", "geo_id"))
    worlds = []
    for mod in (jworld, tworld):
        w = mod.World()
        for m in mats:
            w.add_material(*m)
        w.spawn(w.add_mesh(*parts))
        worlds.append(w)
    ji, jo = worlds[0].backend("bvh")
    ti, to = worlds[1].backend("bvh", device="cpu")
    assert worlds[1].backend("bvh", device="cpu")[0] is ti  # cached on the scene
    o, d = random_rays(21, 512, spread=0.8)
    assert_hits_match(ti(torch.from_numpy(o), torch.from_numpy(d)), ji(o, d))
    tmax = np.full(512, 0.5, np.float32)
    np.testing.assert_array_equal(to(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)).numpy(),
                                  np.asarray(jo(o, d, jnp.asarray(tmax))))


@pytest.mark.gpu
def test_lbvh_on_card():
    """The card's LBVH tables bit-equal to the CPU's, and its hits to the
    CPU's on the same rays (prim ids equal, t within rtol 1e-5 + atol 1e-7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    tris = random_tris(31, 5000)
    o, d = random_rays(32, 4096)
    cpu = tbvh.build_lbvh(*(torch.from_numpy(v) for v in tris))
    cuda_tris = tuple(torch.from_numpy(v).cuda() for v in tris)
    card = tbvh.build_lbvh(*cuda_tris)
    for name in tbvh.BVH._fields:
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(), getattr(cpu, name).numpy())
    got = ttraverse.bvh_intersect(card, *cuda_tris, torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda())
    want = ttraverse.bvh_intersect(cpu, *(torch.from_numpy(v) for v in tris), torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.prim_id.cpu().numpy(), want.prim_id.numpy())
    np.testing.assert_allclose(got.t.cpu().numpy(), want.t.numpy(), rtol=1e-5, atol=1e-7)
