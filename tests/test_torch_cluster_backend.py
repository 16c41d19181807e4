"""The port's cluster-BVH traversal (``raytracer3_tpu_torch/ops/
cluster_bvh.py``: ``cbvh_intersect``, ``cluster_backend``,
``make_cluster_backend``) against the JAX reference's ``cbvh_intersect`` on
the same tables (the reference's build, numpy, handed to both packages), on
the cases of ``tests/test_cluster_bvh.py``.

Tolerance: hit masks equal; t within rtol 1e-5 + atol 1e-7 (XLA contracts
the reference's Möller–Trumbore products into FMAs, as in the LBVH tests);
prim ids equal except on exact-t ties (at most max(2, n/100) rays, both
hit); uv within 1e-5 where the prims agree; occlusion masks equal. The
reference's stack edge is held exactly on a hand-built 8-wide chain whose
true need (57 entries) is past the 32 its depth field sizes: the dropped
pushes cut the walk short in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import cluster_bvh as jcluster
from raytracer3_tpu_torch.ops import cluster_bvh as tcluster
from raytracer3_tpu_torch.ops import intersect as tintersect

from test_torch_bvh import random_tris
from test_torch_lbvh_traverse import assert_hits_match, random_rays
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's cluster build reaches its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _both(tris, leaf_size):
    """The reference's tables over numpy triangles, as both packages'
    ClusterBVH."""
    jcb = jcluster.build_cluster_bvh(*(jnp.asarray(v) for v in tris), leaf_size=leaf_size)
    tcb = tcluster.ClusterBVH(
        node_table=torch.from_numpy(np.array(jcb.node_table)), cluster_table=torch.from_numpy(np.array(jcb.cluster_table)),
        tri_id=torch.from_numpy(np.array(jcb.tri_id)), leaf_size=jcb.leaf_size, num_nodes=jcb.num_nodes,
        num_clusters=jcb.num_clusters, width=jcb.width, depth=jcb.depth)
    return jcb, tcb._replace(boxes=tcluster.walk_boxes(tcb.node_table))


def _check(tris, o, d, leaf_size=8):
    jcb, tcb = _both(tris, leaf_size)
    got = tcluster.cbvh_intersect(tcb, torch.from_numpy(o), torch.from_numpy(d))
    assert_hits_match(got, jcluster.cbvh_intersect(jcb, jnp.asarray(o), jnp.asarray(d)))
    # ...and the brute-force oracle (the reference test's check).
    hb = tintersect.intersect_bruteforce(torch.from_numpy(o), torch.from_numpy(d),
                                         *(torch.from_numpy(np.array(v, np.float32)) for v in tris))
    np.testing.assert_array_equal(got.hit.numpy(), hb.hit.numpy())
    m = hb.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[m], hb.t.numpy()[m], rtol=1e-4)
    return got


@pytest.mark.parametrize("t,n,ls", [(5, 32, 8), (64, 64, 4), (333, 128, 8)])
def test_matches_reference(t, n, ls):
    _check(random_tris(t + n, t), *random_rays(t * n + 5, n), leaf_size=ls)


def test_cornell():
    from raytracer3_tpu.scene import analytic as janalytic

    tris = tuple(np.asarray(v) for v in janalytic.cornell_box().tri_vertices())
    _check(tris, *random_rays(2, 256, spread=0.9))


def test_atrium():
    from raytracer3_tpu.scene import procedural as jprocedural
    from raytracer3_tpu.scene import types as jtypes

    scene = jtypes.make_scene(**jprocedural.atrium(detail=1))
    tris = tuple(np.asarray(v) for v in scene.tri_vertices())
    got = _check(tris, *random_rays(3, 128, spread=6.0))
    assert bool(got.hit.any())


@pytest.mark.parametrize("tmax", [0.5, 5.0])
def test_occlusion(tmax):
    tris = random_tris(4, 100)
    o, d = random_rays(5, 128)
    jcb, tcb = _both(tris, 8)
    got = tcluster.cbvh_intersect(tcb, torch.from_numpy(o), torch.from_numpy(d), t_max=tmax, any_hit=True).hit
    want = np.asarray(jcluster.cbvh_intersect(jcb, jnp.asarray(o), jnp.asarray(d), t_max=tmax, any_hit=True).hit)
    np.testing.assert_array_equal(got.numpy(), want)
    ob = tintersect.occluded_bruteforce(torch.from_numpy(o), torch.from_numpy(d),
                                        *(torch.from_numpy(v) for v in tris), t_max=tmax)
    np.testing.assert_array_equal(got.numpy(), ob.numpy())


def test_per_ray_tmax_and_jitted_reference():
    # tests/test_cluster_bvh.py's test_jits: the reference's jitted query,
    # here with a per-ray cap.
    tris = random_tris(6, 64)
    o, d = random_rays(7, 64)
    tmax = np.random.default_rng(8).uniform(0.1, 5.0, 64).astype(np.float32)
    jcb, tcb = _both(tris, 8)
    f = jax.jit(lambda o, d, t: jcluster.cbvh_intersect(jcb, o, d, t_max=t))
    got = tcluster.cbvh_intersect(tcb, torch.from_numpy(o), torch.from_numpy(d), t_max=torch.from_numpy(tmax))
    assert_hits_match(got, f(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))


def _chain(levels: int):
    """An 8-wide chain: node i holds 7 one-triangle leaf clusters and node
    i + 1 in its last slot (the last node: an empty slot). Every box holds
    the whole scene, so every child is entered; leaf cluster c's triangle
    is a wide one in the plane z = 10 - 0.1·c, so the deepest is nearest
    to rays along +z. Its true stack need is 1 + 7·levels."""
    m, c = levels, 7 * levels
    nt = np.zeros((m, 64), np.float32)
    nt[:, 0:24] = -100.0
    nt[:, 24:48] = 100.0
    for i in range(m):
        nt[i, 48:55] = [-(7 * i + s) - 2.0 for s in range(7)]
        nt[i, 55] = float(i + 1) if i + 1 < m else -1.0
    ct = np.zeros((c, 128), np.float32)
    for k in range(c):
        z = 10.0 - 0.1 * k
        ct[k, 0:9] = [-50.0, -50.0, z, 200.0, 0.0, 0.0, 0.0, 200.0, 0.0]  # v0, e1, e2
    tid = np.arange(c, dtype=np.int32)[:, None]
    meta = dict(leaf_size=1, num_nodes=m, num_clusters=c, width=8, depth=1)  # depth 1: a 32-entry stack
    jcb = jcluster.ClusterBVH(node_table=jnp.asarray(nt), cluster_table=jnp.asarray(ct), tri_id=jnp.asarray(tid),
                              **meta)
    tcb = tcluster.ClusterBVH(node_table=torch.from_numpy(nt), cluster_table=torch.from_numpy(ct),
                              tri_id=torch.from_numpy(tid), boxes=tcluster.walk_boxes(torch.from_numpy(nt)), **meta)
    return jcb, tcb


def test_stack_overflow_keeps_the_reference_semantics():
    """57 entries needed, 32 held: both walks drop the same pushes, so the
    rays stop at the same (not the nearest) triangle."""
    jcb, tcb = _chain(8)
    rng = np.random.default_rng(9)
    o = np.concatenate([rng.uniform(-1, 1, (16, 2)), np.full((16, 1), -5.0)], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (16, 1))
    got = tcluster.cbvh_intersect(tcb, torch.from_numpy(o), torch.from_numpy(d))
    want = jcluster.cbvh_intersect(jcb, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(want.prim_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    assert got.hit.all() and (got.prim_id.numpy() < 7 * 8 - 1).all()  # not the deepest triangle


def test_backends_against_brute_force():
    tris = random_tris(10, 200)
    o, d = (torch.from_numpy(a) for a in random_rays(11, 256))
    tt = tuple(torch.from_numpy(v) for v in tris)
    want = tintersect.intersect_bruteforce(o, d, *tt)
    tmax = torch.full((o.shape[0],), 1.5)
    occ = tintersect.occluded_bruteforce(o, d, *tt, t_max=tmax)
    tb = tcluster.cluster_backend(host_tris=tris, device="cpu")
    isect, occl, cb = tcluster.make_cluster_backend(host_tris=tris, device="cpu")
    assert cb.num_clusters == tb.meta.num_clusters and sorted(tb.arrays) == ["boxes", "clusters", "nodes", "tids"]
    for i_fn, o_fn in ((tb.intersect, tb.occluded), (isect, occl)):
        h = i_fn(o, d)
        np.testing.assert_array_equal(h.hit.numpy(), want.hit.numpy())
        np.testing.assert_allclose(h.t.numpy(), want.t.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(o_fn(o, d, tmax).numpy(), occ.numpy())
    # The backend's tables are the reference's build, bit for bit.
    jtb = jcluster.cluster_backend(host_tris=tris)
    for k in ("nodes", "clusters", "tids"):
        np.testing.assert_array_equal(tb.arrays[k].numpy(), np.asarray(jtb.arrays[k]), err_msg=k)


def test_world_cluster_kind_matches_the_reference_world():
    """``World.trace_backend("cluster")`` and ``World.backend("cluster")`` of
    the port against the reference's ``World`` on the Cornell box."""
    from raytracer3_tpu.app import world as jworld
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu_torch.app import world as tworld

    sc = janalytic.cornell_box()
    mesh = tuple(np.asarray(getattr(sc, k)) for k in ("positions", "normals", "uvs", "indices", "geo_id"))
    worlds = []
    for W in (jworld.World, tworld.World):
        w = W()
        for i in range(np.asarray(sc.materials.base_color).shape[0]):
            w.add_material(*(list(np.asarray(getattr(sc.materials, k)))[i]
                             for k in ("base_color", "emission", "metallic", "roughness")))
        w.spawn(w.add_mesh(*mesh))
        worlds.append(w)
    jw, tw = worlds
    jw.scene()
    o, d = random_rays(12, 256, spread=0.8)
    want = jw.trace_backend("cluster").intersect(jnp.asarray(o), jnp.asarray(d))
    assert_hits_match(tw.trace_backend("cluster", device="cpu").intersect(torch.from_numpy(o), torch.from_numpy(d)),
                      want)
    ji, jo = jw.backend("cluster")
    ti, to = tw.backend("cluster", device="cpu")
    assert_hits_match(ti(torch.from_numpy(o), torch.from_numpy(d)), ji(jnp.asarray(o), jnp.asarray(d)))
    tmax = np.full((256,), 0.7, np.float32)
    np.testing.assert_array_equal(to(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)).numpy(),
                                  np.asarray(jo(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))))
