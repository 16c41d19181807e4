"""The port's native mesh entry points (``raytracer3_tpu_torch/native.py``)
against the reference's (``raytracer3_tpu/native.py``), both over
``native/rt3native.cpp`` (the port's build in ``build/native/``, the
reference's in ``native/``, loaded through tests/reference_native.py).

Mirrors tests/test_native.py's eleven cases: each port output must equal
the reference's on the same numpy-seeded inputs, bit for bit, and pass the
reference test's own checks. ``split_budget=0.3`` (spatial splits) in
``build_cluster_bvh_host`` and ``build_treelets_host`` gives tables
bit-equal to the reference's, and the default 0.0 leaves them as they
were. ~10 s alone.
"""

import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu_torch import native as tnative
from raytracer3_tpu_torch.ops import bvh as tbvh

from test_torch_bvh import random_tris
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(scope="module")
def jnative():
    reference_native.load()
    from raytracer3_tpu import native

    return native


def make_grid_mesh(n=16):
    """Shared-vertex grid: (n+1)^2 verts, 2n^2 tris."""
    xs, ys = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros((n + 1) ** 2)], -1).astype(np.float32)
    tris = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b, c = a + 1, a + (n + 1)
            tris += [[a, b, c + 1], [a, c + 1, c]]
    return verts, np.asarray(tris, np.int32)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_available(jnative):
    assert tnative.available() and jnative.available()


def test_weld_dedup(jnative):
    attrs = np.asarray([[0, 0, 0], [1, 1, 1], [0, 0, 0], [2, 2, 2], [1, 1, 1]], np.float32)
    remap, n = tnative.weld_vertices(attrs)
    assert n == 3
    np.testing.assert_array_equal(remap, [0, 1, 0, 2, 1])
    assert_same((remap, n), jnative.weld_vertices(attrs))


def test_cache_optim_improves_acmr_on_shuffled_grid(jnative):
    verts, tris = make_grid_mesh(24)
    shuffled = tris[np.random.default_rng(0).permutation(len(tris))]
    acmr_before = tnative.analyze_cache(shuffled, len(verts), 16)
    opt = tnative.optimize_vertex_cache(shuffled, len(verts))
    acmr_after = tnative.analyze_cache(opt, len(verts), 16)
    assert sorted(map(tuple, np.sort(opt, axis=1).tolist())) == sorted(map(tuple, np.sort(tris, axis=1).tolist()))
    assert acmr_after[0] < acmr_before[0] * 0.75
    assert_same(opt, jnative.optimize_vertex_cache(shuffled, len(verts)))
    assert_same(acmr_before, jnative.analyze_cache(shuffled, len(verts), 16))
    assert_same(acmr_after, jnative.analyze_cache(opt, len(verts), 16))


def test_fetch_reorder_is_permutation(jnative):
    verts, tris = make_grid_mesh(8)
    new_idx, remap = tnative.optimize_vertex_fetch(tris, len(verts))
    assert sorted(remap.tolist()) == list(range(len(verts)))
    np.testing.assert_array_equal(remap[tris], new_idx)
    assert_same((new_idx, remap), jnative.optimize_vertex_fetch(tris, len(verts)))


def test_position_roundtrip(jnative):
    pos = np.random.default_rng(1).uniform(-10, 30, (1000, 3)).astype(np.float32)
    q, sb = tnative.quantize_positions(pos)
    back = tnative.dequantize_positions(q, sb)
    assert np.abs(back - pos).max() < 40.0 / 16383.0
    assert_same((q, sb), jnative.quantize_positions(pos))
    assert_same(back, jnative.dequantize_positions(q, sb))


def test_normal_roundtrip(jnative):
    v = np.random.default_rng(2).normal(size=(1000, 3)).astype(np.float32)
    n = v / np.linalg.norm(v, axis=-1, keepdims=True)
    enc = tnative.encode_normals(n)
    back = tnative.decode_normals(enc)
    assert np.sum(back * n, axis=-1).min() > 0.99
    assert_same(enc, jnative.encode_normals(n))
    assert_same(back, jnative.decode_normals(enc))


def test_sah_structure_and_quality(jnative):
    rng = np.random.default_rng(3)
    c = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.3, (500, 3)).astype(np.float32)
    got = tnative.build_sah_bvh(c - h, c + h)
    tbvh.validate_bvh_host(got)
    assert_same(tuple(got), tuple(jnative.build_sah_bvh(c - h, c + h)))


def test_sah_traversal_matches_bruteforce():
    # The port's LBVH traversal over the native SAH tree.
    from raytracer3_tpu_torch.ops import intersect as tintersect
    from raytracer3_tpu_torch.ops import traverse as ttraverse

    tris = random_tris(0, 200)
    bmin = np.minimum(np.minimum(tris[0], tris[1]), tris[2])
    bmax = np.maximum(np.maximum(tris[0], tris[1]), tris[2])
    bvh = tbvh.BVH(*(torch.from_numpy(a) for a in tnative.build_sah_bvh(bmin, bmax)))
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(-4, 4, (128, 3)).astype(np.float32))
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tt = tuple(torch.from_numpy(v) for v in tris)
    hb = tintersect.intersect_bruteforce(o, d, *tt)
    ht = ttraverse.bvh_intersect(bvh, *tt, o, d)
    np.testing.assert_array_equal(ht.hit.numpy(), hb.hit.numpy())
    m = hb.hit.numpy()
    np.testing.assert_allclose(ht.t.numpy()[m], hb.t.numpy()[m], rtol=1e-5)


def test_clusters_partition_complete(jnative):
    c = np.random.default_rng(4).uniform(-5, 5, (777, 3)).astype(np.float32)
    cluster_of, cnt = tnative.build_clusters(c - 0.1, c + 0.1, 8)
    assert cluster_of.min() >= 0 and cluster_of.max() == cnt - 1
    assert np.bincount(cluster_of).max() <= 8
    assert_same((cluster_of, cnt), jnative.build_clusters(c - 0.1, c + 0.1, 8))


def test_simplify_grid_halves_with_zero_planar_error(jnative):
    verts, tris = make_grid_mesh(16)
    out, err = tnative.simplify(verts, tris, target_ratio=0.5)
    assert len(out) <= len(tris) * 0.5 + 2 and err < 1e-4
    assert out.min() >= 0 and out.max() < len(verts)
    assert (out[:, 0] != out[:, 1]).all() and (out[:, 1] != out[:, 2]).all() and (out[:, 0] != out[:, 2]).all()
    v0, v1, v2 = verts[out[:, 0]], verts[out[:, 1]], verts[out[:, 2]]
    assert 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1).sum() == pytest.approx(256.0, rel=1e-5)
    assert_same((out, err), jnative.simplify(verts, tris, target_ratio=0.5))


def test_simplify_border_vertices_locked(jnative):
    verts, tris = make_grid_mesh(8)
    out, err = tnative.simplify(verts, tris, target_ratio=0.2)
    used = set(np.unique(out).tolist())
    for corner in (0, 8, 9 * 8, 9 * 9 - 1):
        assert corner in used, f"border corner {corner} eroded"
    assert_same((out, err), jnative.simplify(verts, tris, target_ratio=0.2))


def test_simplify_max_error_budget_stops_early(jnative):
    verts, tris = make_grid_mesh(8)
    bumpy = verts.copy()
    bumpy[:, 2] = np.sin(bumpy[:, 0]) * np.sin(bumpy[:, 1]) * 2.0
    tight = tnative.simplify(bumpy, tris, 0.05, max_error=1e-8)
    loose = tnative.simplify(bumpy, tris, 0.05, max_error=0.0)
    assert len(tight[0]) > len(loose[0])
    assert_same(tight, jnative.simplify(bumpy, tris, 0.05, max_error=1e-8))
    assert_same(loose, jnative.simplify(bumpy, tris, 0.05, max_error=0.0))


def test_split_fragments(jnative):
    tris = random_tris(9, 300)
    got = tnative.split_fragments(*tris, budget=1.3)
    assert len(got[0]) > 300
    assert_same(got, jnative.split_fragments(*tris, budget=1.3))


@pytest.mark.parametrize("budget", [0.0, 0.3])
def test_split_budget_cluster_tables(jnative, budget):
    from raytracer3_tpu.ops import cluster_bvh as jcluster
    from raytracer3_tpu_torch.ops import cluster_bvh as tcluster

    tris = random_tris(10, 400)
    for width, mode in ((8, "median"), (16, "sah")):
        got = tcluster.build_cluster_bvh_host(*tris, 12, width=width, cluster_mode=mode, split_budget=budget)
        want = jcluster.build_cluster_bvh_host(*tris, 12, width=width, cluster_mode=mode, split_budget=budget)
        for name in ("node_table", "cluster_table", "tri_id"):
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
        assert (got.num_nodes, got.num_clusters, got.depth) == (want.num_nodes, want.num_clusters, want.depth)
    if budget:
        plain = tcluster.build_cluster_bvh_host(*tris, 12, width=16, cluster_mode="sah")
        assert got.num_clusters > plain.num_clusters  # the fragments were clustered


@pytest.mark.parametrize("budget", [0.0, 0.3])
def test_split_budget_treelet_tables(jnative, budget):
    from raytracer3_tpu.ops import treelets as jtreelets
    from raytracer3_tpu_torch.ops import treelets as ttreelets

    tris = random_tris(11, 600)
    got = ttreelets.build_treelets_host(*tris, 24, width=16, max_tris=256, cluster_mode="sah", split_budget=budget)
    want = jtreelets.build_treelets_host(*tris, 24, width=16, max_tris=256, cluster_mode="sah", split_budget=budget)
    for name in ("node_tables", "cluster_tables", "aabb"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
