"""The port's LBVH build (``raytracer3_tpu_torch/ops/bvh.py``) against the
JAX reference's (``raytracer3_tpu/ops/bvh.py``).

Mirrors tests/test_bvh.py's build cases on numpy-seeded triangles; every
table (``node_min/max``, ``node_left/right``, ``leaf_tri``) must be
bit-equal to the reference's, and the port's tree must pass the structural
check. Duplicate Morton codes take Karras's index tie-break: the
all-coincident pile and the padded triangles of a ``World`` scene (the
pool pads to a power of two with degenerate triangles at one point) both
exercise it. Also held here: ``_clz32`` against an exact count on every
bit length, and the wide collapse's and the cluster build's tables
(``build_wide``, ``build_cluster_bvh``, ``pack_tables``) against the reference's,
tests/test_wide_bvh.py's and tests/test_cluster_bvh.py's build cases.
~35 s alone (most of it the reference's jit of its builds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import bvh as jbvh
from raytracer3_tpu.ops import cluster_bvh as jcluster
from raytracer3_tpu.ops import wide_bvh as jwide
from raytracer3_tpu_torch.ops import bvh as tbvh
from raytracer3_tpu_torch.ops import cluster_bvh as tcluster
from raytracer3_tpu_torch.ops import wide_bvh as twide
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's cluster build reaches its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def random_tris(seed, t, spread=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    e1 = (rng.normal(size=(t, 3)) * 0.3).astype(np.float32)
    e2 = (rng.normal(size=(t, 3)) * 0.3).astype(np.float32)
    return base, base + e1, base + e2


def _both(tris):
    """The reference's and the port's LBVH over the same numpy triangles."""
    ref = jbvh.build_lbvh(*(jnp.asarray(v) for v in tris))
    port = tbvh.build_lbvh(*(torch.from_numpy(np.ascontiguousarray(v)) for v in tris))
    return ref, port


def assert_tables_equal(ref, port):
    for name in tbvh.BVH._fields:
        r, p = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert p.dtype == r.dtype, name
        np.testing.assert_array_equal(p, r, err_msg=name)


def _duplicate_codes(tris) -> int:
    """How many triangles share their Morton code with an earlier one."""
    tmin = np.minimum(np.minimum(tris[0], tris[1]), tris[2])
    tmax = np.maximum(np.maximum(tris[0], tris[1]), tris[2])
    from raytracer3_tpu_torch.ops import mathx

    c = (tmin + tmax) * 0.5
    lo, hi = tmin.min(0), tmax.max(0)
    codes = mathx.morton3d(torch.from_numpy((c - lo) / np.maximum(hi - lo, np.float32(1e-9)))).numpy()
    return len(codes) - len(np.unique(codes))


@pytest.mark.parametrize("t", [2, 3, 17, 128])
def test_structure_valid(t):
    ref, port = _both(random_tris(t, t))
    assert_tables_equal(ref, port)
    tbvh.validate_bvh_host(port)


def test_duplicate_positions():
    # All triangles at one place → one Morton code; the index tie-break must
    # still give the reference's tree.
    v0 = np.zeros((16, 3), np.float32)
    v1 = np.tile(np.asarray([0.1, 0.0, 0.0], np.float32), (16, 1))
    v2 = np.tile(np.asarray([0.0, 0.1, 0.0], np.float32), (16, 1))
    assert _duplicate_codes((v0, v1, v2)) == 15
    ref, port = _both((v0, v1, v2))
    assert_tables_equal(ref, port)
    tbvh.validate_bvh_host(port)


def test_root_covers_scene():
    tris = random_tris(0, 64)
    ref, port = _both(tris)
    assert_tables_equal(ref, port)
    smin = np.minimum(np.minimum(tris[0], tris[1]), tris[2]).min(0)
    smax = np.maximum(np.maximum(tris[0], tris[1]), tris[2]).max(0)
    np.testing.assert_array_equal(port.node_min[0].numpy(), smin)
    np.testing.assert_array_equal(port.node_max[0].numpy(), smax)


def test_build_matches_jitted_reference():
    # tests/test_bvh.py's test_build_jits: the reference's jitted build is
    # the one its backends use (build_lbvh_cached).
    tris = random_tris(1, 32)
    ref = jax.jit(jbvh.build_lbvh)(*(jnp.asarray(v) for v in tris))
    port = tbvh.build_lbvh(*(torch.from_numpy(v) for v in tris))
    assert_tables_equal(ref, port)
    tbvh.validate_bvh_host(port)


def test_aabb_build_and_many_duplicates():
    # build_lbvh_aabbs on boxes where half share one code, over ~1,000 prims.
    rng = np.random.default_rng(5)
    c = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    c[::2] = c[0]
    h = rng.uniform(0.01, 0.3, (1000, 3)).astype(np.float32)
    ref = jbvh.build_lbvh_aabbs(jnp.asarray(c - h), jnp.asarray(c + h))
    port = tbvh.build_lbvh_aabbs(torch.from_numpy(c - h), torch.from_numpy(c + h))
    assert_tables_equal(ref, port)
    tbvh.validate_bvh_host(port)


@pytest.mark.parametrize("mesh", ["cornell", "atrium1"])
def test_padded_world_scene(mesh):
    # A World scene's triangles: the pool pads them to a power of two with
    # degenerate triangles, which share one Morton code.
    from raytracer3_tpu.app import world as jworld
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu.scene import procedural as jprocedural
    from raytracer3_tpu_torch.app import world as tworld

    if mesh == "cornell":
        sc = janalytic.cornell_box()
        mats = [tuple(np.asarray(getattr(sc.materials, k))[i] for k in
                      ("base_color", "emission", "metallic", "roughness"))
                for i in range(len(np.asarray(sc.materials.base_color)))]
        parts = tuple(np.asarray(getattr(sc, k)) for k in ("positions", "normals", "uvs", "indices", "geo_id"))
    else:
        kw = jprocedural.atrium(detail=1)
        mats = [tuple(np.asarray(kw[k])[i] for k in ("base_color", "emission", "metallic", "roughness"))
                for i in range(len(kw["base_color"]))]
        parts = tuple(kw[k] for k in ("positions", "normals", "uvs", "indices", "geo_id"))
    worlds = []
    for mod in (jworld, tworld):
        w = mod.World()
        for m in mats:
            w.add_material(*m)
        w.spawn(w.add_mesh(*parts))
        worlds.append(w)
    jtris = worlds[0].scene().tri_vertices()
    ttris = worlds[1].scene(device="cpu").tri_vertices()
    for a, b in zip(jtris, ttris):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    host = tuple(np.asarray(a) for a in jtris)
    assert len(host[0]) > len(parts[3]) and _duplicate_codes(host) > 0
    ref = jbvh.build_lbvh(*jtris)
    port = tbvh.build_lbvh(*ttris)
    assert_tables_equal(ref, port)
    tbvh.validate_bvh_host(port)


def test_clz32_is_exact():
    x = torch.tensor([0] + [1 << b for b in range(32)] + [(1 << b) - 1 for b in range(2, 33)]
                     + [(1 << b) + 12345 for b in range(14, 32)], dtype=torch.int64)
    want = torch.tensor([32 if v == 0 else 32 - int(v).bit_length() for v in x.tolist()])
    np.testing.assert_array_equal(tbvh._clz32(x).numpy(), want.numpy())
    # ...and jax.lax.clz on the same uint32 words.
    np.testing.assert_array_equal(tbvh._clz32(x).numpy(), np.asarray(jax.lax.clz(jnp.asarray(x.numpy(), jnp.uint32))))


@pytest.mark.parametrize("t,leaf", [(2, 1), (9, 2), (64, 4), (257, 4)])
def test_build_wide_tables(t, leaf):
    # tests/test_wide_bvh.py's collapse cases: every table of build_wide,
    # the sorted triangles included, bit-equal to the reference's.
    tris = random_tris(t, t)
    ref = jwide.build_wide(*(jnp.asarray(v) for v in tris), leaf_size=leaf)
    port = twide.build_wide(*(torch.from_numpy(v) for v in tris), leaf_size=leaf)
    for name in jwide.WideBVH._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


def test_collapse_without_triangles_keeps_the_cluster_tables():
    # The cluster build's collapse takes no triangles: its WideBVH has none.
    tris = random_tris(3, 40)
    port = tbvh.build_lbvh(*(torch.from_numpy(v) for v in tris))
    wb = twide.collapse(tbvh.BVH(*(x.numpy() for x in port)), leaf_size=1)
    assert wb.tri_v0 is None and wb.tri_v1 is None and wb.tri_v2 is None
    ref = jwide.collapse(jbvh.build_lbvh(*(jnp.asarray(v) for v in tris)), *tris, leaf_size=1)
    for name in ("child_min", "child_max", "child_code", "tri_order"):
        np.testing.assert_array_equal(getattr(wb, name), np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("t,ls", [(5, 8), (16, 4), (100, 8), (300, 16)])
def test_build_cluster_bvh(t, ls):
    # tests/test_cluster_bvh.py's build cases, on the port's upload.
    tris = random_tris(t, t)
    ref = jcluster.build_cluster_bvh(*(jnp.asarray(v) for v in tris), leaf_size=ls)
    port = tcluster.build_cluster_bvh(*tris, leaf_size=ls, device="cpu")
    for name in ("node_table", "cluster_table", "tri_id"):
        got = getattr(port, name)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert (port.num_nodes, port.num_clusters, port.depth) == (ref.num_nodes, ref.num_clusters, ref.depth)
    ids = port.tri_id.numpy().ravel()
    real = ids[ids >= 0]
    assert len(real) == t and len(np.unique(real)) == t
    # pack_tables: the kernel's tables of the same build, uploaded.
    from raytracer3_tpu.ops.pallas import traverse_kernel as jtk
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk

    pt = ttk.pack_tables(tcluster.build_cluster_bvh_host(*tris, ls), device="cpu")
    jpt = jtk.pack_tables(jcluster.build_cluster_bvh_host(*tris, ls))
    for name in ("node_table", "cluster_table"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jpt, name)), err_msg=name)
