"""The oracle backends' kernels on the CPU: ``csrc/oracle_bvh.cu`` built with
g++ under ``csrc/host_shim.h`` (``oracle_kernels.load_host_kernels()``:
every thread of a launch run in turn) and held, with tolerance zero, to
the plain versions the CPU takes.

- Kernels A and B (``lbvh_topology_kernel``, ``lbvh_fit_kernel``) against
  ``build_lbvh_aabbs_plain``: every table bit-equal (floats compared as
  their bits, so a zero's sign and a NaN count) at T = 2, 3, 17 and 1,000,
  all centroids equal, half the codes shared, two ``World`` scenes' padded
  triangles (Cornell, atrium detail 1), boxes whose zeros carry both signs, and a NaN vertex (the
  plain fit now settles on a NaN box: it compares bits).
- Kernel C (``lbvh_walk_kernel``) against ``bvh_intersect_plain``, closest
  and any hit: rays from outside and inside the soup, per-ray ``t_max``,
  NaN rays and directions with zero components, and the 100-entry chain of
  ``test_torch_lbvh_traverse.py`` whose pushes past 64 drop.
- Kernel D (``cluster_walk_kernel``) against ``cbvh_intersect_plain``:
  leaf 8 and 4, rays that start inside every box (all child keys tie at
  t_min), and the 8-wide chain of ``test_torch_cluster_backend.py`` that
  overflows its 32-entry stack (its children's keys tie too).

Both sides do IEEE float32 arithmetic without contraction (g++
``-ffp-contract=off``, nvcc ``--fmad=false``), so t, u, v and ids are
compared bit for bit. Every case also meets the JAX reference on the same
arrays: the build's tables bit for bit (but the NaN vertex, where the
reference's fit never ends: its change flag compares values, and NaN !=
NaN), the walks by the LBVH and cluster tests' rule (``assert_hits_match``:
hit masks equal, t within rtol 1e-5 + atol 1e-7, ids equal but on exact-t
ties; for any hit the hit masks equal). Also here: a CPU tensor takes the plain version and
no launch is counted; the build's zeros take the reference's
``jnp.minimum``/``jnp.maximum`` rule (``ieee_minimum``), which
``torch.minimum`` does not keep; and, marked ``gpu``, kernels A-D on the
card against their plain versions on the card. ~15 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import bvh as jbvh
from raytracer3_tpu.ops import cluster_bvh as jcluster
from raytracer3_tpu.ops import traverse as jtraverse
from raytracer3_tpu_torch.ops import bvh as tbvh
from raytracer3_tpu_torch.ops import cluster_bvh as tcluster
from raytracer3_tpu_torch.ops import oracle_kernels as ok
from raytracer3_tpu_torch.ops import traverse as ttraverse
from raytracer3_tpu_torch.ops import traverse_kernel as ttk

from test_torch_bvh import random_tris
from test_torch_cluster_backend import _chain
from test_torch_lbvh_traverse import _deep_chain, assert_hits_match, random_rays
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(scope="module")
def host_lib():
    return ok.load_host_kernels()


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bits_equal(got, want, name=""):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(_bits(got), _bits(want)), name


def _boxes(tris):
    v0, v1, v2 = (torch.from_numpy(np.ascontiguousarray(v, np.float32)) for v in tris)
    return tbvh.ieee_minimum(tbvh.ieee_minimum(v0, v1), v2), tbvh.ieee_maximum(tbvh.ieee_maximum(v0, v1), v2)


def _kernel_build(lib, tri_min, tri_max) -> tbvh.BVH:
    order, codes = tbvh._sorted_codes(tri_min, tri_max)
    left, right, parent = ok.lbvh_topology(lib, codes, None)
    node_min, node_max = tbvh.unfitted_boxes(tri_min[order], tri_max[order])
    ok.lbvh_fit(lib, left, right, parent, node_min, node_max, None)
    want_parent = torch.full((2 * tri_min.shape[0] - 1,), -1, dtype=torch.int32)
    inner = torch.arange(tri_min.shape[0] - 1, dtype=torch.int32)
    want_parent[left.long()] = inner
    want_parent[right.long()] = inner
    assert_bits_equal(parent, want_parent, "parent")
    return tbvh.BVH(node_min, node_max, left, right, order.to(torch.int32))


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def _jax(x):
    return jnp.asarray(x.numpy())


def _jitted_reference(walk):
    """``walk(o, d, t_max, any_hit)`` jitted once for each ``any_hit``, with
    the caps always an [N] array (a scalar cap filled), so one compile
    serves every ray set of a case."""
    fns = {a: jax.jit(lambda o, d, t, a=a: walk(o, d, t, a)) for a in (False, True)}

    def run(o, d, t_max, any_hit):
        caps = ttraverse.t_caps(t_max, o.shape[0], o.device)
        return fns[any_hit](_jax(o), _jax(d), _jax(caps))

    return run


def _assert_build(lib, tri_min, tri_max, reference=True):
    got = _kernel_build(lib, tri_min, tri_max)
    want = tbvh.build_lbvh_aabbs_plain(tri_min, tri_max)
    ref = jax.jit(jbvh.build_lbvh_aabbs)(_jax(tri_min), _jax(tri_max)) if reference else None
    for name in tbvh.BVH._fields:
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
        if reference:
            assert_bits_equal(getattr(got, name), _torch(getattr(ref, name)), f"{name} (reference)")
    return got


def _atrium_world_tris():
    from raytracer3_tpu_torch.app import viewer as tviewer

    return tuple(v.numpy() for v in tviewer.atrium_world(1).scene(device="cpu").tri_vertices())


def _world_tris():
    from raytracer3_tpu_torch.app import world as tworld
    from raytracer3_tpu_torch.scene import analytic as tanalytic

    sc = tanalytic.cornell_box(device="cpu")
    w = tworld.World()
    for i in range(sc.materials.base_color.shape[0]):
        w.add_material(*(getattr(sc.materials, k)[i].numpy() for k in ("base_color", "emission", "metallic",
                                                                       "roughness")))
    w.spawn(w.add_mesh(*(getattr(sc, k).numpy() for k in ("positions", "normals", "uvs", "indices", "geo_id"))))
    return tuple(v.numpy() for v in w.scene(device="cpu").tri_vertices())


def _signed_zero_tris(t=40):
    """Triangles on the planes x = 0 and z = 0 whose zeros carry both signs,
    so that a parent's box takes -0 from one child and +0 from the other."""
    rng = np.random.default_rng(3)
    v = rng.uniform(0.1, 1.0, (3, t, 3)).astype(np.float32)
    v[:, :, 0] = np.where(rng.random((3, t)) < 0.5, np.float32(-0.0), np.float32(0.0))
    v[:, : t // 2, 2] = np.float32(-0.0)
    v[:, t // 2:, 2] = np.float32(0.0)
    return tuple(v)


def _nan_tris():
    tris = random_tris(13, 24)
    tris[1][5, 1] = np.nan
    return tris


BUILD_CASES = {
    "t2": lambda: random_tris(2, 2),
    "t3": lambda: random_tris(3, 3),
    "t17": lambda: random_tris(17, 17),
    "t1000": lambda: random_tris(1000, 1000),
    "one_centroid": lambda: (np.zeros((16, 3), np.float32), np.tile(np.float32([0.1, 0, 0]), (16, 1)),
                             np.tile(np.float32([0, 0.1, 0]), (16, 1))),
    "padded_world": _world_tris,
    "padded_world_atrium": _atrium_world_tris,
    "signed_zeros": _signed_zero_tris,
    "nan_vertex": _nan_tris,
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_kernels_equal_the_plain_build(host_lib, case):
    tri_min, tri_max = _boxes(BUILD_CASES[case]())
    got = _assert_build(host_lib, tri_min, tri_max, reference=case != "nan_vertex")
    if case != "nan_vertex":
        tbvh.validate_bvh_host(got)


def test_build_kernels_with_many_duplicate_codes(host_lib):
    # test_torch_bvh.py's box build: half the boxes share one centre.
    rng = np.random.default_rng(5)
    c = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    c[::2] = c[0]
    h = rng.uniform(0.01, 0.3, (1000, 3)).astype(np.float32)
    got = _assert_build(host_lib, torch.from_numpy(c - h), torch.from_numpy(c + h))
    tbvh.validate_bvh_host(got)


def test_the_build_keeps_the_reference_zeros():
    """The reference's boxes are ``jnp.minimum``/``jnp.maximum`` (-0 below
    +0); ``torch.minimum`` keeps whichever zero its vector lane gives, so a
    build on it could part from the reference's in a zero's sign. The
    port's boxes take ``ieee_minimum``/``ieee_maximum``: bit-equal to the
    reference's tables, signs of zeros included."""
    a = torch.tensor([0.0, -0.0, 1.0, float("nan"), -2.0])
    b = torch.tensor([-0.0, 0.0, float("nan"), 1.0, -0.0])
    for port, ref in ((tbvh.ieee_minimum, jnp.minimum), (tbvh.ieee_maximum, jnp.maximum)):
        want = torch.from_numpy(np.asarray(ref(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))).copy())
        got = port(a, b)
        assert torch.equal(torch.signbit(got), torch.signbit(want)) and torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    tris = _signed_zero_tris()
    ref = jbvh.build_lbvh(*(jnp.asarray(v) for v in tris))
    port = tbvh.build_lbvh(*(torch.from_numpy(v) for v in tris))
    for name in tbvh.BVH._fields:
        assert_bits_equal(getattr(port, name), torch.from_numpy(np.asarray(getattr(ref, name)).copy()), name)
    assert bool(torch.signbit(port.node_min[0, 0])) and not bool(torch.signbit(port.node_max[0, 2]))


def _hits_equal(got, want):
    for name in ("t", "uv", "prim_id", "hit"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)


def _meets_reference(got, ref, any_hit):
    """The walks' rule against the JAX reference: hit masks equal, and for
    the closest hit t, uv and ids as ``assert_hits_match`` holds them."""
    if any_hit:
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    else:
        assert_hits_match(got, ref)


def _lbvh_reference(bvh, tris):
    """The reference's LBVH walk over the same tables and triangles."""
    jb, jt = jbvh.BVH(*(_jax(x) for x in bvh)), tuple(_jax(v) for v in tris)
    return _jitted_reference(lambda o, d, t, a: jtraverse.bvh_intersect(jb, *jt, o, d, t_max=t, any_hit=a))


def _lbvh_walk(lib, bvh, tris, o, d, t_max, any_hit):
    n = o.shape[0]
    out = ok.lbvh_walk(lib, bvh, *tris, o, d, ttraverse.t_caps(t_max, n, o.device), 1e-4, any_hit, None)
    return ttraverse.finish(*out)


def _ray_sets(seed, n, spread):
    o, d = (torch.from_numpy(a) for a in random_rays(seed, n, spread))
    inside_o = torch.from_numpy(np.random.default_rng(seed + 1).uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    odd_d = d.clone()
    odd_d[::3, 0] = 0.0
    odd_d[1::3, 1:] = 0.0
    nan_o, nan_d = o.clone(), d.clone()
    nan_o[::4, 1] = float("nan")
    nan_d[2::4, 2] = float("nan")
    return {"outside": (o, d), "inside": (inside_o, d), "zero_components": (o, odd_d), "nan": (nan_o, nan_d)}


@pytest.mark.parametrize("any_hit", [False, True])
def test_lbvh_walk_kernel_equals_the_plain_walk(host_lib, any_hit):
    tris = tuple(torch.from_numpy(v) for v in random_tris(41, 300))
    bvh = tbvh.build_lbvh(*tris)
    n = 384
    caps = torch.from_numpy(np.random.default_rng(7).uniform(0.05, 6.0, n).astype(np.float32))
    reference = _lbvh_reference(bvh, tris)
    for name, (o, d) in _ray_sets(42, n, 4.0).items():
        for t_max in (1e30, caps):
            got = _lbvh_walk(host_lib, bvh, tris, o, d, t_max, any_hit)
            want = ttraverse.bvh_intersect_plain(bvh, *tris, o, d, t_max=t_max, any_hit=any_hit)
            _hits_equal(got, want)
            _meets_reference(got, reference(o, d, t_max, any_hit), any_hit)
            if name == "outside":
                assert bool(want.hit.any()) and not bool(want.hit.all())


@pytest.mark.parametrize("any_hit", [False, True])
def test_lbvh_walk_kernel_keeps_the_stack_edges(host_lib, any_hit):
    # 100 entries needed, 64 held: pushes past the top drop, pops above it
    # read the top entry; the rays aimed at the deep leaves miss in both.
    tables, tris, o, d = _deep_chain()
    bvh = tbvh.BVH(*(torch.from_numpy(a) for a in tables))
    tris = tuple(torch.from_numpy(v) for v in tris)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    got = _lbvh_walk(host_lib, bvh, tris, o, d, 1e30, any_hit)
    _hits_equal(got, ttraverse.bvh_intersect_plain(bvh, *tris, o, d, any_hit=any_hit))
    _meets_reference(got, _lbvh_reference(bvh, tris)(o, d, 1e30, any_hit), any_hit)
    assert bool(got.hit[:60].all()) and not bool(got.hit[70:].any())


def _cluster_walk(lib, cb, o, d, t_max, any_hit):
    out = ok.cluster_walk(lib, cb, cb.boxes, tcluster.stack_entries(cb), o, d,
                          ttraverse.t_caps(t_max, o.shape[0], o.device), 1e-4, any_hit, None)
    return ttraverse.finish(*out)


def _cluster_reference(cb):
    """The reference's cluster walk over the same tables."""
    jcb = jcluster.ClusterBVH(node_table=_jax(cb.node_table), cluster_table=_jax(cb.cluster_table),
                              tri_id=_jax(cb.tri_id), leaf_size=cb.leaf_size, num_nodes=cb.num_nodes,
                              num_clusters=cb.num_clusters, width=cb.width, depth=cb.depth)
    return _jitted_reference(lambda o, d, t, a: jcluster.cbvh_intersect(jcb, o, d, t_max=t, any_hit=a))


@pytest.mark.parametrize("leaf", [8, 4])
def test_cluster_walk_kernel_equals_the_plain_walk(host_lib, leaf):
    tris = random_tris(51, 1500)
    cb = tcluster.build_cluster_bvh(*tris, leaf_size=leaf, device="cpu")
    assert cb.depth >= 3
    n = 384
    caps = torch.from_numpy(np.random.default_rng(8).uniform(0.05, 6.0, n).astype(np.float32))
    reference = _cluster_reference(cb)
    for name, (o, d) in _ray_sets(52, n, 4.0).items():
        for any_hit in (False, True):
            for t_max in (1e30, caps):
                got = _cluster_walk(host_lib, cb, o, d, t_max, any_hit)
                want = tcluster.cbvh_intersect_plain(cb, o, d, t_max=t_max, any_hit=any_hit)
                _hits_equal(got, want)
                _meets_reference(got, reference(o, d, t_max, any_hit), any_hit)


def test_cluster_walk_kernel_ties_and_overflow(host_lib):
    # The 8-wide chain: every child's box is the whole scene, so every key
    # ties, and its 57-entry need overflows the 32 entries its depth field
    # sizes; the walks drop the same pushes and stop at the same triangle.
    _, cb = _chain(8)
    rng = np.random.default_rng(9)
    o = torch.from_numpy(np.concatenate([rng.uniform(-1, 1, (64, 2)), np.full((64, 1), -5.0)], 1).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    inside = o.clone()
    inside[:, 2] = 0.0  # inside every box: every key is t_min
    reference = _cluster_reference(cb)
    for oo in (o, inside):
        for any_hit in (False, True):
            got = _cluster_walk(host_lib, cb, oo, d, 1e30, any_hit)
            _hits_equal(got, tcluster.cbvh_intersect_plain(cb, oo, d, any_hit=any_hit))
            _meets_reference(got, reference(oo, d, 1e30, any_hit), any_hit)
    assert bool(got.hit.all())


def test_cpu_tensors_take_the_plain_versions():
    """No wrapper launches on a CPU tensor: the results are the plain
    versions' and no count moves; a tensor on neither device raises."""
    tris = tuple(torch.from_numpy(v) for v in random_tris(61, 64))
    o, d = (torch.from_numpy(a) for a in random_rays(62, 64))
    tri_min, tri_max = _boxes(tuple(v.numpy() for v in tris))
    cb = tcluster.build_cluster_bvh(*(v.numpy() for v in tris), leaf_size=8, device="cpu")
    before = dict(ttk.LAUNCHES)
    bvh = tbvh.build_lbvh_aabbs(tri_min, tri_max)
    want = tbvh.build_lbvh_aabbs_plain(tri_min, tri_max)
    for name in tbvh.BVH._fields:
        assert_bits_equal(getattr(bvh, name), getattr(want, name), name)
    for any_hit in (False, True):
        _hits_equal(ttraverse.bvh_intersect(bvh, *tris, o, d, any_hit=any_hit),
                    ttraverse.bvh_intersect_plain(bvh, *tris, o, d, any_hit=any_hit))
        _hits_equal(tcluster.cbvh_intersect(cb, o, d, any_hit=any_hit),
                    tcluster.cbvh_intersect_plain(cb, o, d, any_hit=any_hit))
    assert ttk.LAUNCHES == before
    meta = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbvh.build_lbvh_aabbs(meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ttraverse.bvh_intersect(bvh, *tris, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tcluster.cbvh_intersect(cb, meta, meta)


def test_plain_walk_counts_visits():
    """The plain walks' per-ray pops and visited rows (the kernels' bound is
    counted from them): every ray pops the root, a hit pops at least one
    leaf, the leaf that holds a hit triangle is marked, and no more rows
    are marked than popped."""
    tris = tuple(torch.from_numpy(v) for v in random_tris(71, 128))
    o, d = (torch.from_numpy(a) for a in random_rays(72, 96))
    bvh = tbvh.build_lbvh(*tris)
    counts = torch.zeros((96, 2), dtype=torch.int64)
    visited = torch.zeros((2 * 128 - 1,), dtype=torch.bool)
    hit = ttraverse.bvh_intersect_plain(bvh, *tris, o, d, counts=counts, visited=visited)
    assert bool((counts[:, 0] >= 1).all()) and bool((counts[hit.hit, 1] >= 1).all())
    leaf_of = torch.empty(128, dtype=torch.int64)
    leaf_of[bvh.leaf_tri.long()] = torch.arange(127, 255)
    assert bool(visited[0]) and bool(visited[leaf_of[hit.prim_id[hit.hit].long()]].all())
    assert 0 < int(visited.sum()) <= int(counts.sum())
    cb = tcluster.build_cluster_bvh(*(v.numpy() for v in tris), leaf_size=8, device="cpu")
    counts = torch.zeros((96, 2), dtype=torch.int64)
    visited = torch.zeros((cb.num_nodes + cb.num_clusters,), dtype=torch.bool)
    hit = tcluster.cbvh_intersect_plain(cb, o, d, counts=counts, visited=visited)
    assert bool((counts[:, 0] >= 1).all()) and bool((counts[hit.hit, 1] >= 1).all())
    cluster_of = torch.empty(128, dtype=torch.int64)
    ids = cb.tri_id.long()
    cluster_of[ids[ids >= 0]] = torch.arange(cb.num_clusters)[:, None].expand_as(ids)[ids >= 0]
    assert bool(visited[0]) and bool(visited[cb.num_nodes + cluster_of[hit.prim_id[hit.hit].long()]].all())
    assert 0 < int(visited.sum()) <= int(counts.sum())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_oracle_kernels_on_card():
    """Kernels A-D on the card against their plain versions on the card,
    bit for bit, and each wrapper's launch counted once."""
    dev = _card()
    tris = tuple(torch.from_numpy(v).to(dev) for v in random_tris(81, 5000))
    tri_min, tri_max = (t.to(dev) for t in _boxes(tuple(v.cpu().numpy() for v in tris)))
    before = dict(ttk.LAUNCHES)
    bvh = tbvh.build_lbvh_aabbs(tri_min, tri_max)
    want = tbvh.build_lbvh_aabbs_plain(tri_min, tri_max)
    for name in tbvh.BVH._fields:
        assert_bits_equal(getattr(bvh, name), getattr(want, name), name)
    cb = tcluster.build_cluster_bvh(*(v.cpu().numpy() for v in tris), leaf_size=8, device=dev)
    o, d = (torch.from_numpy(a).to(dev) for a in random_rays(82, 4096))
    caps = torch.full((4096,), 2.5, device=dev)
    for any_hit in (False, True):
        _hits_equal(ttraverse.bvh_intersect(bvh, *tris, o, d, t_max=caps, any_hit=any_hit),
                    ttraverse.bvh_intersect_plain(bvh, *tris, o, d, t_max=caps, any_hit=any_hit))
        _hits_equal(tcluster.cbvh_intersect(cb, o, d, t_max=caps, any_hit=any_hit),
                    tcluster.cbvh_intersect_plain(cb, o, d, t_max=caps, any_hit=any_hit))
    torch.cuda.synchronize()
    keys = ("lbvh_topology", "lbvh_fit", "lbvh_closest", "lbvh_any", "cluster_closest", "cluster_any")  # A-D
    moved = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.ORACLE_KEYS}
    assert moved == {k: int(k in keys) for k in ttk.ORACLE_KEYS}
