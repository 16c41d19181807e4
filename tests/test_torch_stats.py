"""K5, the visit counters: the port's per-ray traversal in PyTorch
(``traverse_plain``, ``segments_traverse_plain``) against the brute-force
plain versions and against the JAX reference's interpret-mode counters.

- Hits: ``traverse_plain`` walks the tree as csrc/traverse.cu does, so on
  Cornell, atrium ``detail=1`` and a two-level scene its hit masks equal
  the brute force's, t is bit-equal on every hit (both do the kernel's
  float32 Möller–Trumbore), and the prim or instance may differ only where
  two triangles meet the ray at exactly the same t.
- Counts: on packets of 1,024 copies of one ray (``sublanes=8``: one packet,
  one group), the reference's per-packet counters are that ray's own, so
  they must equal ``traverse_plain``'s per-ray counts to the integer: node
  and leaf pops (K1, K2), node and leaf pops and live steps (K3 closest,
  any hit, ``step_cull``), node pops and leaf pops plus instance hops (K4,
  whose reference counts a hop as a leaf pop). The scenes are triangle
  soups and the rays start outside them: the reference orders children
  with a sorting network that does not keep slot order among exactly equal
  keys, while the kernel pops equal keys in slot order, so a ray whose
  origin lies inside two sibling boxes (both keys t_min) or that meets two
  box faces in one plane may count differently. Neither happens here.
- Both stacks hold every entry these trees push (checked: the reference's
  ``max(64, (w-1)·depth + 1 + depth)``, the kernel's 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import cluster_bvh as jcluster
from raytracer3_tpu.ops import tlas as jtlas
from raytracer3_tpu.ops import treelets as jtreelets
from raytracer3_tpu.ops.pallas import traverse_kernel as jtk
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

COPIES = 1024  # one packet at sublanes=8
RAYS = 12


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _soup(n, seed=0, spread=10.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return c, c + rng.normal(0, size, (n, 3)).astype(np.float32), c + rng.normal(0, size, (n, 3)).astype(np.float32)


def _outside_rays(k, seed, radius=30.0, spread=8.0):
    """Rays from a sphere of ``radius`` around the scene toward random
    points inside it."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(k, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = u * radius
    d = rng.uniform(-spread, spread, (k, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _inside_rays(n, seed, center, spread):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-spread, spread, (n, 3)) + np.asarray(center)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _packets(x):
    return np.repeat(x, COPIES, axis=0)


def _rot(a, b, c):
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rx @ ry @ rz


def _soup_instances(count=12, seed=11):
    """One soup mesh spawned ``count`` times, each turned about all three
    axes, scaled and moved."""
    v0, v1, v2 = _soup(400, seed=9, spread=2.0, size=0.5)
    pos = np.concatenate([v0, v1, v2]).astype(np.float32)
    idx = np.arange(pos.shape[0], dtype=np.int32).reshape(3, -1).T.copy()
    rng = np.random.default_rng(seed)
    insts = []
    for _ in range(count):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rot(*rng.uniform(0, 6, 3)) * rng.uniform(0.6, 1.4)
        m[:3, 3] = rng.uniform(-8, 8, 3)
        insts.append((0, m))
    return [dict(positions=pos, indices=idx)], insts


def _two_level_tables(meshes, insts, **kw):
    jtl = jtlas.build_two_level(meshes, insts, **kw)
    jpt = jtk.pack_two_level(jtl)
    tpt = ttk.tables_from_numpy(jpt, "cpu")._replace(
        inst_table=torch.from_numpy(np.array(jpt.inst_table)), tlas_nodes=jtl.tlas_nodes)
    return jpt, tpt


def _assert_fits_both_stacks(pt):
    assert jtk.STACK <= max(jtk.STACK, (pt.width - 1) * pt.depth + 1 + pt.depth) <= ttk.STACK_CAPACITY


# -- (a) hits against the brute-force plain versions ---------------------------


def _tables(which):
    if which == "cornell":
        tris = tuple(np.asarray(t) for t in janalytic.cornell_box().tri_vertices())
        center, spread = (0.0, 1.0, 0.0), 0.9
    else:
        kw = jprocedural.atrium(detail=1)
        p, i = kw["positions"], kw["indices"]
        tris = (p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])
        center, spread = (0.0, 3.0, 0.0), 6.0
    jpt = jtk.pack_tables_host(jcluster.build_cluster_bvh_host(*tris, 12, width=16, cluster_mode="sah"))
    return ttk.tables_from_numpy(jpt, "cpu"), center, spread


def _assert_hits_match_brute(got, ref):
    """Equal masks, bit-equal t on every hit; where the prims (or
    instances) differ the two triangles meet the ray at the same t, and uv
    is bit-equal where they agree."""
    assert torch.equal(got.hit, ref.hit)
    assert torch.equal(got.t, ref.t)
    same = got.prim_id == ref.prim_id
    if got.inst is not None:
        same &= got.inst == ref.inst
    assert same.float().mean() > 0.99
    assert torch.equal(got.uv[same], ref.uv[same])


@pytest.mark.parametrize("which", ["cornell", "atrium1"])
def test_traverse_plain_hits_match_brute_force(which):
    pt, center, spread = _tables(which)
    o, d = (torch.from_numpy(a) for a in _inside_rays(4000, 3, center, spread))
    got, counts = ttk.traverse_plain(pt, o, d)
    ref = ttk.packet_intersect_plain(pt, o, d)
    assert got.hit.float().mean() > 0.5
    _assert_hits_match_brute(got, ref)
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (4000, 5)
    assert (counts[:, 0] >= 1).all() and (counts[:, 4] == 0).all()
    # Any hit: the same occlusion bits, capped.
    cap = torch.from_numpy(np.random.default_rng(4).uniform(0.05, 2 * spread, 4000).astype(np.float32))
    occ = ttk.traverse_plain(pt, o, d, t_max=cap, any_hit=True, stats=False)
    assert torch.equal(occ.hit, ttk.packet_intersect_plain(pt, o, d, t_max=cap, any_hit=True).hit)


def test_traverse_plain_hits_match_brute_force_two_level():
    meshes, insts = _soup_instances()
    _, tpt = _two_level_tables(meshes, insts, leaf_size=4, width=8)
    o, d = (torch.from_numpy(a) for a in _inside_rays(3000, 5, (0.0, 0.0, 0.0), 9.0))
    got, counts = ttk.traverse_plain(tpt, o, d)
    ref = ttk.packet_intersect_plain(tpt, o, d)
    assert got.hit.float().mean() > 0.2
    _assert_hits_match_brute(got, ref)
    assert (got.inst[~got.hit] == -1).all()
    assert (counts[:, 4] >= 1).float().mean() > 0.2  # instance hops


def test_cpu_stats_calls_run_traverse_plain_uncounted():
    pt, center, spread = _tables("cornell")
    o, d = (torch.from_numpy(a) for a in _inside_rays(512, 7, center, spread))
    before = dict(ttk.LAUNCHES)
    hit, counts = ttk.packet_intersect(pt, o, d, stats=True)
    ref, ref_counts = ttk.traverse_plain(pt, o, d)
    assert ttk.LAUNCHES == before
    assert torch.equal(counts, ref_counts) and torch.equal(hit.t, ref.t)
    hits = ("closest", "any", "seg_closest", "seg_any", "tlas_closest", "tlas_any")
    shapes = hits + tuple(f"{k}_general" for k in hits) + tuple(f"{k}_deep" for k in hits)
    # The oracle backends' kernels (csrc/oracle_bvh.cu), the shade pass
    # (csrc/shade.cu), the treelet driver's passes (csrc/treelet_driver.cu),
    # the sorted launch IO's passes (csrc/sorted_io.cu) and the probe
    # resolve's passes (csrc/probe_resolve.cu) count in the same dict, so
    # that a replayed CUDA graph adds their launches too.
    assert set(ttk.LAUNCHES) == ({k + s for k in shapes for s in ("", "_stats")} | set(ttk.ORACLE_KEYS)
                                 | set(ttk.SHADE_KEYS) | set(ttk.TREELET_DRIVER_KEYS) | set(ttk.SORTED_IO_KEYS)
                                 | set(ttk.PROBE_RESOLVE_KEYS))


# -- (b) per-ray counts against the reference's per-packet counters -------------


@pytest.mark.parametrize("any_hit", [False, True], ids=["k1_closest", "k2_any"])
def test_k12_counts_match_reference_packets(any_hit):
    jpt = jtk.pack_tables_host(jcluster.build_cluster_bvh_host(*_soup(3000, seed=1), 4, width=8,
                                                                cluster_mode="sah"))
    tpt = ttk.tables_from_numpy(jpt, "cpu")
    _assert_fits_both_stacks(tpt)
    o, d = _outside_rays(RAYS, 3)
    cap = np.random.default_rng(4).uniform(20, 40, RAYS).astype(np.float32)
    jkw = dict(any_hit=True, t_max=jnp.asarray(_packets(cap))) if any_hit else {}
    ref, st = jtk.packet_intersect(jpt, jnp.asarray(_packets(o)), jnp.asarray(_packets(d)), interpret=True,
                                   sublanes=8, stats=True, **jkw)
    st = np.asarray(st)
    got, counts = ttk.traverse_plain(tpt, torch.from_numpy(o), torch.from_numpy(d),
                                     t_max=torch.from_numpy(cap) if any_hit else ttk._BG, any_hit=any_hit)
    counts = counts.numpy()
    np.testing.assert_array_equal(counts[:, 0], st[:, 0])  # node pops
    np.testing.assert_array_equal(counts[:, 1], st[:, 1])  # leaf pops
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit)[::COPIES])
    assert 0 < got.hit.sum() < RAYS and counts[:, 0].max() >= 8


@pytest.mark.parametrize("case", ["closest", "closest_step_cull", "any_step_cull"])
def test_k3_counts_match_reference_packets(case):
    jtt = jtreelets.build_treelets_host(*_soup(900), leaf_size=4, width=8, max_tris=128)
    ttt = ttreelets.tables_to_device(jtt, "cpu")
    _assert_fits_both_stacks(ttt)
    o, d = _outside_rays(RAYS, 5, radius=25.0)
    cap = np.random.default_rng(6).uniform(15, 40, RAYS).astype(np.float32)
    kw = dict(sublanes=8, presorted=True, stats=True, step_cull=case != "closest", any_hit=case.startswith("any"))
    tmax = cap if kw["any_hit"] else np.full(RAYS, ttk._BG, np.float32)
    ref, st = jtreelets.treelet_intersect(jtt, jnp.asarray(_packets(o)), jnp.asarray(_packets(d)),
                                          t_max=jnp.asarray(_packets(tmax)), interpret=True, **kw)
    got, rows = ttreelets.treelet_intersect(ttt, torch.from_numpy(_packets(o)), torch.from_numpy(_packets(d)),
                                            t_max=torch.from_numpy(_packets(tmax)), **kw)
    st, rows = np.asarray(st), rows.numpy()
    assert rows.shape == (RAYS, 8) and rows.dtype == np.int32
    # Each segment is one ray's packet: the port's column sums are 1,024
    # times that ray's counts; the reference counts the packet once.
    for col in (0, 1, 4):  # node pops, leaf pops, live steps
        np.testing.assert_array_equal(rows[:, col], COPIES * st[:, col])
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    assert (rows[:, 4] > COPIES).any()  # some rays walk several treelets


@pytest.mark.parametrize("any_hit", [False, True], ids=["k4_closest", "k4_any"])
def test_k4_counts_match_reference_packets(any_hit):
    meshes, insts = _soup_instances()
    jpt, tpt = _two_level_tables(meshes, insts, leaf_size=4, width=8)
    _assert_fits_both_stacks(tpt)
    o, d = _outside_rays(RAYS, 7, radius=25.0)
    cap = np.random.default_rng(8).uniform(15, 40, RAYS).astype(np.float32)
    jkw = dict(any_hit=True, t_max=jnp.asarray(_packets(cap))) if any_hit else {}
    ref, st = jtk.packet_intersect(jpt, jnp.asarray(_packets(o)), jnp.asarray(_packets(d)), interpret=True,
                                   sublanes=8, stats=True, **jkw)
    st = np.asarray(st)
    got, counts = ttk.traverse_plain(tpt, torch.from_numpy(o), torch.from_numpy(d),
                                     t_max=torch.from_numpy(cap) if any_hit else ttk._BG, any_hit=any_hit)
    counts = counts.numpy()
    np.testing.assert_array_equal(counts[:, 0], st[:, 0])
    np.testing.assert_array_equal(counts[:, 1] + counts[:, 4], st[:, 1])  # leaf pops + instance hops
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit)[::COPIES])
    assert counts[:, 4].max() >= 2


# -- the kernels on the card ----------------------------------------------------


@pytest.mark.gpu
def test_stats_kernels_match_traverse_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    pt, center, spread = _tables("atrium1")
    pt = ttk.tables_from_numpy(pt, "cuda")
    o, d = (torch.from_numpy(a).cuda() for a in _inside_rays(20000, 9, center, spread))
    cap = torch.from_numpy(np.random.default_rng(10).uniform(0.05, 12, 20000).astype(np.float32)).cuda()
    for any_hit in (False, True):
        tm = cap if any_hit else ttk._BG
        before = dict(ttk.LAUNCHES)
        hk, ck = ttk.packet_intersect(pt, o, d, t_max=tm, any_hit=any_hit, stats=True)
        key = ("any" if any_hit else "closest") + "_stats"
        assert ttk.LAUNCHES[key] == before[key] + 1
        hp, cp = ttk.traverse_plain(pt, o, d, t_max=tm, any_hit=any_hit)
        hn = ttk.packet_intersect(pt, o, d, t_max=tm, any_hit=any_hit)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        for f in ("hit", "t", "uv", "prim_id"):
            assert torch.equal(getattr(hk, f), getattr(hp, f)) and torch.equal(getattr(hk, f), getattr(hn, f)), f
    tt = ttreelets.tables_to_device(ttreelets.build_treelets_host(*_soup(900), leaf_size=4, width=8, max_tris=128),
                                    "cuda")
    n = 8 * 128 * 4
    o, d = (torch.from_numpy(a).cuda() for a in _inside_rays(n, 11, (0.0, 0.0, 0.0), 12.0))
    seg_cap = cap[:n].contiguous()
    for kw in (dict(step_cull=True), dict(t_max=seg_cap, any_hit=True, step_cull=True),
               dict(t_max=seg_cap, anyhit_mask=torch.arange(n, device="cuda") % 2 == 0, step_cull=True)):
        sl = ttreelets.segment_launch(tt, o, d, sublanes=8, **kw)
        ok, ck = sl.launch(tt, stats=True)
        op, cp = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
        torch.cuda.synchronize()
        assert torch.equal(ok, op) and torch.equal(ck, cp) and torch.equal(ok, sl.launch(tt))
    meshes, insts = _soup_instances()
    _, tpt = _two_level_tables(meshes, insts, leaf_size=4, width=8)
    tpt = ttk.tables_from_numpy(tpt, "cuda")._replace(inst_table=tpt.inst_table.cuda(), tlas_nodes=tpt.tlas_nodes)
    o, d = (torch.from_numpy(a).cuda() for a in _inside_rays(8000, 12, (0.0, 0.0, 0.0), 9.0))
    for any_hit in (False, True):
        tm = cap[:8000].contiguous() if any_hit else ttk._BG
        hk, ck = ttk.packet_intersect(tpt, o, d, t_max=tm, any_hit=any_hit, stats=True)
        hp, cp = ttk.traverse_plain(tpt, o, d, t_max=tm, any_hit=any_hit)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
        for f in ("hit", "t", "prim_id", "inst"):
            assert torch.equal(getattr(hk, f), getattr(hp, f)), f
