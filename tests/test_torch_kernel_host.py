"""The kernels' own source on the CPU: ``csrc/traverse.cu`` built with g++
under ``csrc/host_shim.h`` (every thread of a launch run in turn) and held,
to the bit, against the per-ray traversals in PyTorch.

- The walk kernels of K1/K2, K3 and K4, closest and any hit
  (``traverse_walk_kernel``, ``traverse_walk_any_kernel``,
  ``segment_walk_kernel``, ``segment_walk_any_kernel``,
  ``tlas_walk_kernel``, ``tlas_walk_any_kernel``) and their counting forms
  against ``traverse_plain`` / ``segments_traverse_plain``: every output
  and all five per-ray counts equal. That is the proof that a walk keeps
  each ray's visit order. Width 16 with leaf 12 and leaf 24, a
  single-level table, two or more treelets, 3, 12 and 40 instances; rays
  from outside and inside the soups, parked, capped (at or below t_min too)
  and flagged lanes, ``step_cull``, NaN rays.
- The walks against the general loop on the same inputs: equal outputs and
  equal counts.
- The general loop at a shape the walk is not compiled for (width 8,
  leaf 4) against the same traversals.
- The walk source against the JAX reference's Pallas kernel in interpret
  mode on the same rays (K1/K2 on the same single-level tables, K3 at leaf
  12 and 24 through ``treelet_intersect``, K4 at leaf 12 through
  ``two_level_backend``), by the oracle rule of
  tests/test_traverse_kernel.py: hit-mask mismatches
  ≤ max(2, n/500), t within rtol 1e-4 (K4: 2e-4, the object-space hop), ≥ 90%
  of mutual hits on the same prim, uv within rtol 1e-3 there; any hit by
  its hit mask alone. The two kernels order exact key ties differently, so
  bits are not asked for here.
- The stack sized from the tables: hand-built chains of width 16 whose
  depth the reference's formula would take for more than 128 entries,
  traced one-level and two-level against ``traverse_plain`` and the
  interpret-mode reference; a two-level tree that needs more than 128
  entries on the general loop's 512-entry instantiation; and on a tree that
  fills the 128 entries, the walk passing the instance it has no room for
  and going on in world space.
- The wrappers' checks of what the walk's 16-byte loads assume, and the
  dispatch between the loops.

Against the port's own traversals both sides do IEEE float32 arithmetic
without contraction (g++ ``-ffp-contract=off``, as nvcc ``--fmad=false``),
so the tolerance is zero.
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
from raytracer3_tpu_torch.ops import tlas as ttlas
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

N_SEG = 2048  # two segments at sublanes=8
N_TLAS = 1500


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


@pytest.fixture(scope="module")
def host_lib():
    return ttk.load_host_kernels()


def _soup(n, seed=0, spread=10.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return (c, c + rng.normal(0, size, (n, 3)).astype(np.float32),
            c + rng.normal(0, size, (n, 3)).astype(np.float32))


def _rays(n, seed, spread=12.0, radius=30.0):
    """Half the rays from a sphere around the scene toward it, half from
    inside it in random directions."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = u * radius
    d = rng.uniform(-0.7 * spread, 0.7 * spread, (n, 3)) - o
    inside = np.arange(n) % 2 == 1
    o[inside] = rng.uniform(-spread, spread, (int(inside.sum()), 3))
    d[inside] = rng.normal(size=(int(inside.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _caps(n, seed, lo=0.5, hi=40.0):
    """Per-ray caps: a third parked (0), a third capped, a third open."""
    rng = np.random.default_rng(seed)
    cap = rng.uniform(lo, hi, n).astype(np.float32)
    cap[np.arange(n) % 3 == 0] = 0.0
    cap[np.arange(n) % 3 == 2] = ttk._BG
    return torch.from_numpy(cap)


# -- K1/K2 --------------------------------------------------------------------

N_PACKET = 1500


@pytest.fixture(scope="module")
def packet16():
    """Single-level tables of a soup at the shape packet_backend builds
    (width 16, leaf 12), packed by the JAX reference and uploaded: the same
    tables on both sides."""
    jpt = jtk.pack_tables_host(jcluster.build_cluster_bvh_host(*_soup(3000, seed=4), 12, width=16,
                                                                cluster_mode="sah"))
    pt = ttk.tables_from_numpy(jpt, "cpu")
    assert pt.num_nodes >= 8
    return jpt, pt


K12_CASES = {"closest": (False, False, False), "closest_capped_parked": (False, True, False),
             "closest_nan": (False, True, True), "any": (True, False, False),
             "any_capped_parked": (True, True, False), "any_nan": (True, True, True)}


@pytest.mark.parametrize("case", list(K12_CASES))
def test_k12_walk_source_equals_plain_traversal(host_lib, packet16, case):
    any_hit, capped, nans = K12_CASES[case]
    pt = packet16[1]
    assert ttk.trace_loop(16, 12, single_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    n = N_PACKET
    o, d = _rays(n, 51)
    cap = _caps(n, 52) if capped else torch.full((n,), ttk._BG)
    if capped:
        cap[1::9] = 1e-4  # capped at t_min
        cap[4::9] = 5e-5  # and below it
    if nans:
        o, d, cap = _with_nans(o, d, cap)
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap, any_hit=any_hit)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "walk", True, any_hit=any_hit)
    found = prim >= 0
    assert inst is None and torch.equal(found, ref.hit) and 0.05 * n < int(found.sum()) < n
    assert torch.equal(torch.where(found, t, ttk._BG), ref.t) and torch.equal(prim, ref.prim_id)
    assert torch.equal(torch.stack([u, v], dim=-1), ref.uv) and torch.equal(counts, ref_counts)
    assert int(counts[:, 0].max()) >= 3
    # The production kernel and the general loop, each in both forms: the
    # same bits and the same counts.
    for loop in ("walk", "general"):
        for stats in (False, True):
            got = _run_packet(host_lib, pt, o, d, cap, loop, stats, any_hit=any_hit)
            for a, b_ in zip((t, u, v, prim), got[:4]):
                assert _same_bits(a, b_), (loop, stats)
            assert got[5] is None if not stats else torch.equal(got[5], counts)
    if capped:
        assert bool((prim[cap <= 1e-4] < 0).all()) and bool((counts[cap == 0, 1] == 0).all())
    if nans:
        assert bool((prim[[5, 9, 11]] < 0).all()) and bool((counts[[5, 9, 11], 0] == 1).all())
    if any_hit:
        # The first accepted hit ends the walk: fewer visits than the closest hit's.
        assert int(counts[:, 0].sum()) < int(ttk.traverse_plain(pt, o, d, t_max=cap)[1][:, 0].sum())


@pytest.mark.parametrize("any_hit", [False, True], ids=["k1_closest", "k2_any"])
def test_k12_walk_source_matches_interpret_reference(host_lib, packet16, any_hit):
    jpt, pt = packet16
    n = 1024
    o, d = _rays(n, 61)
    cap = _caps(n, 62) if any_hit else torch.full((n,), ttk._BG)
    ref = jtk.packet_intersect(jpt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), t_max=jnp.asarray(cap.numpy()),
                               any_hit=any_hit, interpret=True, sublanes=8)
    t, u, v, prim, _, _ = _run_packet(host_lib, pt, o, d, cap, "walk", False, any_hit=any_hit)
    if any_hit:
        hit = (prim >= 0).numpy()
        assert 0.05 * n < hit.sum() < n
        assert (hit != np.asarray(ref.hit)).sum() <= max(2, n // 500)
    else:
        _judge_reference(ref, prim >= 0, t, torch.stack([u, v], dim=-1), prim, rtol=1e-4)


def test_k12_entry_points_refuse_what_they_cannot_take(host_lib, packet16):
    pt = packet16[1]
    o, d = _rays(64, 3)
    cap = torch.full((64,), ttk._BG)
    for any_hit in (False, True):
        for bad in (dict(leaf_size=24), dict(width=8), dict(stack_need=ttk.STACK_CAPACITY + 1),
                    dict(node_table=_misaligned(pt.node_table))):
            with pytest.raises(RuntimeError, match="cudaError 1"):
                _run_packet(host_lib, pt._replace(**bad), o, d, cap, "walk", False, any_hit=any_hit)


# -- K3 -----------------------------------------------------------------------


@pytest.fixture(scope="module", params=[12, 24], ids=["leaf12", "leaf24"])
def treelets16(request):
    tt = ttreelets.build_treelets_host(*_soup(4000, seed=2), leaf_size=request.param, width=16, max_tris=2048)
    assert tt.num_treelets >= 2 and tt.depth >= 2
    return ttreelets.tables_to_device(tt, "cpu")


K3_CASES = {
    "closest": dict(),
    "step_cull": dict(step_cull=True),
    "capped_parked": dict(step_cull=True, caps=True),
    "flagged": dict(step_cull=True, caps=True, flagged=True),
    "any": dict(any_hit=True),
    "any_step_cull": dict(any_hit=True, step_cull=True),
    "any_capped_parked": dict(any_hit=True, step_cull=True, caps=True),
}


def _segment_case(tt, case, seed=5):
    opt = dict(K3_CASES[case])
    o, d = _rays(N_SEG, seed)
    t_max = ttk._BG
    if opt.pop("caps", False):
        t_max = _caps(N_SEG, seed + 1)
        if opt.get("any_hit"):
            t_max[1::9] = 1e-4  # capped at t_min: resolved without a walk
            t_max[4::9] = 5e-5
    mask = (torch.arange(N_SEG) % 2 == 0) if opt.pop("flagged", False) else None
    return ttreelets.segment_launch(tt, o, d, t_max=t_max, anyhit_mask=mask, sublanes=8, **opt)


def _run_segments(lib, tt, sl, loop, stats):
    kw = dict(sl.kw)
    return ttk._launch_segments(
        lib, tt, sl.seg_list, sl.seg_entry, sl.seg_gmask.reshape(*sl.seg_list.shape, -1), sl.origins,
        sl.directions, sl.t_cap, sl.anyhit_row, kw["t_min"], kw["any_hit"], kw["step_cull"], kw["sublanes"],
        kw["max_groups"], stats, loop, None)


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_walk_source_equals_plain_traversal(host_lib, treelets16, case):
    tt = treelets16
    assert ttk.trace_loop(tt.width, tt.leaf_size, group_rays=1024, stack_need=ttk.stack_depth(tt)) == "walk"
    sl = _segment_case(tt, case)
    ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
    got, counts = _run_segments(host_lib, tt, sl, "walk", True)
    assert torch.equal(got, ref)
    assert torch.equal(counts, ref_counts)
    hits = int((ref[3] >= 0).sum())
    assert 0.05 * N_SEG < hits < N_SEG and int(ref_counts[:, 4].max()) >= 2
    # The production kernel writes what its counting form writes.
    assert torch.equal(_run_segments(host_lib, tt, sl, "walk", False)[0], got)
    # The general loop on the same launch: the same rows and counts.
    old, old_counts = _run_segments(host_lib, tt, sl, "general", True)
    assert torch.equal(old, got) and torch.equal(old_counts, counts)
    assert torch.equal(_run_segments(host_lib, tt, sl, "general", False)[0], got)
    if "flagged" in case or "any" in case:
        flagged = sl.anyhit_row > 0.5 if "flagged" in case else torch.ones(N_SEG, dtype=torch.bool)
        assert bool((got[0][flagged & (got[3] >= 0)] == 0).all())  # retired at the first accepted hit
    if "parked" in case or "flagged" in case:
        parked = sl.t_cap == 0
        assert bool(parked.any()) and bool((got[3][parked] < 0).all()) and bool((counts[parked, 1] == 0).all())
    if case == "any_capped_parked":
        resolved = sl.t_cap <= 1e-4
        assert int((sl.t_cap > 0)[resolved].sum()) >= 100 and bool((counts[resolved] == 0).all())


def test_k3_general_source_at_another_shape(host_lib):
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(700, seed=2), leaf_size=4, width=8, max_tris=128), "cpu")
    assert ttk.trace_loop(tt.width, tt.leaf_size, group_rays=1024, stack_need=ttk.stack_depth(tt)) == "general"
    sl = _segment_case(tt, "flagged")
    ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
    got, counts = _run_segments(host_lib, tt, sl, "general", True)
    assert torch.equal(got, ref) and torch.equal(counts, ref_counts)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _run_segments(host_lib, tt, sl, "walk", False)  # the source refuses a shape it is not compiled for


def _judge_reference(ref, hit, t, uv, prim, rtol):
    """The reference's kernel-oracle rule (module docstring)."""
    h, rh = hit.numpy(), np.asarray(ref.hit)
    n = h.shape[0]
    assert 0.05 * n < h.sum() < n
    assert (h != rh).sum() <= max(2, n // 500), f"{(h != rh).sum()} / {n} hit-mask mismatches"
    m = h & rh
    np.testing.assert_allclose(t.numpy()[m], np.asarray(ref.t)[m], rtol=rtol, atol=1e-5)
    same = m & (prim.numpy() == np.asarray(ref.prim_id))
    assert same.sum() >= 0.9 * m.sum()
    np.testing.assert_allclose(uv.numpy()[same], np.asarray(ref.uv)[same], rtol=1e-3, atol=1e-4)
    assert (prim.numpy()[~h] == -1).all()
    return m


@pytest.mark.parametrize("leaf_size", [12, 24])
def test_k3_walk_source_matches_interpret_reference(host_lib, leaf_size):
    tris = _soup(1500, seed=2)
    kw = dict(leaf_size=leaf_size, width=16, max_tris=768)
    jtt = jtreelets.build_treelets_host(*tris, **kw)
    tt = ttreelets.tables_to_device(ttreelets.build_treelets_host(*tris, **kw), "cpu")
    assert tt.num_treelets >= 2 and ttk.trace_loop(tt.width, tt.leaf_size, group_rays=1024) == "walk"
    n = 2 * 1024 + 17  # not a whole number of segments
    o, d = _rays(n, 7)
    ref = jtreelets.treelet_intersect(jtt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True,
                                      sublanes=8, step_cull=True)
    sl = ttreelets.segment_launch(tt, o, d, sublanes=8, step_cull=True)
    got = ttreelets.finish(sl, _run_segments(host_lib, tt, sl, "walk", False)[0])
    _judge_reference(ref, got.hit, got.t, got.uv, got.prim_id, rtol=1e-4)
    assert (got.t.numpy()[~got.hit.numpy()] == ttk._BG).all()


# -- K4 -----------------------------------------------------------------------


def _rot(a, b, c):
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rx @ ry @ rz


def _instanced_soup(count, seed=11):
    """(meshes, instances): one soup mesh spawned ``count`` times, each
    turned, scaled and moved."""
    v0, v1, v2 = _soup(300, seed=9, spread=2.0, size=0.5)
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


def _two_level(count, leaf_size=12, width=16, seed=11):
    meshes, insts = _instanced_soup(count, seed)
    return ttlas.two_level_backend(meshes, insts, leaf_size=leaf_size, width=width, device="cpu").meta[0]


def _run_packet(lib, pt, o, d, cap, loop, stats, any_hit=False):
    return ttk._launch_packet(lib, pt, o, d, cap, 1e-4, any_hit, stats, loop, None)


K4_CASES = {"3_open": (3, False), "3_capped_parked": (3, True), "12_open": (12, False),
            "12_capped_parked": (12, True), "40_two_tlas_levels": (40, True)}


@pytest.mark.parametrize("instances,capped,any_hit",
                         [c + (False,) for c in K4_CASES.values()] + [c + (True,) for c in K4_CASES.values()],
                         ids=list(K4_CASES) + [f"any_{k}" for k in K4_CASES])
def test_k4_walk_source_equals_plain_traversal(host_lib, instances, capped, any_hit):
    pt = _two_level(instances)
    assert ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    o, d = _rays(N_TLAS, 21 + instances, spread=9.0, radius=25.0)
    cap = _caps(N_TLAS, 23, lo=2.0) if capped else torch.full((N_TLAS,), ttk._BG)
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap, any_hit=any_hit)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "walk", True, any_hit=any_hit)
    found = prim >= 0
    assert torch.equal(found, ref.hit) and 0.05 * N_TLAS < int(found.sum()) < N_TLAS
    assert torch.equal(torch.where(found, t, ttk._BG), ref.t)
    assert torch.equal(torch.stack([u, v], dim=-1), ref.uv)
    assert torch.equal(prim, ref.prim_id) and torch.equal(inst, ref.inst)
    assert torch.equal(counts, ref_counts) and int(counts[:, 4].max()) >= 2
    plain_outs = _run_packet(host_lib, pt, o, d, cap, "walk", False, any_hit=any_hit)
    old = _run_packet(host_lib, pt, o, d, cap, "general", True, any_hit=any_hit)
    for a, b_, c_ in zip((t, u, v, prim, inst), plain_outs, old):
        assert _same_bits(a, b_) and _same_bits(a, c_)
    assert torch.equal(old[5], counts)
    if capped:
        parked = cap == 0
        assert bool((prim[parked] < 0).all()) and bool((counts[parked, 1] == 0).all())
    if any_hit:
        # The first accepted hit ends the walk: fewer visits than the closest hit's.
        assert int(counts[:, 0].sum()) < int(ttk.traverse_plain(pt, o, d, t_max=cap)[1][:, 0].sum())


@pytest.mark.parametrize("instances", [3, 12])
def test_k4_walk_source_matches_interpret_reference(host_lib, instances):
    meshes, insts = _instanced_soup(instances)
    jb = jtlas.two_level_backend(meshes, insts, leaf_size=12, width=16, sublanes=8, interpret=True)
    pt = ttlas.two_level_backend(meshes, insts, leaf_size=12, width=16, device="cpu").meta[0]
    assert ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    n = 1024
    o, d = _rays(n, 21 + instances, spread=9.0, radius=25.0)
    ref = jb.intersect(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    t, u, v, prim, inst, _ = _run_packet(host_lib, pt, o, d, torch.full((n,), ttk._BG), "walk", False)
    hit = prim >= 0
    m = _judge_reference(ref, hit, t, torch.stack([u, v], dim=-1), prim, rtol=2e-4)
    # An instance id may differ only where two instances hold the hit at the same t.
    parted = m & (inst.numpy() != np.asarray(ref.inst))
    assert (t.numpy()[parted] == np.asarray(ref.t)[parted]).all()
    assert (inst.numpy()[~hit.numpy()] == -1).all()


@pytest.mark.parametrize("instances", [3, 12])
def test_k4_any_walk_source_matches_interpret_reference(host_lib, instances):
    meshes, insts = _instanced_soup(instances)
    jb = jtlas.two_level_backend(meshes, insts, leaf_size=12, width=16, sublanes=8, interpret=True)
    pt = ttlas.two_level_backend(meshes, insts, leaf_size=12, width=16, device="cpu").meta[0]
    n = 1024
    o, d = _rays(n, 31 + instances, spread=9.0, radius=25.0)
    cap = _caps(n, 33, lo=2.0)
    ref = np.asarray(jb.occluded(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(cap.numpy())))
    hit = (_run_packet(host_lib, pt, o, d, cap, "walk", False, any_hit=True)[3] >= 0).numpy()
    assert 0.05 * n < hit.sum() < n
    assert (hit != ref).sum() <= max(2, n // 500)


@pytest.mark.parametrize("leaf_size", [12, 24])
def test_k3_any_walk_source_matches_interpret_reference(host_lib, leaf_size):
    tris = _soup(1500, seed=2)
    kw = dict(leaf_size=leaf_size, width=16, max_tris=768)
    jtt = jtreelets.build_treelets_host(*tris, **kw)
    tt = ttreelets.tables_to_device(ttreelets.build_treelets_host(*tris, **kw), "cpu")
    n = 2 * 1024 + 17
    o, d = _rays(n, 9)
    cap = _caps(n, 10)
    ref = jtreelets.treelet_intersect(jtt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                      t_max=jnp.asarray(cap.numpy()), any_hit=True, interpret=True, sublanes=8,
                                      step_cull=True)
    sl = ttreelets.segment_launch(tt, o, d, t_max=cap, any_hit=True, sublanes=8, step_cull=True)
    got = ttreelets.finish(sl, _run_segments(host_lib, tt, sl, "walk", False)[0])
    h, rh = got.hit.numpy(), np.asarray(ref.hit)
    assert 0.05 * n < h.sum() < n
    assert (h != rh).sum() <= max(2, n // 500)


def _full_stack_tables():
    """Two-level tables, written by hand, on which a ray along +z fills the
    stack: a chain of nine TLAS nodes, each holding the next node in slot 0
    (the nearest box) and instances in its other slots, every box on the
    ray. Instance k is one triangle across the ray at z = 10 + (135 - k) (a
    one-node, one-cluster BLAS behind a translation), so the deepest node
    holds the nearest ones. Node 8 pushes its 16 instances onto 120
    entries: the stack holds 128, so its eight nearest are dropped, and the
    next pop finds an instance with one free entry where the walk needs
    two."""
    w, ls, row = 16, 12, 128
    n_inst = 15 * 8 + 16
    nodes = np.zeros((10, row), np.float32)
    nodes[:, 6 * w : 7 * w] = -1.0
    clusters = np.zeros((1, row), np.float32)
    clusters[0, :9] = (-1, -1, 0, 3, 0, 0, 0, 3, 0)  # v0, e1, e2: covers the origin of the z = 0 plane
    clusters[0, 9 * ls : 10 * ls] = -1.0
    clusters[0, 9 * ls] = 0.0
    insts = np.zeros((n_inst, 32), np.float32)

    def box(node, slot, z_lo, z_hi, code):
        nodes[node, 3 * slot : 3 * slot + 3] = (-2, -2, z_lo)
        nodes[node, 3 * w + 3 * slot : 3 * w + 3 * slot + 3] = (2, 2, z_hi)
        nodes[node, 6 * w + slot] = code

    k = 0
    for node in range(9):
        first = 0 if node == 8 else 1
        if node < 8:
            box(node, 0, 1.0, 400.0, node + 1)
        for slot in range(first, w):
            z = 10.0 + (n_inst - 1 - k)
            box(node, slot, z - 0.5, z + 0.5, -(1 + k) - 2)  # one cluster: instance k is code -(1 + k) - 2
            insts[k, :12] = (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -z)  # world -> object: z moved to 0
            insts[k, 12] = 9  # the BLAS root
            k += 1
    box(9, 0, -0.5, 0.5, -2)  # the BLAS: one node over cluster 0
    pt = ttk.PacketTables(node_table=torch.from_numpy(nodes), cluster_table=torch.from_numpy(clusters),
                          leaf_size=ls, num_nodes=10, num_clusters=1, width=w, depth=10,
                          inst_table=torch.from_numpy(insts), tlas_nodes=9, leaf_aabb=True,
                          stack_need=ttk.stack_need_of(nodes, w, insts))
    return pt, n_inst


def test_k4_walk_on_a_full_stack_stays_in_world_space(host_lib):
    pt, n_inst = _full_stack_tables()
    # The TLAS path holds 8 x 15 + 15 entries below its deepest instance,
    # then the marker and the BLAS root: 137. The wrapper sends such a tree
    # to the general loop's 512-entry instantiation ...
    assert ttk.stack_depth(pt) == 8 * 15 + 16 + 1
    assert ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "deep"
    # ... and the walk source, made to take it all the same (the entry
    # point refuses a need above its 128 entries), drops what it has no
    # room for and nothing else. Node 8's instances are 120..135, the
    # nearest (135, z = 10) last: 135..128 fall off the stack's end, 127 is
    # popped with one entry free and passed by, 126 is walked and hit at
    # z = 19, and every later instance lies behind that hit. A ray left in
    # instance 127's object space would be mapped a second time at 126's
    # hop, meet its triangle at t = 37, and so take 125's at t = 20.
    assert n_inst == 136
    o = torch.tensor([[0.0, 0.0, 0.0], [0.25, 0.25, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    bg = torch.full((2,), ttk._BG)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _run_packet(host_lib, pt, o, d, bg, "walk", False)
    forced = pt._replace(stack_need=ttk.STACK_CAPACITY)
    t, u, v, prim, inst, counts = _run_packet(host_lib, forced, o, d, bg, "walk", True)
    assert inst.tolist() == [126, 126] and prim.tolist() == [0, 0] and t.tolist() == [19.0, 19.0]
    # 128 instances popped (the passed one counts as a hop), 127 BLAS roots
    # and the 9 TLAS nodes expanded, one leaf and one triangle tested.
    assert counts.tolist() == [[9 + 127, 1, 9 * 16 + 127, 1, 128]] * 2
    assert torch.equal(_run_packet(host_lib, forced, o, d, bg, "walk", False)[4], inst)


def test_deep_tree_takes_the_512_entry_general_loop(host_lib):
    # The same tree on the general loop's 512-entry instantiation, which the
    # entry point picks from the need: nothing dropped, the nearest instance
    # (135, z = 10) hit, as the plain traversal finds it.
    pt, n_inst = _full_stack_tables()
    o = torch.tensor([[0.0, 0.0, 0.0], [0.25, 0.25, 0.0], [0.5, -0.5, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    cap = torch.tensor([ttk._BG, 12.0, 10.2])
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "general", True)
    assert inst.tolist() == [n_inst - 1] * 3 and t.tolist() == [10.0] * 3
    assert torch.equal(inst, ref.inst) and torch.equal(prim, ref.prim_id) and torch.equal(counts, ref_counts)
    assert torch.equal(_run_packet(host_lib, pt, o, d, cap, "general", False)[4], inst)
    # Any hit on the same tree: the walk (its entry told the need fits, which
    # an any-hit ray on this tree never exceeds: it retires at the first
    # instance it enters) and the general loop agree with the plain walk.
    for c in (torch.full((3,), ttk._BG), cap, torch.tensor([25.0, 0.0, 140.0])):
        ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=c, any_hit=True)
        walk = _run_packet(host_lib, pt._replace(stack_need=ttk.STACK_CAPACITY), o, d, c, "walk", True, any_hit=True)
        general = _run_packet(host_lib, pt, o, d, c, "general", True, any_hit=True)
        assert torch.equal(walk[3], ref.prim_id) and torch.equal(walk[4], ref.inst)
        assert torch.equal(walk[5], ref_counts) and torch.equal(general[5], ref_counts)
        for a, b_ in zip(walk, general):
            assert _same_bits(a, b_)


def _chain_tables(depth, two_level):
    """A hand-built chain of ``depth`` width-16 nodes, each holding one leaf
    (slot 0) and the next node (slot 1): the reference's depth formula takes
    15·depth + 1 + depth entries, the walk holds depth + 1 at most. The leaf
    of node k is a cluster of one triangle across the +z axis at z = 2 + k,
    offset in x and y so that rays from z = 0 along +z meet some of them.
    Two-level: the chain is the TLAS, its leaves instances of one
    three-node BLAS (12 triangles in three clusters) moved to z = 2 + k."""
    w, ls, row = 16, 12, 128

    def node_rows(n):
        r = np.zeros((n, row), np.float32)
        r[:, : 3 * w] = 1e30
        r[:, 3 * w : 6 * w] = -1e30
        r[:, 6 * w : 7 * w] = -1.0
        return r

    def box(rows, node, slot, lo, hi, code):
        rows[node, 3 * slot : 3 * slot + 3] = lo
        rows[node, 3 * w + 3 * slot : 3 * w + 3 * slot + 3] = hi
        rows[node, 6 * w + slot] = code

    def cluster(tris, ids):
        c = np.zeros(row, np.float32)
        c[9 * ls : 10 * ls] = -1.0
        for j, (v0, v1, v2) in enumerate(tris):
            c[9 * j : 9 * j + 9] = np.concatenate([v0, v1 - v0, v2 - v0])
            c[9 * ls + j] = ids[j]
        return c

    rng = np.random.default_rng(depth)
    if not two_level:
        nodes = node_rows(depth)
        clusters = []
        for k in range(depth):
            z = 2.0 + k
            cx, cy = rng.uniform(-1.5, 1.5, 2)
            v0, v1, v2 = (np.array(p, np.float32) for p in ((cx - 1, cy - 1, z), (cx + 2, cy - 1, z), (cx - 1, cy + 2, z)))
            clusters.append(cluster([(v0, v1, v2)], [k]))
            box(nodes, k, 0, np.minimum(np.minimum(v0, v1), v2) - 1e-3, np.maximum(np.maximum(v0, v1), v2) + 1e-3,
                -k - 2)
            if k + 1 < depth:
                box(nodes, k, 1, (-3.0, -3.0, z + 0.5), (3.0, 3.0, depth + 3.0), k + 1)
        pt = ttk.PacketTables(node_table=torch.from_numpy(nodes), cluster_table=torch.from_numpy(np.stack(clusters)),
                              leaf_size=ls, num_nodes=depth, num_clusters=depth, width=w, depth=depth,
                              leaf_aabb=True, stack_need=ttk.stack_need_of(nodes, w))
        return pt, None
    # The BLAS: a root over three leaves of four triangles each, in a unit
    # square around the origin.
    blas = node_rows(1)
    clusters = []
    for c in range(3):
        tris = []
        for j in range(4):
            cx, cy = rng.uniform(-1.0, 1.0, 2)
            dz = rng.uniform(-0.2, 0.2)
            tris.append(tuple(np.array(p, np.float32) for p in
                              ((cx - 0.4, cy - 0.4, dz), (cx + 0.6, cy - 0.3, dz), (cx - 0.3, cy + 0.6, dz))))
        clusters.append(cluster(tris, [4 * c + j for j in range(4)]))
        pts = np.array([p for t in tris for p in t])
        box(blas, 0, c, pts.min(0) - 1e-3, pts.max(0) + 1e-3, -c - 2)
    tlas = node_rows(depth)
    blas_root = depth
    blas[0, 6 * w : 6 * w + 3] = (-2, -3, -4)
    insts = np.zeros((depth, 32), np.float32)
    for k in range(depth):
        z = 2.0 + k
        dx, dy = rng.uniform(-0.8, 0.8, 2)
        insts[k, :12] = (1, 0, 0, -dx, 0, 1, 0, -dy, 0, 0, 1, -z)  # world -> object
        insts[k, 12] = blas_root
        box(tlas, k, 0, (dx - 1.5, dy - 1.5, z - 0.3), (dx + 1.5, dy + 1.5, z + 0.3), -(3 + k) - 2)
        if k + 1 < depth:
            box(tlas, k, 1, (-3.0, -3.0, z + 0.5), (3.0, 3.0, depth + 3.0), k + 1)
    nodes = np.concatenate([tlas, blas])
    pt = ttk.PacketTables(node_table=torch.from_numpy(nodes), cluster_table=torch.from_numpy(np.stack(clusters)),
                          leaf_size=ls, num_nodes=depth + 1, num_clusters=3, width=w, depth=depth + 1,
                          inst_table=torch.from_numpy(insts), tlas_nodes=depth, leaf_aabb=True,
                          stack_need=ttk.stack_need_of(nodes, w, insts))
    return pt, insts


def _chain_rays(n, seed):
    """Rays from below the chain, up along +z with a small tilt."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-2.0, 2.0, (n, 2)), np.zeros((n, 1))], axis=1)
    d = np.concatenate([rng.normal(0, 0.05, (n, 2)), np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("two_level", [False, True], ids=["one_level", "two_level"])
def test_deep_chain_is_traced_with_its_true_stack_need(host_lib, two_level):
    depth = 12
    pt, insts = _chain_tables(depth, two_level)
    # The reference's formula refuses this tree at 128 entries; its true
    # need is one entry per level and one more (two-level: the TLAS chain,
    # the marker and the BLAS's three leaves).
    assert ttk.reference_stack_depth(pt) > ttk.STACK_CAPACITY
    assert ttk.stack_depth(pt) == (depth + 3 if two_level else depth)
    loop = ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt))
    assert loop == "walk" and ttk._check_stack(pt) == ttk.stack_depth(pt)
    n = 1024
    o, d = _chain_rays(n, 3)
    cap = torch.full((n,), ttk._BG)
    cap[::4] = 6.5  # capped inside the chain
    for any_hit in (False, True):
        ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap, any_hit=any_hit)
        loops = ("walk", "general") if two_level else ("general",)
        for lp in loops:
            t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, lp, True, any_hit=any_hit)
            found = prim >= 0
            assert torch.equal(found, ref.hit) and 0.2 * n < int(found.sum()) < n
            assert torch.equal(torch.where(found, t, ttk._BG), ref.t) and torch.equal(prim, ref.prim_id)
            assert torch.equal(counts, ref_counts)
            if two_level:
                assert torch.equal(inst, ref.inst)
        assert int(ref_counts[:, 0].max()) >= depth // 2
        # Against the reference in interpret mode (its stack sized by its
        # formula), by the oracle rule.
        jpt = jtk.PacketTables(node_table=jnp.asarray(pt.node_table.numpy()),
                               cluster_table=jnp.asarray(pt.cluster_table.numpy()), leaf_size=pt.leaf_size,
                               num_nodes=pt.num_nodes, num_clusters=pt.num_clusters, width=pt.width,
                               depth=pt.depth, inst_table=None if insts is None else jnp.asarray(insts),
                               tlas_nodes=pt.tlas_nodes, leaf_aabb=True)
        jref = jtk.packet_intersect(jpt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), t_max=jnp.asarray(cap.numpy()),
                                    any_hit=any_hit, interpret=True, sublanes=8)
        t, u, v, prim, inst, _ = _run_packet(host_lib, pt, o, d, cap, loops[0], False, any_hit=any_hit)
        if any_hit:
            assert ((prim >= 0).numpy() != np.asarray(jref.hit)).sum() <= max(2, n // 500)
        else:
            _judge_reference(jref, prim >= 0, t, torch.stack([u, v], dim=-1), prim, rtol=2e-4)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _with_nans(o, d, cap):
    """Rays 5, 9 and 11 get a NaN origin, direction and cap."""
    o, d, cap = o.clone(), d.clone(), cap.clone()
    o[5, 0] = d[9, 1] = cap[11] = float("nan")
    return o, d, cap


def test_nan_rays_miss_as_in_the_general_loop(host_lib, treelets16):
    # The walk's slab test uses fminf/fmaxf, which drop a NaN operand; a ray,
    # cap or t_min that holds one must still miss every box, as it does in
    # the general loop and in the plain traversal.
    pt = _two_level(12)
    o, d = _rays(256, 41, spread=9.0, radius=25.0)
    o, d, cap = _with_nans(o, d, torch.full((256,), ttk._BG))
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap)
    new = _run_packet(host_lib, pt, o, d, cap, "walk", True)
    old = _run_packet(host_lib, pt, o, d, cap, "general", True)
    for a, b_ in zip(new, old):
        assert _same_bits(a, b_)
    assert torch.equal(new[3], ref.prim_id) and torch.equal(new[5], ref_counts)
    assert bool((new[3][[5, 9, 11]] < 0).all()) and bool((new[5][[5, 9, 11], 0] == 1).all())
    tt = treelets16
    o, d = _rays(1024, 43)
    o, d, cap = _with_nans(o, d, torch.full((1024,), ttk._BG))
    sl = ttreelets.segment_launch(tt, o, d, t_max=cap, sublanes=8, presorted=True)
    sl = sl._replace(seg_gmask=torch.where(sl.seg_gmask != 0, sl.seg_gmask, 1))  # every step on for its group
    new, counts = _run_segments(host_lib, tt, sl, "walk", True)
    old, old_counts = _run_segments(host_lib, tt, sl, "general", True)
    ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
    assert torch.equal(new[3], old[3]) and torch.equal(counts, old_counts) and torch.equal(counts, ref_counts)
    assert _same_bits(new, old) and bool((new[3][[5, 9, 11]] < 0).all())


def test_nan_rays_any_hit_as_in_the_general_loop(host_lib, treelets16):
    # The any-hit walks ask the NaN question as the closest-hit walks do.
    pt = _two_level(12)
    o, d = _rays(256, 45, spread=9.0, radius=25.0)
    o, d, cap = _with_nans(o, d, torch.full((256,), ttk._BG))
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap, any_hit=True)
    new = _run_packet(host_lib, pt, o, d, cap, "walk", True, any_hit=True)
    old = _run_packet(host_lib, pt, o, d, cap, "general", True, any_hit=True)
    for a, b_ in zip(new, old):
        assert _same_bits(a, b_)
    assert torch.equal(new[3], ref.prim_id) and torch.equal(new[5], ref_counts)
    assert bool((new[3][[5, 9, 11]] < 0).all()) and bool((new[5][[5, 9, 11], 0] == 1).all())
    tt = treelets16
    o, d = _rays(1024, 47)
    o, d, cap = _with_nans(o, d, torch.full((1024,), ttk._BG))
    sl = ttreelets.segment_launch(tt, o, d, t_max=cap, any_hit=True, sublanes=8, presorted=True)
    sl = sl._replace(seg_gmask=torch.where(sl.seg_gmask != 0, sl.seg_gmask, 1))
    new, counts = _run_segments(host_lib, tt, sl, "walk", True)
    old, old_counts = _run_segments(host_lib, tt, sl, "general", True)
    ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
    assert torch.equal(counts, old_counts) and torch.equal(counts, ref_counts) and _same_bits(new, ref)
    assert _same_bits(new, old) and bool((new[3][[5, 9, 11]] < 0).all())


def test_k4_general_source_at_another_shape(host_lib):
    pt = _two_level(12, leaf_size=4, width=8)
    assert ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "general"
    o, d = _rays(N_TLAS, 31, spread=9.0, radius=25.0)
    cap = torch.full((N_TLAS,), ttk._BG)
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "general", True)
    assert torch.equal(prim, ref.prim_id) and torch.equal(inst, ref.inst) and torch.equal(counts, ref_counts)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _run_packet(host_lib, pt, o, d, cap, "walk", False)


# -- the wrappers' checks and the dispatch ---------------------------------------


def test_dispatch_between_the_loops():
    assert ttk.trace_loop(16, 12) == "walk" and ttk.trace_loop(16, 24) == "walk"
    assert ttk.trace_loop(16, 12, two_level=True) == "walk"
    assert ttk.trace_loop(8, 8) == "general" and ttk.trace_loop(8, 8, two_level=True) == "general"
    assert ttk.trace_loop(16, 24, two_level=True) == "general"  # K4 is compiled for leaf 12 only
    assert ttk.trace_loop(16, 24, group_rays=1024) == "walk"
    assert ttk.trace_loop(16, 24, group_rays=1000) == "general"  # a group must be whole blocks
    # The need of two-level tables counts the walk's marker already.
    assert ttk.trace_loop(16, 12, two_level=True, stack_need=ttk.STACK_CAPACITY) == "walk"
    for shape in ((16, 12), (8, 8)):
        assert ttk.trace_loop(*shape, two_level=True, stack_need=ttk.STACK_CAPACITY + 1) == "deep"
        assert ttk.trace_loop(*shape, stack_need=ttk.DEEP_STACK_CAPACITY + 1) == "deep"
    pt = _two_level(3)
    with pytest.raises(ValueError, match="513-entry"):
        ttk._check_stack(pt._replace(stack_need=ttk.DEEP_STACK_CAPACITY + 1))
    with pytest.raises(ValueError, match="no stack need"):
        ttk.stack_depth(pt._replace(stack_need=0))
    assert ttk._check_stack(pt._replace(stack_need=ttk.DEEP_STACK_CAPACITY)) == ttk.DEEP_STACK_CAPACITY
    assert ttk._launch_key("tlas_any", "walk", False) == "tlas_any"
    assert ttk._launch_key("seg_any", "general", True) == "seg_any_general_stats"
    assert ttk._launch_key("any", "general", False) == "any_general" and ttk._launch_key("any", "deep", False) == "any_deep"
    assert ttk._launch_key("closest", "walk", True) == "closest_stats"
    assert {"seg_any", "seg_any_general", "tlas_any", "tlas_any_general", "seg_closest_deep", "tlas_any_deep_stats",
            "closest_deep", "any_deep", "seg_closest_general_stats", "tlas_closest_stats", "closest_general",
            "any_general_stats"} <= set(ttk.LAUNCHES)
    # K1/K2: the walk at the shape packet_backend builds only.
    assert ttk.trace_loop(16, 12, single_level=True) == "walk"
    assert ttk.trace_loop(16, 24, single_level=True) == "general" and ttk.trace_loop(8, 8, single_level=True) == "general"
    assert ttk.trace_loop(16, 12, single_level=True, stack_need=ttk.STACK_CAPACITY + 1) == "deep"


def test_entry_points_refuse_a_need_they_cannot_hold(host_lib):
    pt = _two_level(3)
    o, d = _rays(64, 3)
    cap = torch.full((64,), ttk._BG)
    for any_hit in (False, True):
        for loop, need in (("walk", ttk.STACK_CAPACITY + 1), ("general", ttk.DEEP_STACK_CAPACITY + 1)):
            with pytest.raises(RuntimeError, match="cudaError 1"):
                _run_packet(host_lib, pt._replace(stack_need=need), o, d, cap, loop, False, any_hit=any_hit)
        ref = _run_packet(host_lib, pt, o, d, cap, "general", False, any_hit=any_hit)
        deep = _run_packet(host_lib, pt._replace(stack_need=ttk.DEEP_STACK_CAPACITY), o, d, cap, "general", False,
                           any_hit=any_hit)
        for a, b_ in zip(ref, deep):
            assert a is None or _same_bits(a, b_)


def _misaligned(t):
    """The same values in a contiguous view that starts 4 bytes off."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    off = 1 if buf.data_ptr() % 16 == 0 else (16 - buf.data_ptr() % 16) // 4 + 1
    view = buf[off : off + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_wrapper_checks_what_the_walk_assumes_k4():
    pt = _two_level(3)
    o, d = _rays(64, 3)
    ttk.packet_intersect(pt, o, d)  # sound tables pass
    for field in ("node_table", "cluster_table", "inst_table"):
        with pytest.raises(ValueError, match="16-byte boundary"):
            ttk.packet_intersect(pt._replace(**{field: _misaligned(getattr(pt, field))}), o, d)
        with pytest.raises(ValueError, match="16-byte boundary"):
            ttk.packet_intersect(pt._replace(**{field: _misaligned(getattr(pt, field))}), o, d, any_hit=True)
    odd = torch.cat([pt.node_table, torch.zeros(pt.node_table.shape[0], 2)], dim=1).contiguous()
    for any_hit in (False, True):
        with pytest.raises(ValueError, match="whole 16-byte words"):
            ttk.packet_intersect(pt._replace(node_table=odd), o, d, any_hit=any_hit)
    # The general loop, which reads single floats, takes such rows: K4 and
    # K2 at a shape the walk is not compiled for.
    ttk.packet_intersect(pt._replace(node_table=odd, inst_table=None, leaf_size=8), o, d, any_hit=True)
    ttk.packet_intersect(pt._replace(node_table=odd, leaf_size=8), o, d, any_hit=True)


def test_wrapper_checks_what_the_walk_assumes_k12(packet16):
    pt = packet16[1]
    o, d = _rays(64, 3)
    for any_hit in (False, True):
        ttk.packet_intersect(pt, o, d, any_hit=any_hit)  # sound tables pass
        for field in ("node_table", "cluster_table"):
            with pytest.raises(ValueError, match="16-byte boundary"):
                ttk.packet_intersect(pt._replace(**{field: _misaligned(getattr(pt, field))}), o, d, any_hit=any_hit)
        odd = torch.cat([pt.node_table, torch.zeros(pt.node_table.shape[0], 2)], dim=1).contiguous()
        with pytest.raises(ValueError, match="whole 16-byte words"):
            ttk.packet_intersect(pt._replace(node_table=odd), o, d, any_hit=any_hit)
        # A shape the walk is not compiled for keeps the general loop, which reads single floats.
        ttk.packet_intersect(pt._replace(node_table=_misaligned(odd), leaf_size=8), o, d, any_hit=any_hit)


def test_wrapper_checks_what_the_walk_assumes_k3():
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(300, seed=2), leaf_size=12, width=16, max_tris=256), "cpu")
    sl = _segment_case(tt, "closest")
    sl.launch(tt)  # sound tables pass
    with pytest.raises(ValueError, match="16-byte boundary"):
        sl.launch(tt._replace(cluster_tables=_misaligned(tt.cluster_tables)))
    odd = torch.cat([tt.node_tables, torch.zeros(*tt.node_tables.shape[:2], 1)], dim=2).contiguous()
    any_sl = sl._replace(kw=dict(sl.kw, any_hit=True))
    for launch in (sl, any_sl):
        with pytest.raises(ValueError, match="whole 16-byte words"):
            launch.launch(tt._replace(node_tables=odd))
        with pytest.raises(ValueError, match="16-byte boundary"):
            launch.launch(tt._replace(node_tables=_misaligned(tt.node_tables)))
    # A group of other than whole blocks keeps the general loop, which reads single floats.
    assert ttk.trace_loop(tt.width, tt.leaf_size, group_rays=1000) == "general"
