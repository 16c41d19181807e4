"""The kernels' own source on the CPU: ``csrc/traverse.cu`` built with g++
under ``csrc/host_shim.h`` (every thread of a launch run in turn) and held,
to the bit, against the per-ray traversals in PyTorch.

- The walk kernels of K3 and K4 (``segment_walk_kernel``,
  ``tlas_walk_kernel``) and their counting forms against
  ``segments_traverse_plain`` / ``traverse_plain``: every output and all
  five per-ray counts equal. That is the proof that the walk keeps each
  ray's visit order. Width 16 with leaf 12 and leaf 24, two or more
  treelets, 3 and 12 instances; rays from outside and inside the soups,
  parked, capped and flagged lanes, ``step_cull``.
- The walk against the general loop on the same inputs: equal outputs and
  equal counts.
- The general loop at a shape the walk is not compiled for (width 8,
  leaf 4) against the same traversals.
- The walk source against the JAX reference's Pallas kernel in interpret
  mode on the same rays (K3 at leaf 12 and 24 through
  ``treelet_intersect``, K4 at leaf 12 through ``two_level_backend``), by
  the oracle rule of tests/test_traverse_kernel.py: hit-mask mismatches
  ≤ max(2, n/500), t within rtol 1e-4 (K4: 2e-4, the object-space hop), ≥ 90%
  of mutual hits on the same prim, uv within rtol 1e-3 there. The two
  kernels order exact key ties differently, so bits are not asked for here.
- A two-level tree that fills the stack to its last entries: the walk
  passes the instance it has no room for and goes on in world space.
- The wrappers' checks of what the walk's 16-byte loads assume, and the
  dispatch between the two loops.

Against the port's own traversals both sides do IEEE float32 arithmetic
without contraction (g++ ``-ffp-contract=off``, as nvcc ``--fmad=false``),
so the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import tlas as jtlas
from raytracer3_tpu.ops import treelets as jtreelets
from raytracer3_tpu_torch.ops import tlas as ttlas
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets

N_SEG = 2048  # two segments at sublanes=8
N_TLAS = 1500


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU build of torch can return one worker's chunk of its first
    # multi-threaded torch.sqrt at ~3e-4 relative error (ROADMAP.md Queue 3).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
}


def _segment_case(tt, case, seed=5):
    opt = dict(K3_CASES[case])
    o, d = _rays(N_SEG, seed)
    t_max = _caps(N_SEG, seed + 1) if opt.pop("caps", False) else ttk._BG
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
    assert ttk.closest_loop(tt.width, tt.leaf_size, group_rays=1024) == "walk"
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
    if "flagged" in case:
        flagged = sl.anyhit_row > 0.5
        assert bool((got[0][flagged & (got[3] >= 0)] == 0).all())  # retired at the first accepted hit
    if "parked" in case or "flagged" in case:
        parked = sl.t_cap == 0
        assert bool(parked.any()) and bool((got[3][parked] < 0).all()) and bool((counts[parked, 1] == 0).all())


def test_k3_general_source_at_another_shape(host_lib):
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(700, seed=2), leaf_size=4, width=8, max_tris=128), "cpu")
    assert ttk.closest_loop(tt.width, tt.leaf_size, group_rays=1024) == "general"
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
    assert tt.num_treelets >= 2 and ttk.closest_loop(tt.width, tt.leaf_size, group_rays=1024) == "walk"
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


def _run_packet(lib, pt, o, d, cap, loop, stats):
    return ttk._launch_packet(lib, pt, o, d, cap, 1e-4, False, stats, loop, None)


@pytest.mark.parametrize("instances,capped", [(3, False), (3, True), (12, False), (12, True), (40, True)],
                         ids=["3_open", "3_capped_parked", "12_open", "12_capped_parked", "40_two_tlas_levels"])
def test_k4_walk_source_equals_plain_traversal(host_lib, instances, capped):
    pt = _two_level(instances)
    assert ttk.closest_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    o, d = _rays(N_TLAS, 21 + instances, spread=9.0, radius=25.0)
    cap = _caps(N_TLAS, 23, lo=2.0) if capped else torch.full((N_TLAS,), ttk._BG)
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "walk", True)
    found = prim >= 0
    assert torch.equal(found, ref.hit) and 0.05 * N_TLAS < int(found.sum()) < N_TLAS
    assert torch.equal(torch.where(found, t, ttk._BG), ref.t)
    assert torch.equal(torch.stack([u, v], dim=-1), ref.uv)
    assert torch.equal(prim, ref.prim_id) and torch.equal(inst, ref.inst)
    assert torch.equal(counts, ref_counts) and int(counts[:, 4].max()) >= 2
    plain_outs = _run_packet(host_lib, pt, o, d, cap, "walk", False)
    old = _run_packet(host_lib, pt, o, d, cap, "general", True)
    for a, b_, c_ in zip((t, u, v, prim, inst), plain_outs, old):
        assert torch.equal(a, b_) and torch.equal(a, c_)
    assert torch.equal(old[5], counts)
    if capped:
        parked = cap == 0
        assert bool((prim[parked] < 0).all()) and bool((counts[parked, 1] == 0).all())


@pytest.mark.parametrize("instances", [3, 12])
def test_k4_walk_source_matches_interpret_reference(host_lib, instances):
    meshes, insts = _instanced_soup(instances)
    jb = jtlas.two_level_backend(meshes, insts, leaf_size=12, width=16, sublanes=8, interpret=True)
    pt = ttlas.two_level_backend(meshes, insts, leaf_size=12, width=16, device="cpu").meta[0]
    assert ttk.closest_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
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
                          inst_table=torch.from_numpy(insts), tlas_nodes=9, leaf_aabb=True)
    return pt, n_inst


def test_k4_walk_on_a_full_stack_stays_in_world_space(host_lib):
    pt, n_inst = _full_stack_tables()
    # The wrapper keeps such a tree on the general loop ...
    assert ttk.stack_depth(pt) > ttk.STACK_CAPACITY - 1
    assert ttk.closest_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "general"
    assert ttk.closest_loop(16, 12, two_level=True, stack_need=ttk.STACK_CAPACITY) == "general"
    assert ttk.closest_loop(16, 12, two_level=True, stack_need=ttk.STACK_CAPACITY - 1) == "walk"
    assert ttk.closest_loop(16, 12, stack_need=ttk.STACK_CAPACITY) == "walk"  # K3 pushes no marker
    # ... and the walk source, run on it all the same, drops what it has no
    # room for and nothing else. Node 8's instances are 120..135, the
    # nearest (135, z = 10) last: 135..128 fall off the stack's end, 127 is
    # popped with one entry free and passed by, 126 is walked and hit at
    # z = 19, and every later instance lies behind that hit. A ray left in
    # instance 127's object space would be mapped a second time at 126's
    # hop, meet its triangle at t = 37, and so take 125's at t = 20.
    assert n_inst == 136
    o = torch.tensor([[0.0, 0.0, 0.0], [0.25, 0.25, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, torch.full((2,), ttk._BG), "walk", True)
    assert inst.tolist() == [126, 126] and prim.tolist() == [0, 0] and t.tolist() == [19.0, 19.0]
    # 128 instances popped (the passed one counts as a hop), 127 BLAS roots
    # and the 9 TLAS nodes expanded, one leaf and one triangle tested.
    assert counts.tolist() == [[9 + 127, 1, 9 * 16 + 127, 1, 128]] * 2
    assert torch.equal(_run_packet(host_lib, pt, o, d, torch.full((2,), ttk._BG), "walk", False)[4], inst)


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


def test_k4_general_source_at_another_shape(host_lib):
    pt = _two_level(12, leaf_size=4, width=8)
    assert ttk.closest_loop(pt.width, pt.leaf_size, two_level=True) == "general"
    o, d = _rays(N_TLAS, 31, spread=9.0, radius=25.0)
    cap = torch.full((N_TLAS,), ttk._BG)
    ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=cap)
    t, u, v, prim, inst, counts = _run_packet(host_lib, pt, o, d, cap, "general", True)
    assert torch.equal(prim, ref.prim_id) and torch.equal(inst, ref.inst) and torch.equal(counts, ref_counts)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _run_packet(host_lib, pt, o, d, cap, "walk", False)


# -- the wrappers' checks and the dispatch ---------------------------------------


def test_dispatch_between_the_loops():
    assert ttk.closest_loop(16, 12) == "walk" and ttk.closest_loop(16, 24) == "walk"
    assert ttk.closest_loop(16, 12, two_level=True) == "walk"
    assert ttk.closest_loop(8, 8) == "general" and ttk.closest_loop(8, 8, two_level=True) == "general"
    assert ttk.closest_loop(16, 24, two_level=True) == "general"  # K4 is compiled for leaf 12 only
    assert ttk.closest_loop(16, 24, group_rays=1024) == "walk"
    assert ttk.closest_loop(16, 24, group_rays=1000) == "general"  # a group must be whole blocks
    # K4's walk keeps one stack entry more than the general loop needs.
    assert ttk.closest_loop(16, 12, two_level=True, stack_need=ttk.STACK_CAPACITY) == "general"
    assert {"seg_closest", "seg_closest_general", "tlas_closest", "tlas_closest_general",
            "seg_closest_general_stats", "tlas_closest_stats"} <= set(ttk.LAUNCHES)


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
    odd = torch.cat([pt.node_table, torch.zeros(pt.node_table.shape[0], 2)], dim=1).contiguous()
    with pytest.raises(ValueError, match="whole 16-byte words"):
        ttk.packet_intersect(pt._replace(node_table=odd), o, d)
    # Any hit keeps the general loop, which reads single floats.
    ttk.packet_intersect(pt._replace(node_table=odd), o, d, any_hit=True)


def test_wrapper_checks_what_the_walk_assumes_k3():
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(300, seed=2), leaf_size=12, width=16, max_tris=256), "cpu")
    sl = _segment_case(tt, "closest")
    sl.launch(tt)  # sound tables pass
    with pytest.raises(ValueError, match="16-byte boundary"):
        sl.launch(tt._replace(cluster_tables=_misaligned(tt.cluster_tables)))
    odd = torch.cat([tt.node_tables, torch.zeros(*tt.node_tables.shape[:2], 1)], dim=2).contiguous()
    with pytest.raises(ValueError, match="whole 16-byte words"):
        sl.launch(tt._replace(node_tables=odd))
    sl._replace(kw=dict(sl.kw, any_hit=True)).launch(tt._replace(node_tables=odd))
