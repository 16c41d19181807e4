"""The last two device loops on the CPU: the wide-BVH walk (kernel E,
``wide_walk_kernel``) and the per-ray work of K3's rounds driver (kernels
F1 ``rounds_pick_kernel`` and F2 ``rounds_merge_kernel``), from
``csrc/oracle_bvh.cu`` built with g++ under ``csrc/host_shim.h``
(``oracle_kernels.load_host_kernels()``: every thread of a launch run in
turn).

- E is held to ``wide_bvh.wbvh_intersect_plain`` with tolerance zero (t, u,
  v and ids compared as bits), and the plain walk to the JAX reference's
  ``wbvh_intersect`` on the same arrays by ``assert_hits_match``'s rule
  (hit masks equal; t within rtol 1e-5 + atol 1e-7; ids equal but on
  exact-t ties, at most max(2, n/100); for any hit the hit masks equal).
  Cases: closest and any hit with per-ray caps, leaf sizes 1, 4 and 15;
  rays from outside the soup, from inside the boxes (the children's keys
  tie at t_min), with zero direction components, and NaN rays; a
  hand-built 8-wide chain whose children all enter, 71 entries deep
  against the stack's 48 (the pushes past it drop, and the pointer stays
  at 48); two leaves with the same box and coincident triangles, where
  only the stable child order decides which id comes back.
- The device-resident rounds loop (``treelets.rounds_on_device``) runs with
  the host-shim F1 and F2 and K3's plain version (``stats=True``: its
  counting form), and is held to the host-looped driver
  (``treelet_intersect_rounds_plain``) bit for bit, with the same round
  count and the same K5 counts, although it runs every one of the
  ``max_rounds or K`` rounds. Cases: closest (also with ``max_rounds`` past
  K), any hit with per-ray caps,
  ``max_rounds=1``, rays that want no treelet (0 rounds), NaN rays, and
  two treelets with the same box (equal entry distances: argmin's first
  index). The closest case also meets the interpret-mode
  ``jtreelets.treelet_intersect_rounds`` at ``sublanes=8`` by
  ``tests/test_torch_rounds.py``'s rule.

The card's case is in ``tests/test_torch_device_loops_card.py`` (a file
without JAX). ~35 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import treelets as jtreelets
from raytracer3_tpu.ops import wide_bvh as jwide
from raytracer3_tpu_torch.ops import oracle_kernels as ok
from raytracer3_tpu_torch.ops import traverse as ttraverse
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from raytracer3_tpu_torch.ops import wide_bvh as twide

from test_torch_bvh import random_tris
from test_torch_lbvh_traverse import assert_hits_match
from test_torch_oracle_kernels import _hits_equal, _ray_sets, assert_bits_equal
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(scope="module")
def host_lib():
    return ok.load_host_kernels()


# ---------------------------------------------------------------------------
# E: the wide-BVH walk
# ---------------------------------------------------------------------------


def _wide_walk(lib, wb, leaf_size, o, d, t_max, any_hit):
    caps = ttraverse.t_caps(t_max, o.shape[0], o.device)
    return ttraverse.finish(*ok.wide_walk(lib, wb, leaf_size, o, d, caps, 1e-4, any_hit, None))


def _wide_reference(wb, leaf_size):
    """The reference's wide walk over the same arrays, jitted once for each
    hit kind, caps always an [N] array."""
    jw = jwide.WideBVH(*(jnp.asarray(x.numpy()) for x in wb))
    fns = {a: jax.jit(lambda o, d, t, a=a: jwide.wbvh_intersect(jw, o, d, t_max=t, any_hit=a, leaf_size=leaf_size))
           for a in (False, True)}

    def run(o, d, t_max, any_hit):
        caps = ttraverse.t_caps(t_max, o.shape[0], o.device)
        return fns[any_hit](jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(caps.numpy()))

    return run


def _meets_reference(got, ref, any_hit):
    if any_hit:
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    else:
        assert_hits_match(got, ref)


def _wide_case(lib, wb, leaf_size, o, d, t_max, any_hit, reference=None):
    got = _wide_walk(lib, wb, leaf_size, o, d, t_max, any_hit)
    want = twide.wbvh_intersect_plain(wb, o, d, t_max=t_max, any_hit=any_hit, leaf_size=leaf_size)
    _hits_equal(got, want)
    if reference is not None:
        _meets_reference(want, reference(o, d, t_max, any_hit), any_hit)
    return got


@pytest.mark.parametrize("leaf_size", [1, 4, 15])
def test_wide_walk_kernel_equals_the_plain_walk(host_lib, leaf_size):
    tris = tuple(torch.from_numpy(v) for v in random_tris(41, 400))
    wb = twide.build_wide(*tris, leaf_size=leaf_size)
    assert int(wb.child_code.shape[0]) >= 3
    n = 192
    caps = torch.from_numpy(np.random.default_rng(7).uniform(0.05, 6.0, n).astype(np.float32))
    reference = _wide_reference(wb, leaf_size)
    for name, (o, d) in _ray_sets(42, n, 4.0).items():
        for any_hit in (False, True):
            for t_max in (1e30, caps):
                got = _wide_case(host_lib, wb, leaf_size, o, d, t_max, any_hit, reference)
                if name == "outside" and t_max is caps:
                    assert bool(got.hit.any()) and not bool(got.hit.all())


def _wide_chain(levels: int = 10):
    """An 8-wide chain: wide node i holds 7 one-triangle leaves and node
    i + 1 in its last slot (the last node: an empty slot). Every box holds
    the whole scene, so every child is entered with the same key and the
    stable order pushes the node last: the walk runs down first and holds
    1 + 7·levels entries, past the stack's 48. Leaf triangle k lies in the
    plane z = 10 - 0.1·k, so the deepest is nearest to rays along +z."""
    m, t = levels, 7 * levels
    cmin = np.full((m, 8, 3), -100.0, np.float32)
    cmax = np.full((m, 8, 3), 100.0, np.float32)
    code = np.zeros((m, 8), np.int32)
    for i in range(m):
        code[i, :7] = [-(((7 * i + s) << 4) | 1) - 2 for s in range(7)]
        code[i, 7] = i + 1 if i + 1 < m else -1
    cmin[m - 1, 7], cmax[m - 1, 7] = np.inf, -np.inf
    z = 10.0 - 0.1 * np.arange(t, dtype=np.float32)
    v0 = np.stack([np.full(t, -50.0), np.full(t, -50.0), z], -1).astype(np.float32)
    v1, v2 = v0.copy(), v0.copy()
    v1[:, 0] += 200.0
    v2[:, 1] += 200.0
    order = np.arange(t, dtype=np.int32)[::-1].copy()  # ids differ from leaf positions
    return twide.WideBVH(*(torch.from_numpy(a) for a in (cmin, cmax, code, order, v0, v1, v2)))


def test_wide_walk_kernel_drops_the_pushes_past_48(host_lib):
    wb = _wide_chain()
    rng = np.random.default_rng(9)
    o = torch.from_numpy(np.concatenate([rng.uniform(-1, 1, (64, 2)), np.full((64, 1), -5.0)], 1).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    inside = o.clone()
    inside[:, 2] = 0.0  # inside every box: every key is t_min
    reference = _wide_reference(wb, 1)
    for oo in (o, inside):
        for any_hit in (False, True):
            got = _wide_case(host_lib, wb, 1, oo, d, 1e30, any_hit, reference)
            assert bool(got.hit.all())
    # The closest hit is not the nearest triangle (leaf 69, id 0): its
    # push was dropped.
    got = _wide_walk(host_lib, wb, 1, o, d, 1e30, False)
    assert bool((got.prim_id != 0).all())


def _tie_tree():
    """One wide node whose slots 0 and 1 are leaves with one box and
    coincident triangles (ids 5 and 7, at z = 1), slot 2 a farther leaf
    (id 9, z = 3), the rest empty; three rays along +z that enter all
    three."""
    cmin = np.full((1, 8, 3), np.inf, np.float32)
    cmax = np.full((1, 8, 3), -np.inf, np.float32)
    code = np.full((1, 8), -1, np.int32)
    for s, (lo, hi) in enumerate((((-1, -1, 0.9), (1, 1, 1.1)), ((-1, -1, 0.9), (1, 1, 1.1)),
                                  ((-1, -1, 2.9), (1, 1, 3.1)))):
        cmin[0, s], cmax[0, s] = lo, hi
        code[0, s] = -((s << 4) | 1) - 2
    z = np.float32([1.0, 1.0, 3.0])
    v0 = np.stack([np.full(3, -1.0), np.full(3, -1.0), z], -1).astype(np.float32)
    v1, v2 = v0.copy(), v0.copy()
    v1[:, 0] += 4.0
    v2[:, 1] += 4.0
    wb = twide.WideBVH(*(torch.from_numpy(a) for a in (cmin, cmax, code, np.int32([5, 7, 9]), v0, v1, v2)))
    o = torch.tensor([[0.0, 0.0, -2.0], [0.25, -0.5, -1.0], [-0.5, 0.1, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(3, 1)
    return wb, o, d


def test_wide_walk_kernel_keeps_the_stable_child_order(host_lib):
    """Two leaves with one box (slots 0 and 1 of the root) hold coincident
    triangles: the stable far-to-near order pushes slot 0 first, so slot 1
    pops first, and its triangle (id 7) is the any-hit answer and, tested
    first at the same t, the closest one. A third leaf, farther, is missed
    by the closest hit's cap but pushed too."""
    wb, o, d = _tie_tree()
    reference = _wide_reference(wb, 1)
    for any_hit in (False, True):
        got = _wide_case(host_lib, wb, 1, o, d, 1e30, any_hit, reference)
        assert got.prim_id.tolist() == [7, 7, 7]
        ref = reference(o, d, 1e30, any_hit)
        assert np.asarray(ref.prim_id).tolist() == [7, 7, 7]


def test_wide_cpu_tensors_take_the_plain_walk():
    tris = tuple(torch.from_numpy(v) for v in random_tris(61, 64))
    o, d = _ray_sets(62, 64, 4.0)["outside"]
    wb = twide.build_wide(*tris)
    before = dict(ttk.LAUNCHES)
    for any_hit in (False, True):
        _hits_equal(twide.wbvh_intersect(wb, o, d, any_hit=any_hit),
                    twide.wbvh_intersect_plain(wb, o, d, any_hit=any_hit))
    assert ttk.LAUNCHES == before
    meta = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        twide.wbvh_intersect(wb, meta, meta)


def test_wide_plain_walk_counts_visits():
    """The plain walk's pops, slots, compares and rows (kernel E's bound
    is counted from them): every ray pops the root, a hit tests at least
    one triangle, a popped node has at most 8 real slots and its sort at
    most 28 compares, the hit triangle's row is marked, and no more rows
    than visits. On the tie tree each ray pops the root (3 real slots) and
    kernel E's insertion sort compares 3 times: slot 1 against slot 0's
    equal key once, slot 2 past both. The closest hit then tests all 3
    leaves' triangles, the any hit only the first."""
    tris = tuple(torch.from_numpy(v) for v in random_tris(71, 128))
    o, d = _ray_sets(72, 96, 4.0)["outside"]
    wb = twide.build_wide(*tris)
    n_nodes = int(wb.child_code.shape[0])
    counts = torch.zeros((96, 4), dtype=torch.int64)
    visited = torch.zeros((n_nodes + 128,), dtype=torch.bool)
    hit = twide.wbvh_intersect_plain(wb, o, d, counts=counts, visited=visited)
    assert bool((counts[:, 0] >= 1).all()) and bool((counts[hit.hit, 1] >= 1).all())
    assert bool((counts[:, 2] <= 8 * counts[:, 0]).all()) and bool((counts[:, 3] <= 28 * counts[:, 0]).all())
    assert int(counts[:, 2].sum()) > 2 * int(counts[:, 0].sum())
    pos = torch.empty(128, dtype=torch.int64)
    pos[wb.tri_order.long()] = torch.arange(128)
    assert bool(visited[0]) and bool(visited[n_nodes + pos[hit.prim_id[hit.hit].long()]].all())
    assert 0 < int(visited.sum()) <= int(counts[:, :2].sum())
    wb, o, d = _tie_tree()
    for any_hit, tested in ((False, 3), (True, 1)):
        counts = torch.zeros((3, 4), dtype=torch.int64)
        twide.wbvh_intersect_plain(wb, o, d, any_hit=any_hit, leaf_size=1, counts=counts)
        assert counts.tolist() == [[1, tested, 3, 3]] * 3


# ---------------------------------------------------------------------------
# F: K3's rounds driver with the round loop on the device
# ---------------------------------------------------------------------------

N = 8 * 128 * 3 + 17  # three segments and a ragged tail at sublanes=8


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


@pytest.fixture(scope="module")
def soup():
    """tests/test_torch_rounds.py's soup and rays: 900 triangles cut into
    treelets of ≤ 128 (leaf 4, width 8), rays from a slightly larger box."""
    rng = np.random.default_rng(0)
    c = rng.uniform(-10, 10, (900, 3)).astype(np.float32)
    tris = (c, c + rng.normal(0, 0.6, (900, 3)).astype(np.float32), c + rng.normal(0, 0.6, (900, 3)).astype(np.float32))
    jtt = jtreelets.build_treelets_host(*tris, leaf_size=4, width=8, max_tris=128)
    rng = np.random.default_rng(33)
    o = rng.uniform(-12, 12, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.random.default_rng(35).uniform(1.0, 30.0, N).astype(np.float32)
    return jtt, ttreelets.tables_to_device(jtt, "cpu"), torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


def _steps(lib):
    return (lambda *a: ok.rounds_pick(lib, *a, None)), (lambda *a: ok.rounds_merge(lib, *a, None))


def _rounds_both(lib, tt, o, d, **kw):
    """Both drivers with K5's counts and the round count; asserts they agree
    to the bit and returns (hit, counts, rounds)."""
    kw = dict(sublanes=8, stats=True, return_rounds=True, **kw)
    want, w_counts, w_rounds = ttreelets.treelet_intersect_rounds_plain(tt, o, d, **kw)
    got, g_counts, g_rounds = ttreelets.rounds_on_device(tt, o, d, *_steps(lib), **kw)
    _hits_equal(got, want)
    assert torch.equal(g_counts, w_counts)
    assert isinstance(g_rounds, torch.Tensor) and g_rounds.ndim == 0 and int(g_rounds) == w_rounds
    return got, g_counts, w_rounds


def test_rounds_on_device_closest_equals_host_loop_and_reference(host_lib, soup):
    jtt, tt, o, d, _ = soup
    got, counts, rounds = _rounds_both(host_lib, tt, o, d)
    assert 2 <= rounds <= tt.num_treelets and bool(got.hit.any())
    # Past K rounds: the same hits and counts, and the same count from both
    # drivers, which include the round that finds no candidate when the
    # bound allows it.
    more, more_counts, more_rounds = _rounds_both(host_lib, tt, o, d, max_rounds=tt.num_treelets + 2)
    _hits_equal(more, got)
    assert torch.equal(more_counts, counts) and rounds <= more_rounds <= rounds + 1
    ref = jtreelets.treelet_intersect_rounds(jtt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True,
                                             sublanes=8)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(ref.prim_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(ref.uv), rtol=1e-5, atol=1e-5)


def test_rounds_on_device_any_hit_with_caps_runs_past_the_last_round(host_lib, soup):
    _, tt, o, d, tmax = soup
    got, counts, rounds = _rounds_both(host_lib, tt, o, d, any_hit=True, t_max=tmax)
    # The host loop stopped early: the device loop's extra rounds took
    # nothing and counted nothing.
    assert 1 <= rounds < tt.num_treelets and bool(got.hit.any())


def test_rounds_on_device_max_rounds_1(host_lib, soup):
    _, tt, o, d, _ = soup
    got, _, rounds = _rounds_both(host_lib, tt, o, d, max_rounds=1)
    assert rounds == 1
    full = ttreelets.treelet_intersect_rounds_plain(tt, o, d, sublanes=8)
    assert int(got.hit.sum()) < int(full.hit.sum())


def test_rounds_on_device_rays_that_want_no_treelet(host_lib, soup):
    _, tt, o, d, _ = soup
    away = o.clone()
    away[:, 2] = 100.0 + away[:, 2].abs()
    up = d.clone()
    up[:, 2] = up[:, 2].abs() + 0.1  # away from the soup
    got, counts, rounds = _rounds_both(host_lib, tt, away, up)
    assert rounds == 0 and not bool(got.hit.any()) and int(counts.abs().sum()) == 0


def test_rounds_on_device_nan_rays(host_lib, soup):
    _, tt, o, d, tmax = soup
    nan_o, nan_d = o.clone(), d.clone()
    nan_o[::4, 1] = float("nan")
    nan_d[2::4, 2] = float("nan")
    got, _, _ = _rounds_both(host_lib, tt, nan_o, nan_d, any_hit=True, t_max=tmax)
    assert not bool(got.hit[::4].any()) and not bool(got.hit[2::4].any()) and bool(got.hit.any())


def test_rounds_on_device_equal_entry_distances(host_lib, soup):
    """Treelets 0 and 1 take one box, the union of theirs: a ray entering
    it enters both at the same t, and both drivers pick treelet 0 first
    (argmin's first index)."""
    _, tt, o, d, _ = soup
    box = tt.aabb.clone()
    box[0, 0:3] = box[1, 0:3] = torch.minimum(box[0, 0:3], box[1, 0:3])
    box[0, 3:6] = box[1, 3:6] = torch.maximum(box[0, 3:6], box[1, 3:6])
    tied = tt._replace(aabb=box)
    rs = ttreelets._rounds_setup(tied, o, d, 1e-4, 1e30, False, 8)
    assert bool((rs.want0[:, 0] & rs.want0[:, 1]).any())
    pending = ttreelets._bits_to_words(torch.cat([rs.want0, rs.pad_cols], dim=1)).contiguous()
    best_id = torch.full((rs.o.shape[0],), -1, dtype=torch.int32)
    want = ttreelets.round_pick_plain(tied, rs, pending, rs.cap0, best_id, False, 1e-4)
    got = ok.rounds_pick(host_lib, pending, rs.o, rs.d, rs.inv_d, rs.cap0, best_id, False, box, rs.lo, rs.hi, 1e-4,
                         None)
    for g, w in zip(got, want):  # F1 alone: has, tid, key, cap and the next words, to the bit
        assert_bits_equal(g, w)
    has, tid = got[:2]
    both = rs.want0[:, 0] & rs.want0[:, 1] & (tid <= 1)
    assert bool(both.any()) and bool((tid[both] == 0).all())
    _rounds_both(host_lib, tied, o, d)
