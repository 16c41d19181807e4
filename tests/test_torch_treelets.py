"""The port's treelet tables, segment-grid driver and K3 against the JAX
reference.

- Tables built on the same numpy geometry are bit-equal, field by field
  (padding rows, global triangle ids and cluster AABBs included).
- The driver's segment inputs (sorted rays and caps, ``seg_list``,
  ``seg_entry``, ``seg_gmask``, any-hit flags) are bit-equal to what the
  reference hands its Pallas kernel: both kernels are replaced by a stub
  that records its arguments.
- Traversal (K3's plain version here) is judged against the reference's
  interpret-mode ``treelet_intersect`` (``interpret=True, sublanes=8``) by
  the oracle rule of tests/test_traverse_kernel.py: hit-mask mismatches
  ≤ max(2, n/500), t within rtol 1e-4, ≥ 90% of mutual hits on the same
  prim, uv within rtol 1e-3 there; any-hit lanes compare their masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import treelets as jtreelets
from raytracer3_tpu.ops.pallas import traverse_kernel as jtk
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

BG = 100000.0


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _soup(n, seed=0, spread=10.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _rays(n, seed=1, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _atrium1():
    kw = jprocedural.atrium(detail=1)
    p, i = kw["positions"], kw["indices"]
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


@pytest.fixture(scope="module")
def soup():
    tris = _soup(900)
    jtt = jtreelets.build_treelets_host(*tris, leaf_size=4, width=8, max_tris=128)
    return tris, jtt, ttreelets.tables_to_device(jtt, "cpu")


@pytest.mark.parametrize("which", ["soup", "atrium1"])
def test_treelet_tables_bit_equal(which):
    if which == "soup":
        tris, kw = _soup(900), dict(leaf_size=4, width=8, max_tris=128)
    else:
        tris, kw = _atrium1(), dict(leaf_size=24, width=16, max_tris=4096, cluster_mode="sah")
    ref = jtreelets.build_treelets_host(*tris, **kw)
    got = ttreelets.build_treelets_host(*tris, **kw)
    assert got.num_treelets == ref.num_treelets >= 2
    for field in ("node_tables", "cluster_tables", "aabb"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(ref, field)), err_msg=field)
    for field in ("leaf_size", "width", "depth", "num_treelets", "max_nodes", "max_clusters", "leaf_aabb"):
        assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.parametrize("partition", ["median", "sah"])
def test_partitions_match_reference(partition):
    v0, v1, v2 = _soup(500, seed=3)
    cent = (v0 + v1 + v2) / 3.0
    if partition == "median":
        ref, got = jtreelets._median_partition(cent, 64), ttreelets._median_partition(cent, 64)
    else:
        lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
        ref = jtreelets._sah_partition(cent, lo, hi, 64)
        got = ttreelets._sah_partition(cent, lo, hi, 64)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(500))


def _record_reference(monkeypatch):
    calls = []

    def stub(tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, **kw):
        calls.append(dict(
            seg_list=np.asarray(seg_list), seg_entry=np.asarray(seg_entry),
            seg_gmask=np.asarray(seg_gmask).reshape(seg_list.shape[0], seg_list.shape[1], -1),
            origins=np.asarray(origins), directions=np.asarray(directions), t_cap=np.asarray(t_cap),
            anyhit_row=None if kw.get("anyhit_row") is None else np.asarray(kw["anyhit_row"]),
            kw={k: kw[k] for k in ("t_min", "any_hit", "step_cull", "sublanes", "max_groups")},
        ))
        zeros = jnp.zeros_like(t_cap)
        return jnp.stack([t_cap, zeros, zeros, zeros - 1.0])

    monkeypatch.setattr(jtk, "packet_intersect_segments", stub)
    return calls


def _record_port(monkeypatch):
    calls = []

    def stub(tt, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, **kw):
        calls.append(dict(
            seg_list=seg_list.numpy(), seg_entry=seg_entry.numpy(), seg_gmask=seg_gmask.numpy(),
            origins=origins.numpy(), directions=directions.numpy(), t_cap=t_cap.numpy(),
            anyhit_row=None if kw.get("anyhit_row") is None else kw["anyhit_row"].numpy(),
            kw={k: kw[k] for k in ("t_min", "any_hit", "step_cull", "sublanes", "max_groups")},
        ))
        zeros = torch.zeros_like(t_cap)
        return torch.stack([t_cap, zeros, zeros, zeros - 1.0])

    monkeypatch.setattr(ttk, "packet_intersect_segments", stub)
    return calls


SEGMENT_CASES = {
    "closest": dict(n=8 * 128 * 3 + 17),
    "any_tmax": dict(n=8 * 128 * 3, any_hit=True, tmax=True),
    "step_cull": dict(n=8 * 128 * 3 + 17, step_cull=True),
    "step_cull_any": dict(n=8 * 128 * 2 + 5, step_cull=True, any_hit=True, tmax=True),
    "presorted": dict(n=8 * 128 * 2 + 100, presorted=True, step_cull=True),
    "mixed": dict(n=8 * 128 * 2, tmax=True, mask=True, step_cull=True),
    "sorted_1024": dict(n=1024 * 128, sublanes=1024, max_groups=128, step_cull=True),
}


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_inputs_bit_equal(soup, monkeypatch, case):
    c = SEGMENT_CASES[case]
    _, jtt, ttt = soup
    n = c["n"]
    o, d = _rays(n, seed=21)
    rng = np.random.default_rng(22)
    tmax = rng.uniform(0.5, 30.0, n).astype(np.float32) if c.get("tmax") else None
    if tmax is not None:
        tmax[:7] = 0.0  # parked lanes
    mask = (rng.uniform(size=n) < 0.5) if c.get("mask") else None
    kw = dict(sublanes=c.get("sublanes", 8), presorted=c.get("presorted", False),
              step_cull=c.get("step_cull", False), any_hit=c.get("any_hit", False),
              max_groups=c.get("max_groups", 32))
    ref_calls, got_calls = _record_reference(monkeypatch), _record_port(monkeypatch)
    jtreelets.treelet_intersect(
        jtt, jnp.asarray(o), jnp.asarray(d), t_max=BG if tmax is None else jnp.asarray(tmax),
        anyhit_mask=None if mask is None else jnp.asarray(mask), **kw)
    ttreelets.treelet_intersect(
        ttt, torch.from_numpy(o), torch.from_numpy(d), t_max=BG if tmax is None else torch.from_numpy(tmax),
        anyhit_mask=None if mask is None else torch.from_numpy(mask), **kw)
    (ref,), (got,) = ref_calls, got_calls
    assert got["kw"] == ref["kw"]
    for key in ("seg_list", "seg_entry", "seg_gmask", "origins", "directions", "t_cap", "anyhit_row"):
        if ref[key] is None:
            assert got[key] is None, key
            continue
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert (ref["seg_gmask"] != 0).any()


def _judge(ref, got, any_lanes=None):
    """Oracle rule; lanes in ``any_lanes`` compare their hit masks only."""
    h, rh = got.hit.numpy(), np.asarray(ref.hit)
    n = h.shape[0]
    assert (h != rh).sum() <= max(2, n // 500), f"{(h != rh).sum()} / {n} hit-mask mismatches"
    m = h & rh
    if any_lanes is not None:
        m &= ~any_lanes
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-4, atol=1e-5)
    same = m & (got.prim_id.numpy() == np.asarray(ref.prim_id))
    assert same.sum() >= 0.9 * m.sum()
    np.testing.assert_allclose(got.uv.numpy()[same], np.asarray(ref.uv)[same], rtol=1e-3, atol=1e-4)
    assert (got.prim_id.numpy()[~h] == -1).all() and (got.t.numpy()[~h] == BG).all()


@pytest.mark.parametrize("kind", ["closest", "any_hit"])
def test_treelet_intersect_matches_interpret_reference(soup, kind):
    _, jtt, ttt = soup
    n = 8 * 128 * 2 + 17  # not a segment multiple
    o, d = _rays(n, seed=7)
    kw = dict(sublanes=8, step_cull=True)
    if kind == "any_hit":
        tmax = np.random.default_rng(11).uniform(1.0, 30.0, n).astype(np.float32)
        kw.update(any_hit=True)
        ref = jtreelets.treelet_intersect(jtt, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tmax),
                                          interpret=True, **kw)
        got = ttreelets.treelet_intersect(ttt, torch.from_numpy(o), torch.from_numpy(d),
                                          t_max=torch.from_numpy(tmax), **kw)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        assert 0 < got.hit.numpy().sum() < n
        return
    ref = jtreelets.treelet_intersect(jtt, jnp.asarray(o), jnp.asarray(d), interpret=True, **kw)
    got = ttreelets.treelet_intersect(ttt, torch.from_numpy(o), torch.from_numpy(d), **kw)
    assert got.hit.numpy().sum() > 100
    _judge(ref, got)


def test_capped_mixed_matches_interpret_reference():
    # The fused shadow+bounce launch shape: half the lanes are flagged
    # shadow rays with finite caps, the rest closest-hit rays capped at BG.
    tris = _soup(900)
    n = 8 * 128 * 2
    o, d = _rays(n, seed=21)
    rng = np.random.default_rng(23)
    cap = np.full(n, BG, np.float32)
    cap[: n // 2] = rng.uniform(1.0, 30.0, n // 2).astype(np.float32)
    ah = np.zeros(n, bool)
    ah[: n // 2] = True
    bkw = dict(host_tris=tris, leaf_size=4, width=8, max_tris=128, sublanes=8)
    jb = jtreelets.treelet_backend(interpret=True, **bkw)
    tb = ttreelets.treelet_backend(device="cpu", **bkw)
    assert tb.self_sorting and tb.meta.num_treelets == jb.meta.num_treelets >= 2
    ref = jb.bind_capped(jb.arrays)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cap), jnp.asarray(ah))
    got = tb.bind_capped(tb.arrays)(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(cap),
                                    torch.from_numpy(ah))
    _judge(ref, got, any_lanes=ah)
    assert got.hit.numpy()[: n // 2].any() and got.hit.numpy()[n // 2:].any()


def test_plain_k3_holds_the_contract(soup):
    # Misses keep their cap in row 0 and prim -1; any-hit lanes that hit
    # hold t = 0; parked (cap 0) lanes never hit; the CPU call is uncounted.
    _, _, ttt = soup
    p = 8 * 128
    o, d = _rays(2 * p, seed=5)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    cap = torch.full((2 * p,), 30.0)
    cap[:64] = 0.0
    k = ttt.num_treelets
    seg_list = torch.arange(k, dtype=torch.int32).repeat(2, 1)
    seg_entry = torch.zeros((2, k), dtype=torch.float32)
    seg_gmask = torch.ones((2, k, 1), dtype=torch.int32)
    before = dict(ttk.LAUNCHES)
    outs = {}
    for any_hit in (False, True):
        outs[any_hit] = ttk.packet_intersect_segments(
            ttt, seg_list, seg_entry, seg_gmask, o, d, cap, any_hit=any_hit, sublanes=8)
    assert ttk.LAUNCHES == before
    closest, anyh = outs[False], outs[True]
    miss = closest[3] < 0
    assert not (closest[3][:64] >= 0).any() and not (anyh[3][:64] >= 0).any()
    assert torch.equal(closest[0][miss], cap[miss])
    assert torch.equal(anyh[3] >= 0, closest[3] >= 0)
    assert (anyh[0][anyh[3] >= 0] == 0).all()
    # Against the whole-scene brute force: every treelet is a step here.
    v = [torch.from_numpy(x) for x in _soup(900)]
    from raytracer3_tpu_torch.ops import intersect as tintersect

    hb = tintersect.intersect_bruteforce(o, d, *v)
    want = hb.hit & (hb.t < cap)
    assert torch.equal(closest[3] >= 0, want)
    assert torch.equal(closest[3][want].to(torch.int32), hb.prim_id[want])


def test_segment_wrapper_checks_inputs(soup):
    _, _, ttt = soup
    o, d = (torch.from_numpy(a) for a in _rays(8 * 128))
    cap = torch.full((8 * 128,), 30.0)
    k = ttt.num_treelets
    sl = torch.zeros((1, k), dtype=torch.int32)
    se = torch.zeros((1, k), dtype=torch.float32)
    sg = torch.ones((1, k, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttk.packet_intersect_segments(ttt, sl.long(), se, sg, o, d, cap, sublanes=8)
    with pytest.raises(ValueError):  # rays do not fill the segments
        ttk.packet_intersect_segments(ttt, sl, se, sg, o[:-1], d[:-1], cap[:-1], sublanes=8)
    with pytest.raises(ValueError):
        ttk.packet_intersect_segments(ttt, sl, se, sg, o, d, cap.double(), sublanes=8)
    with pytest.raises(ValueError):
        ttk.packet_intersect_segments(ttt._replace(node_tables=ttt.node_tables.numpy()), sl, se, sg, o, d, cap,
                                      sublanes=8)


def test_packet_backend_routes_large_scenes_to_treelets(monkeypatch):
    tris = _atrium1()
    small = ttk.packet_backend(host_tris=tris, device="cpu")
    assert not small.self_sorting and small.primary_fn is None and small.meta.leaf_size == 12
    # The threshold scaled down so the 5k-triangle atrium is "large".
    monkeypatch.setattr(ttk, "TREELET_ROUTE_BYTES", 64 * 1024)
    big = ttk.packet_backend(host_tris=tris, device="cpu")
    assert big.self_sorting and big.primary_fn is not None and big.capped_fn is not None
    assert isinstance(big.meta, ttreelets.TreeletTables)
    assert big.meta.leaf_size == 24 and big.meta.width == 16
    # The reference routes the same way at the same scaled threshold.
    monkeypatch.setattr(jtk, "CLUSTERS_VMEM_LIMIT", 64 * 1024)
    monkeypatch.setattr(jtreelets, "treelet_backend", lambda **kw: ("treelets", kw["width"]))
    assert jtk.packet_backend(host_tris=tris) == ("treelets", 16)


def test_treelet_route_threshold_is_the_reference_limit():
    assert ttk.TREELET_ROUTE_BYTES == jtk.CLUSTERS_VMEM_LIMIT


@pytest.mark.gpu
def test_k3_kernel_matches_plain_on_card(soup, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _, _, ttt_cpu = soup
    ttt = ttreelets.tables_to_device(ttt_cpu, "cuda")
    n = 8 * 128 * 4
    o, d = (torch.from_numpy(a).cuda() for a in _rays(n, seed=3))
    tmax = torch.from_numpy(np.random.default_rng(4).uniform(1.0, 30.0, n).astype(np.float32)).cuda()
    ah = torch.arange(n, device="cuda") % 2 == 0
    for kw in (dict(), dict(step_cull=True), dict(t_max=tmax, any_hit=True, step_cull=True),
               dict(t_max=tmax, anyhit_mask=ah, step_cull=True)):
        before = dict(ttk.LAUNCHES)
        k = ttreelets.treelet_intersect(ttt, o, d, sublanes=8, **kw)
        # Width 8 / leaf 4 is a shape the walk kernels are not compiled for.
        key = "seg_any_general" if kw.get("any_hit") else "seg_closest_general"
        assert ttk.LAUNCHES[key] == before[key] + 1
        with monkeypatch.context() as mp:
            mp.setattr(ttk, "packet_intersect_segments", ttk.packet_intersect_segments_plain)
            p = ttreelets.treelet_intersect(ttt, o, d, sublanes=8, **kw)
        torch.cuda.synchronize()
        assert (k.hit != p.hit).sum().item() <= max(2, n // 500)
        m = k.hit & p.hit
        if "anyhit_mask" in kw:
            m &= ~ah
        if not kw.get("any_hit"):
            torch.testing.assert_close(k.t[m], p.t[m], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_size", [12, 24])
def test_k3_walk_kernel_on_card(leaf_size):
    """The walk kernel of K3 (width 16, leaf 12 and 24) and its counting
    form on the card: rows and counts equal ``segments_traverse_plain``'s
    and the general loop's to the bit, the launch counted as the walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(4000, seed=2), leaf_size=leaf_size, width=16, max_tris=2048), "cuda")
    assert tt.num_treelets >= 2 and ttk.trace_loop(tt.width, tt.leaf_size, group_rays=1024) == "walk"
    n = 8 * 128 * 4
    o, d = (torch.from_numpy(a).cuda() for a in _rays(n, seed=3))
    tmax = torch.from_numpy(np.random.default_rng(4).uniform(1.0, 30.0, n).astype(np.float32)).cuda()
    tmax[::7] = 0.0  # parked lanes
    ah = torch.arange(n, device="cuda") % 2 == 0
    for kw in (dict(), dict(step_cull=True), dict(t_max=tmax, step_cull=True),
               dict(t_max=tmax, anyhit_mask=ah, step_cull=True)):
        sl = ttreelets.segment_launch(tt, o, d, sublanes=8, **kw)
        before = dict(ttk.LAUNCHES)
        rows = sl.launch(tt)
        counted, counts = sl.launch(tt, stats=True)
        assert ttk.LAUNCHES["seg_closest"] == before["seg_closest"] + 1
        assert ttk.LAUNCHES["seg_closest_stats"] == before["seg_closest_stats"] + 1
        # The general loop on the same launch, through the launcher the
        # wrapper uses (the wrapper itself picks the walk for this shape).
        old, old_counts = ttk._launch_segments(
            ttk.load_kernels(), tt, sl.seg_list, sl.seg_entry, sl.seg_gmask, sl.origins, sl.directions, sl.t_cap,
            sl.anyhit_row, sl.kw["t_min"], False, sl.kw["step_cull"], sl.kw["sublanes"], sl.kw["max_groups"], True,
            "general", torch.cuda.current_stream().cuda_stream)
        assert ttk.LAUNCHES["seg_closest_general"] == before["seg_closest_general"]
        ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
        torch.cuda.synchronize()
        assert torch.equal(rows, counted) and torch.equal(rows, old) and torch.equal(rows, ref)
        assert torch.equal(counts, old_counts) and torch.equal(counts, ref_counts)
        assert int((rows[3] >= 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_size", [12, 24])
def test_k3_any_walk_kernel_on_card(leaf_size):
    """The any-hit walk of K3 (width 16, leaf 12 and 24) and its counting
    form on the card: rows and counts equal the general loop's and
    ``segments_traverse_plain(any_hit=True)``'s to the bit, the launch
    counted as the walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(4000, seed=2), leaf_size=leaf_size, width=16, max_tris=2048), "cuda")
    n = 8 * 128 * 4
    o, d = (torch.from_numpy(a).cuda() for a in _rays(n, seed=5))
    tmax = torch.from_numpy(np.random.default_rng(6).uniform(1.0, 30.0, n).astype(np.float32)).cuda()
    tmax[::7] = 0.0  # parked lanes
    tmax[3::11] = 1e-4  # capped at t_min
    for kw in (dict(), dict(step_cull=True), dict(t_max=tmax, step_cull=True)):
        sl = ttreelets.segment_launch(tt, o, d, sublanes=8, any_hit=True, **kw)
        before = dict(ttk.LAUNCHES)
        rows = sl.launch(tt)
        counted, counts = sl.launch(tt, stats=True)
        assert ttk.LAUNCHES["seg_any"] == before["seg_any"] + 1
        assert ttk.LAUNCHES["seg_any_stats"] == before["seg_any_stats"] + 1
        old, old_counts = ttk._launch_segments(
            ttk.load_kernels(), tt, sl.seg_list, sl.seg_entry, sl.seg_gmask, sl.origins, sl.directions, sl.t_cap,
            sl.anyhit_row, sl.kw["t_min"], True, sl.kw["step_cull"], sl.kw["sublanes"], sl.kw["max_groups"], True,
            "general", torch.cuda.current_stream().cuda_stream)
        assert ttk.LAUNCHES["seg_any_general"] == before["seg_any_general"]
        ref, ref_counts = sl.launch(tt, fn=ttk.segments_traverse_plain, stats=True)
        torch.cuda.synchronize()
        assert torch.equal(rows, counted) and torch.equal(rows, old) and torch.equal(rows, ref)
        assert torch.equal(counts, old_counts) and torch.equal(counts, ref_counts)
        assert 0 < int((rows[3] >= 0).sum()) < n
