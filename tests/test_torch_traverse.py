"""The port's cluster-BVH tables and K1/K2 traversal against the JAX
reference.

Tables built on the same numpy geometry must be bit-equal. Traversal runs the
kernel's plain version here (CPU tensors) against the reference's Pallas
kernel in interpret mode (``interpret=True, sublanes=8``, as
tests/test_traverse_kernel.py runs it), both on the reference's tables, and
is judged by that file's rule: hit-mask mismatches ≤ max(2, n/500), t within
rtol 1e-4, ≥ 90% of mutual hits on the same prim, uv within rtol 1e-3 where
the prims agree (the two may differ only on exact-t ties and grazing rays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import cluster_bvh as jcluster
from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops.pallas import traverse_kernel as jtk
from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.ops import cluster_bvh as tcluster
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

SUBLANES = 8


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _host_tris(scene):
    return tuple(np.asarray(t) for t in scene.tri_vertices())


@pytest.fixture(scope="module")
def cornell():
    scene = janalytic.cornell_box()
    tris = _host_tris(scene)
    jpt = jtk.pack_tables_host(jcluster.build_cluster_bvh_host(*tris, 12, width=16, cluster_mode="sah"))
    return janalytic.default_camera(), tris, jpt, ttk.tables_from_numpy(jpt, "cpu")


@pytest.mark.parametrize("which", ["cornell", "atrium1"])
def test_host_tables_bit_equal(which):
    if which == "cornell":
        tris = _host_tris(janalytic.cornell_box())
    else:
        kw = jprocedural.atrium(detail=1)
        p, i = kw["positions"], kw["indices"]
        tris = (p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])
    jcb = jcluster.build_cluster_bvh_host(*tris, 12, width=16, cluster_mode="sah")
    tcb = tcluster.build_cluster_bvh_host(*tris, 12, width=16, cluster_mode="sah")
    np.testing.assert_array_equal(tcb.tri_id, np.asarray(jcb.tri_id))
    np.testing.assert_array_equal(tcb.cluster_table, np.asarray(jcb.cluster_table))
    jpt, tpt = jtk.pack_tables_host(jcb), ttk.pack_tables_host(tcb)
    np.testing.assert_array_equal(tpt.node_table, np.asarray(jpt.node_table))
    np.testing.assert_array_equal(tpt.cluster_table, np.asarray(jpt.cluster_table))
    for field in ("leaf_size", "num_nodes", "num_clusters", "width", "depth", "leaf_aabb"):
        assert getattr(tpt, field) == getattr(jpt, field), field


def test_build_raises_without_native_library(cornell, monkeypatch, tmp_path):
    # No Morton or device-LBVH fallback: those give other trees. The port
    # builds its own library; with no compiler and nothing built, it raises.
    from raytracer3_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-rt3")
    with pytest.raises(RuntimeError):
        tcluster.build_cluster_bvh_host(*cornell[1], 12, width=16, cluster_mode="sah")


def _primary(cam, n):
    side = int(np.ceil(np.sqrt(n)))
    pix = jcamera.pixel_grid(side, side)[:n]
    o, d = jcamera.primary_rays(cam, side, side, jitter=jnp.full((n, 2), 0.5), pixel_xy=pix)
    return np.array(o), np.array(d)


def _secondary(n, seed=7):
    r = np.random.default_rng(seed)
    o = (r.uniform(-0.8, 0.8, (n, 3)) + [0, 1, 0]).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _both(jpt, tpt, o, d, **kw):
    tkw = dict(kw)
    if "t_max" in kw:
        kw["t_max"] = jnp.asarray(kw["t_max"])
        tkw["t_max"] = torch.from_numpy(np.ascontiguousarray(tkw["t_max"], np.float32))
    ref = jtk.packet_intersect(jpt, jnp.asarray(o), jnp.asarray(d), interpret=True, sublanes=SUBLANES, **kw)
    got = ttk.packet_intersect(tpt, torch.from_numpy(o), torch.from_numpy(d), **tkw)
    return ref, got


def _judge(ref, got):
    h, rh = got.hit.numpy(), np.asarray(ref.hit)
    n = h.shape[0]
    assert (h != rh).sum() <= max(2, n // 500), f"{(h != rh).sum()} / {n} hit-mask mismatches"
    m = h & rh
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-4, atol=1e-5)
    same = m & (got.prim_id.numpy() == np.asarray(ref.prim_id))
    assert same.sum() > 0.9 * m.sum()
    np.testing.assert_allclose(got.uv.numpy()[same], np.asarray(ref.uv)[same], rtol=1e-3, atol=1e-4)
    # Misses report the background depth and prim -1, as the reference.
    assert (got.prim_id.numpy()[~h] == -1).all()
    assert (got.t.numpy()[~h] == jtk._BG).all()


@pytest.mark.parametrize("rays", ["primary", "secondary"])
def test_closest_hit_matches_reference(cornell, rays):
    cam, _, jpt, tpt = cornell
    n = SUBLANES * 128
    o, d = _primary(cam, n) if rays == "primary" else _secondary(n)
    ref, got = _both(jpt, tpt, o, d)
    assert got.hit.numpy().mean() > 0.5
    _judge(ref, got)


@pytest.mark.parametrize("scale,expect_hit", [(1.05, True), (0.95, False)])
def test_any_hit_caps_match_reference(cornell, scale, expect_hit):
    cam, _, jpt, tpt = cornell
    o, d = _primary(cam, SUBLANES * 128)
    closest = ttk.packet_intersect(tpt, torch.from_numpy(o), torch.from_numpy(d))
    t_ref = closest.t.numpy()
    tmax = np.where(t_ref < 1e4, t_ref * scale, 1e-3).astype(np.float32)
    ref, got = _both(jpt, tpt, o, d, t_max=tmax, any_hit=True)
    g, r = got.hit.numpy(), np.asarray(ref.hit)
    assert (g != r).sum() <= 2
    mask = t_ref < 1e4
    assert g[mask].all() if expect_hit else not g[mask].any()


def test_parked_rays_never_hit(cornell):
    _, _, jpt, tpt = cornell
    n = 300
    o = np.full((n, 3), 1e30, np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    o[:100] = [0.0, 1.0, 0.0]  # inside the box, but with cap 0: parked too
    ref, got = _both(jpt, tpt, o, d, t_max=np.zeros(n, np.float32))
    assert not got.hit.numpy().any() and not np.asarray(ref.hit).any()
    _, got_any = _both(jpt, tpt, o, d, t_max=np.zeros(n, np.float32), any_hit=True)
    assert not got_any.hit.numpy().any()


@pytest.mark.parametrize("fn", ["intersect", "occluded", "capped"])
def test_brute_backend_matches_reference(cornell, fn):
    _, tris, _, _ = cornell
    o, d = _secondary(2048, seed=11)
    tmax = np.random.default_rng(12).uniform(0.05, 2.0, 2048).astype(np.float32)
    jb = jintersect.brute_backend(host_tris=tris)
    tb = tintersect.brute_backend(tris=tuple(torch.from_numpy(np.array(t)) for t in tris), device="cpu")
    jo, jd, to_, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    if fn == "occluded":
        np.testing.assert_array_equal(tb.occluded(to_, td, torch.from_numpy(tmax)).numpy(),
                                      np.asarray(jb.occluded(jo, jd, jnp.asarray(tmax))))
        return
    if fn == "intersect":
        ref, got = jb.intersect(jo, jd), tb.intersect(to_, td)
    else:
        ref = jb.capped_fn(jb.arrays, jo, jd, jnp.asarray(tmax))
        got = tb.capped_fn(tb.arrays, to_, td, torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(ref.prim_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-6)
    h = got.hit.numpy()
    np.testing.assert_allclose(got.uv.numpy()[h], np.asarray(ref.uv)[h], rtol=1e-4, atol=1e-5)


def test_cpu_calls_run_the_plain_version_uncounted(cornell):
    cam, _, _, tpt = cornell
    o, d = (torch.from_numpy(a) for a in _primary(cam, 256))
    before = dict(ttk.LAUNCHES)
    a = ttk.packet_intersect(tpt, o, d)
    b = ttk.packet_intersect_plain(tpt, o, d)
    assert ttk.LAUNCHES == before
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


def test_wrapper_checks_inputs(cornell):
    cam, _, _, tpt = cornell
    o, d = (torch.from_numpy(a) for a in _primary(cam, 64))
    with pytest.raises(ValueError):
        ttk.packet_intersect(tpt, o.double(), d)
    with pytest.raises(ValueError):
        ttk.packet_intersect(tpt, o.t().contiguous().t(), d)  # not contiguous
    with pytest.raises(ValueError):
        ttk.packet_intersect(tpt, o, d, t_max=torch.ones(3))
    with pytest.raises(ValueError):
        ttk.packet_intersect(tpt._replace(node_table=tpt.node_table.numpy()), o, d)


def test_backend_routes(cornell):
    _, tris, _, _ = cornell
    # force_treelets takes the treelet path with its own defaults, as the
    # reference's packet_backend does.
    t = ttk.packet_backend(host_tris=tris, force_treelets=True, device="cpu")
    assert t.self_sorting and t.primary_fn is not None
    assert t.meta.leaf_size == 24 and t.meta.width == 16
    b = ttk.packet_backend(host_tris=tris, device="cpu")
    assert not b.self_sorting and b.primary_fn is None
    assert b.meta.width == 16 and b.meta.leaf_size == 12
    assert b.arrays["nodes"].device.type == "cpu"


def test_packet_backend_cuda_raises_without_gpu(cornell):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this test covers the CPU-only case")
    _, tris, _, _ = cornell
    with pytest.raises(RuntimeError):
        ttk.packet_backend(host_tris=tris, device="cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cornell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cam, _, _, tpt_cpu = cornell
    tpt = ttk.tables_from_numpy(tpt_cpu, "cuda")
    for o, d in (_primary(cam, 4096), _secondary(4096)):
        o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
        k = ttk.packet_intersect(tpt, o, d)
        p = ttk.packet_intersect_plain(tpt, o, d)
        torch.cuda.synchronize()
        assert (k.hit != p.hit).sum().item() <= max(2, o.shape[0] // 500)
        m = k.hit & p.hit
        torch.testing.assert_close(k.t[m], p.t[m], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_k12_walk_kernels_on_card():
    # K1/K2 at the shape packet_backend builds (atrium detail=1, width 16,
    # leaf 12): the wrapper takes the walk and counts it; the walk and the
    # general loop give the same bits, and their K5 counts equal
    # traverse_plain's.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    kw = jprocedural.atrium(detail=1)
    p, i = kw["positions"], kw["indices"]
    jpt = jtk.pack_tables_host(jcluster.build_cluster_bvh_host(p[i[:, 0]], p[i[:, 1]], p[i[:, 2]], 12, width=16,
                                                                cluster_mode="sah"))
    pt = ttk.tables_from_numpy(jpt, "cuda")
    assert ttk.trace_loop(16, 12, single_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    rng = np.random.default_rng(11)
    n = 20000
    o = torch.from_numpy((rng.uniform(-5.0, 5.0, (n, 3)) + (0.0, 3.0, 0.0)).astype(np.float32)).cuda()
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).cuda(), dim=-1)
    cap = torch.from_numpy(rng.uniform(0.05, 12.0, n).astype(np.float32)).cuda()
    lib, stream = ttk.load_kernels(), torch.cuda.current_stream().cuda_stream
    for any_hit in (False, True):
        tm = cap if any_hit else torch.full((n,), ttk._BG, device="cuda")
        key = "any" if any_hit else "closest"
        before = dict(ttk.LAUNCHES)
        hit = ttk.packet_intersect(pt, o, d, t_max=tm, any_hit=any_hit)
        assert ttk.LAUNCHES[key] == before[key] + 1
        ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=tm, any_hit=any_hit)
        outs = {lp: ttk._launch_packet(lib, pt, o, d, tm, 1e-4, any_hit, True, lp, stream)
                for lp in ("walk", "general")}
        torch.cuda.synchronize()
        assert torch.equal(hit.prim_id, ref.prim_id) and torch.equal(hit.t, ref.t) and 0.05 * n < int(hit.hit.sum())
        for lp, out in outs.items():
            assert torch.equal(out[5], ref_counts), lp
            for a, b in zip(outs["walk"][:4], out[:4]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), lp
