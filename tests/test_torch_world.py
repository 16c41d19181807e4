"""The port's World and GLB ingest against the JAX reference.

The atrium ``detail=1`` is written to a GLB under ``tmp_path``, loaded
through the processed-asset cache and registered in both packages' Worlds;
every Scene field and the host triangles must be bit-equal, including the
pool's power-of-two padding with degenerate triangles. The port's own
copies of the reference's numpy modules are held to it directly: the
``atrium`` and ``sky_equirect`` arrays bit-equal, ``write_glb_multi`` bytes
and ``load_glb_cached`` arrays equal, ``GeometryPool.flatten`` equal.
"""

import os

import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.app import world as jworld
from raytracer3_tpu.scene import assets, gltf
from raytracer3_tpu.scene import pools as jpools
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.app import world as tworld
from raytracer3_tpu_torch.scene import assets as tassets
from raytracer3_tpu_torch.scene import gltf as tgltf
from raytracer3_tpu_torch.scene import pools as tpools
from raytracer3_tpu_torch.scene import procedural as tprocedural
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    kw = jprocedural.atrium(detail=1)
    path = os.path.join(d, "atrium_d1.glb")
    gltf.write_glb_multi(
        path, kw["positions"], kw["normals"], kw["uvs"], kw["indices"], kw["geo_id"],
        kw["base_color"], kw["emission"], kw["metallic"], kw["roughness"],
    )
    return str(d), assets.load_glb_cached(path, cache_dir=str(d))


def _populate(w, md, sky, moved=False):
    mesh = w.add_mesh_data(md)
    w.spawn(mesh, name="atrium")
    if moved:
        # A second, moved instance, then one despawned: the pool's
        # bookkeeping must flatten the same way in both packages.
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (0.5, -1.0, 2.0)
        e = w.spawn(mesh, name="copy")
        w.set_transform(e, t)
        gone = w.spawn(mesh, name="gone")
        w.despawn(gone)
    w.env_map = sky
    return w


def _assert_fields_equal(got, ref, prefix=""):
    for name in got._fields:
        g = getattr(got, name)
        r = getattr(ref, name, None)
        if hasattr(g, "_fields"):
            _assert_fields_equal(g, r, prefix + name + ".")
            continue
        if g is None:
            assert r is None, prefix + name
            continue
        g = g.numpy()
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (prefix + name, g.dtype, r.dtype, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=prefix + name)


@pytest.mark.parametrize("moved", [False, True])
def test_world_scene_bit_equal(atrium_glb, moved):
    _, md = atrium_glb
    sky = jprocedural.sky_equirect(32, 64)
    ref_w = _populate(jworld.World(), md, sky, moved)
    got_w = _populate(tworld.World(), md, sky, moved)
    ref, got = ref_w.scene(), got_w.scene(device="cpu")
    # The pool pads to power-of-two capacity with degenerate triangles.
    real = int(got_w._host_flat["real_tri_count"])
    assert got.indices.shape[0] > real
    _assert_fields_equal(got, ref)
    for a, b in zip(got_w._host_tris(), ref_w._host_tris()):
        assert a.shape[0] == real
        np.testing.assert_array_equal(a, np.asarray(b))


def test_world_rebuilds_when_structure_changes(atrium_glb):
    _, md = atrium_glb
    w = _populate(tworld.World(), md, None)
    s1 = w.scene(device="cpu")
    assert w.scene(device="cpu") is s1 and not w.dirty
    e = w.spawn(w.add_mesh_data(md))
    assert w.dirty
    s2 = w.scene(device="cpu")
    assert s2 is not s1 and s2.indices.shape[0] >= s1.indices.shape[0]
    w.despawn(e)
    assert w.dirty


def test_sponza_world_scene_is_the_world_path(atrium_glb, tmp_path):
    _, md = atrium_glb
    scene, tris = tprocedural.sponza_world_scene(detail=1, device="cpu", cache_dir=str(tmp_path))
    assert os.path.exists(tmp_path / "bench_atrium_d1.glb")
    ref_w = _populate(jworld.World(), md, jprocedural.sky_equirect(256, 512))
    _assert_fields_equal(scene, ref_w.scene())
    for a, b in zip(tris, ref_w._host_tris()):
        np.testing.assert_array_equal(a, np.asarray(b))
    # A second call reads the GLB and its processed cache back.
    scene2, _ = tprocedural.sponza_world_scene(detail=1, device="cpu", cache_dir=str(tmp_path))
    assert torch.equal(scene2.shade_table, scene.shade_table)


@pytest.mark.parametrize("method", ["load_glb_async", "update"])
def test_later_parts_raise(method, tmp_path):
    # Both are ported (tests/test_torch_assets.py drives them): a fresh
    # World's update spawns nothing, and a load whose worker fails raises
    # from the pipeline's next poll, in both packages.
    for world_mod in (tworld, jworld):
        w = world_mod.World()
        if method == "update":
            assert w.update() == []
            continue
        w.load_glb_async(str(tmp_path / "missing.glb"))
        with pytest.raises(FileNotFoundError):
            w._assets.wait_all(timeout=60)


def _assert_dicts_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("detail,seed", [(1, 0), (2, 0), (1, 5)])
def test_atrium_generator_bit_equal(detail, seed):
    _assert_dicts_equal(tprocedural.atrium(detail=detail, seed=seed), jprocedural.atrium(detail=detail, seed=seed))


@pytest.mark.parametrize("size,sun", [((32, 64), (0.35, 0.55, 0.2)), ((256, 512), (-0.3, 0.8, 0.1))])
def test_sky_generator_bit_equal(size, sun):
    got, ref = tprocedural.sky_equirect(*size, sun_dir=sun), jprocedural.sky_equirect(*size, sun_dir=sun)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("part", ["cylinder", "box", "patch"])
def test_generator_parts_bit_equal(part):
    args = {
        "cylinder": ("_cylinder", ((0.5, 0.0, -1.0), 0.45, 6.0, 24, 8)),
        "box": ("_box_tris", ((-0.6, 5.9, -0.6), (0.6, 6.4, 0.6))),
        "patch": ("_grid_patch", ((-8, 8.45, -3), (16, 0, 0), (0, 0, 6), 4, 3)),
    }[part]
    for g, r in zip(getattr(tprocedural, args[0])(*args[1]), getattr(jprocedural, args[0])(*args[1])):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_glb_writer_and_cache_match_reference(tmp_path):
    kw = jprocedural.atrium(detail=1)
    fields = [kw[k] for k in ("positions", "normals", "uvs", "indices", "geo_id", "base_color", "emission",
                              "metallic", "roughness")]
    blob = tgltf.write_glb_multi(str(tmp_path / "t.glb"), *fields)
    assert blob == gltf.write_glb_multi(None, *fields)
    assert (tmp_path / "t.glb").read_bytes() == blob
    # Each package's cache, then each reading the other's cache file.
    ref = assets.load_glb_cached(str(tmp_path / "t.glb"), cache_dir=str(tmp_path / "ref"))
    got = tassets.load_glb_cached(str(tmp_path / "t.glb"), cache_dir=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(os.listdir(tmp_path / "port"))
    again = tassets.load_glb_cached(str(tmp_path / "t.glb"), cache_dir=str(tmp_path / "ref"))
    for md in (got, again):
        for name in ("positions", "normals", "uvs", "indices", "geo_id", "base_color", "emission", "metallic",
                     "roughness", "base_color_texture"):
            a, b = getattr(md, name), getattr(ref, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert md.textures is None and md.tex_images is None and md.colors is None
    assert not [f for f in os.listdir(tmp_path / "port") if "tmp" in f]


def test_geometry_pool_flatten_matches_reference():
    pools = [jpools.GeometryPool(), tpools.GeometryPool()]
    for pool in pools:
        r = np.random.default_rng(2)
        handles = []
        for v, t in (jprocedural._box_tris((-1, 0, -1), (1, 2, 1)), jprocedural._cylinder((0, 0, 0), 0.5, 2.0, 8, 2)):
            nrm = r.normal(size=v.shape).astype(np.float32)
            colors = r.uniform(size=v.shape).astype(np.float32) if len(handles) else None
            handles.append(pool.add_mesh(v, nrm, r.uniform(size=(len(v), 2)), t, r.integers(0, 3, len(t)),
                                         colors=colors))
        ids = [pool.add_instance(handles[k % 2], r.normal(size=(4, 4)).astype(np.float32)) for k in range(5)]
        pool.set_transform(ids[1], np.diag([2.0, 1.0, 0.5, 1.0]).astype(np.float32))
        pool.remove_instance(ids[3])
    ref, got = pools[0], pools[1]
    for attr in ("version", "structural_version", "transform_version", "instance_count"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for pad in (True, False):
        _assert_dicts_equal(got.flatten(pad=pad), ref.flatten(pad=pad))


# ---------------------------------------------------------------------------
# Trace backends of the World, and brute_backend on host triangles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cornell_host():
    from raytracer3_tpu.scene import analytic as janalytic

    sc = janalytic.cornell_box()
    mats = {k: list(np.asarray(getattr(sc.materials, k))) for k in ("base_color", "emission", "metallic", "roughness")}
    mesh = tuple(np.asarray(getattr(sc, k)) for k in ("positions", "normals", "uvs", "indices", "geo_id"))
    rng = np.random.default_rng(21)
    o = rng.uniform(-0.8, 0.8, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return mats, mesh, o, d


def _cornell_world(cornell_host):
    mats, mesh, _, _ = cornell_host
    w = tworld.World()
    for i in range(len(mats["base_color"])):
        w.add_material(*(mats[k][i] for k in ("base_color", "emission", "metallic", "roughness")))
    w.spawn(w.add_mesh(*mesh))
    return w


def _assert_hits_close(got, ref):
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-6)


def test_brute_backend_takes_host_triangles(cornell_host):
    # The reference's World hands the brute-force backend numpy triangles
    # (raytracer3_tpu/app/world.py:345); the port's takes them too.
    from raytracer3_tpu.ops import intersect as jintersect
    from raytracer3_tpu_torch.ops import intersect as tintersect

    _, (pos, _, _, idx, _), o, d = cornell_host
    tris = (pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]])
    assert all(isinstance(t, np.ndarray) for t in tris)
    tb = tintersect.brute_backend(tris=tris, device="cpu")
    jb = jintersect.brute_backend(tris=tris)
    assert all(tb.arrays[k].dtype == torch.float32 and tb.arrays[k].device.type == "cpu" for k in ("v0", "v1", "v2"))
    got = tb.intersect(torch.from_numpy(o), torch.from_numpy(d))
    ref = jb.intersect(o, d)
    _assert_hits_close(got, ref)
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(ref.prim_id))
    t_max = torch.full((512,), 0.5)
    np.testing.assert_array_equal(tb.occluded(torch.from_numpy(o), torch.from_numpy(d), t_max).numpy(),
                                  np.asarray(jb.occluded(o, d, np.full(512, 0.5, np.float32))))


@pytest.mark.parametrize("kind", ["auto", "brute", "packet", "treelet"])
def test_trace_backend_kinds_on_cpu(cornell_host, kind):
    from raytracer3_tpu.ops import intersect as jintersect
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk
    from raytracer3_tpu_torch.ops import treelets as ttreelets

    w = _cornell_world(cornell_host)
    kw = {"max_tris": 4096} if kind == "treelet" else {}
    b = w.trace_backend(kind, device="cpu", **kw)
    real = w._host_tris()
    if kind in ("auto", "brute"):
        # auto is brute force on the CPU, over the real triangles only.
        assert sorted(b.arrays) == ["v0", "v1", "v2"] and b.arrays["v0"].shape[0] == real[0].shape[0]
    elif kind == "packet":
        assert isinstance(b.meta, ttk.PacketTables) and not b.self_sorting
    else:
        assert isinstance(b.meta, ttreelets.TreeletTables) and b.self_sorting
    _, _, o, d = cornell_host
    _assert_hits_close(b.intersect(torch.from_numpy(o), torch.from_numpy(d)),
                       jintersect.brute_backend(tris=real).intersect(o, d))


def test_cluster_backend_is_not_ported(cornell_host):
    # The name is the refusal this test used to hold; the "cluster" kind is
    # ported now (ops/cluster_bvh.cluster_backend / make_cluster_backend).
    # Its hits, and those of the "bvh" kind (ops/traverse.make_bvh_backend),
    # are the brute-force kind's over the same scene.
    from raytracer3_tpu_torch.ops import cluster_bvh as tcluster

    w = _cornell_world(cornell_host)
    _, _, o, d = cornell_host
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    bi, bo = w.backend("brute", device="cpu")
    want = bi(o, d)
    tmax = torch.full((o.shape[0],), 0.5)
    tb = w.trace_backend("cluster", device="cpu")
    assert isinstance(tb.meta, tcluster.ClusterBVH) and sorted(tb.arrays) == ["boxes", "clusters", "nodes", "tids"]
    for isect, occl in ((tb.intersect, tb.occluded), w.backend("cluster", device="cpu"),
                        w.backend("bvh", device="cpu")):
        got = isect(o, d)
        np.testing.assert_array_equal(got.hit.numpy(), want.hit.numpy())
        np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(occl(o, d, tmax).numpy(), bo(o, d, tmax).numpy())


def test_world_backend_brute_renders(cornell_host):
    # tests/test_world_pools.py's brute-force World render on the port.
    from raytracer3_tpu_torch.render import pathtracer
    from raytracer3_tpu_torch.scene import analytic as tanalytic
    from raytracer3_tpu_torch.utils.config import RenderSettings

    w = _cornell_world(cornell_host)
    scene = w.scene(device="cpu")
    isect, occl = w.backend("brute", device="cpu")
    s = RenderSettings(width=8, height=8, bounces=2, samples=1, diffuse_only=True)
    img = pathtracer.render_image(scene, tanalytic.default_camera(device="cpu"), s, 0, isect, occl)
    assert bool(img.isfinite().all()) and float(img.max()) > 0


def test_world_backend_packet_and_its_cache(cornell_host):
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk

    w = _cornell_world(cornell_host)
    isect, occl = w.backend("packet", device="cpu")
    assert w.backend("packet", device="cpu")[0] is isect  # cached while the scene is
    _, _, o, d = cornell_host
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    bi, bo = w.backend("brute", device="cpu")
    np.testing.assert_array_equal(isect(o_t, d_t).hit.numpy(), bi(o_t, d_t).hit.numpy())
    t_max = torch.full((512,), 0.5)
    np.testing.assert_array_equal(occl(o_t, d_t, t_max).numpy(), bo(o_t, d_t, t_max).numpy())
    # make_packet_backend's tables are packet_backend's, unrouted.
    _, _, pt = ttk.make_packet_backend(host_tris=w._host_tris(), device="cpu")
    pb = w.trace_backend("packet", device="cpu")
    assert torch.equal(pt.node_table, pb.arrays["nodes"]) and torch.equal(pt.cluster_table, pb.arrays["clusters"])
    # A structural edit rebuilds the backend with the scene.
    w.spawn(w.add_mesh(*cornell_host[1]))
    assert w.dirty and w.backend("brute", device="cpu")[0] is not bi
