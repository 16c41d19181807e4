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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU build of torch can return one worker's chunk of its first
    # multi-threaded torch.sqrt at ~3e-4 relative error; plain torch does it
    # without jax (ROADMAP.md Queue 3). Torch runs on the calling thread only.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
