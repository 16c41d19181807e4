"""The port's World and GLB ingest against the JAX reference.

The atrium ``detail=1`` is written to a GLB under ``tmp_path``, loaded
through the processed-asset cache and registered in both packages' Worlds;
every Scene field and the host triangles must be bit-equal, including the
pool's power-of-two padding with degenerate triangles.
"""

import os

import numpy as np
import pytest
import torch

from raytracer3_tpu.app import world as jworld
from raytracer3_tpu.scene import assets, gltf
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.app import world as tworld
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


@pytest.mark.parametrize("method", ["scene_instanced", "tlas_backend", "set_instance_material",
                                    "load_glb_async", "update"])
def test_later_parts_raise(method):
    with pytest.raises(NotImplementedError):
        getattr(tworld.World(), method)()
