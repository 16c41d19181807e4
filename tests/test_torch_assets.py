"""The port's ingest pieces against the JAX reference, on the CPU: the
background asset pipeline (``AsyncAssetPipeline``), ``World.load_glb_async``
and ``update``, ``blue_noise_cached``, ``mesh_to_scene`` (a textured,
vertex-coloured GLB mesh), and the image IO of ``utils/image.py`` (EXR and
PNG round-trips, EXR files of either package read bit-equal). Scenes are
compared field by field, bit-equal; images bit-equal."""

import os
import time

import numpy as np
import pytest

from raytracer3_tpu.app import world as jworld
from raytracer3_tpu.scene import assets as jassets
from raytracer3_tpu.scene import gltf as jgltf
from raytracer3_tpu.utils import image as jimage
from raytracer3_tpu_torch.app import world as tworld
from raytracer3_tpu_torch.scene import assets as tassets
from raytracer3_tpu_torch.scene import gltf as tgltf
from raytracer3_tpu_torch.utils import image as timage
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """The port's default asset cache moved into the test's directory."""
    d = str(tmp_path / "cache")
    monkeypatch.setattr(tassets, "_DEFAULT_CACHE_DIR", d)
    return d


def make_test_glb(path, colors=None, offset=0.0):
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32) + offset
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(np.asarray([0, 0, 1], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tgltf.write_glb(path, pos, idx, normals=nrm, uvs=uv, colors=colors)


def _pump(w, n, timeout=30.0):
    """update() like a frame loop until n entities landed."""
    deadline = time.time() + timeout
    spawned = []
    while len(spawned) < n and time.time() < deadline:
        spawned.extend(w.update())
        time.sleep(0.01)
    return spawned


class TestAsyncPipeline:
    def test_background_load_and_world_integration(self, tmp_path, cache_dir):
        paths = []
        for k in range(3):
            p = str(tmp_path / f"m{k}.glb")
            make_test_glb(p, offset=2.0 * k)
            paths.append(p)
        w = tworld.World()
        tickets = [w.load_glb_async(p, name=f"m{k}") for k, p in enumerate(paths)]
        assert len(set(tickets)) == 3
        spawned = _pump(w, 3)
        assert len(spawned) == 3 and w.pool.instance_count == 3
        assert {e.name for e in spawned} == {"m0", "m1", "m2"}
        assert w.update() == [] and w._assets.in_flight == 0
        assert w.scene(device="cpu").num_triangles >= 6
        assert len(os.listdir(cache_dir)) == 3  # one processed entry per source

    def test_worker_exception_surfaces_in_poll(self, tmp_path):
        p = str(tmp_path / "broken.glb")
        with open(p, "wb") as f:
            f.write(b"not a glb at all")
        pipe = tassets.AsyncAssetPipeline(cache_dir=str(tmp_path / "cache"))
        pipe.load(p)
        with pytest.raises(ValueError, match="not a GLB"):
            pipe.wait_all(timeout=30)
        assert pipe.in_flight == 0
        pipe.shutdown()

    def test_async_world_scene_equals_reference(self, tmp_path, cache_dir):
        """load_glb_async + update in both packages, a coloured mesh and a
        plain one with a transform: the flattened scenes bit-equal."""
        a, b = str(tmp_path / "a.glb"), str(tmp_path / "b.glb")
        make_test_glb(a, colors=np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32))
        make_test_glb(b)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (0.0, 0.0, 3.0)
        worlds = []
        for world_mod in (tworld, jworld):
            w = world_mod.World()
            w.load_glb_async(a, name="a")
            assert len(_pump(w, 1)) == 1  # spawn order stays fixed
            w.load_glb_async(b, transform=t, name="b")
            assert len(_pump(w, 1)) == 1
            worlds.append(w)
        got, ref = worlds[0].scene(device="cpu"), worlds[1].scene()
        assert got.shade_table.shape[1] == 32
        for name in ("positions", "indices", "geo_id", "shade_table", "mat_table", "vertex_colors"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


def test_blue_noise_cached_matches_reference(tmp_path):
    got = tassets.blue_noise_cached(size=16, cache_dir=str(tmp_path / "t"))
    again = tassets.blue_noise_cached(size=16, cache_dir=str(tmp_path / "t"))
    ref = jassets.blue_noise_cached(size=16, cache_dir=str(tmp_path / "j"))
    assert got.shape == (16, 16) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(again, got)
    # Each package reads the other's file.
    np.testing.assert_array_equal(tassets.blue_noise_cached(size=16, cache_dir=str(tmp_path / "j")), ref)


def test_mesh_to_scene_matches_reference(tmp_path):
    """A GLB mesh with COLOR_0, given native texture images (as the loader
    gives an embedded base-colour texture), through mesh_to_scene."""
    p = str(tmp_path / "quad.glb")
    make_test_glb(p, colors=np.asarray([[1, 0.5, 0.5]] * 4, np.float32))
    md = tgltf.load_glb(p)
    rng = np.random.default_rng(0)
    md.base_color_texture = np.zeros(1, np.int32)
    md.tex_images = [rng.random((24, 40, 3)).astype(np.float32)]
    sky = rng.random((8, 16, 3)).astype(np.float32)
    got = tgltf.mesh_to_scene(md, env_map=sky, device="cpu")
    ref = jgltf.mesh_to_scene(md, env_map=sky)
    for name in ("shade_table", "mat_table", "tex_atlas", "tex_meta", "vertex_colors", "env_sample_table"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert got.textures is None and ref.textures is None
    assert got.num_triangles == 2 and int(got.emissive.count) == int(ref.emissive.count)


class TestImage:
    def test_exr_roundtrip(self, tmp_path):
        p = str(tmp_path / "t.exr")
        img = np.random.default_rng(1).random((9, 13, 3)).astype(np.float32) * 50
        timage.write_exr(p, img)
        np.testing.assert_array_equal(timage.read_exr(p), img)

    def test_exr_files_of_either_package(self, tmp_path):
        img = np.random.default_rng(2).random((7, 11, 3)).astype(np.float32) * 10
        p, q = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
        timage.write_exr(p, img)
        jimage.write_exr(q, img)
        assert open(p, "rb").read() == open(q, "rb").read()
        got = timage.read_exr(q)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jimage.read_exr(q))
        np.testing.assert_array_equal(got, img)

    def test_exr_rejects_garbage(self, tmp_path):
        p = tmp_path / "g.exr"
        p.write_bytes(b"\x00" * 64)
        with pytest.raises(ValueError):
            timage.read_exr(str(p))

    def test_png_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        u8 = rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
        p = str(tmp_path / "u8.png")
        timage.write_png(p, u8)
        np.testing.assert_array_equal(timage.read_png(p), u8.astype(np.float32) / 255.0)
        f = rng.random((6, 10, 3)).astype(np.float32) * 1.2 - 0.1
        q, r = str(tmp_path / "f.png"), str(tmp_path / "f_ref.png")
        timage.write_png(q, f)
        jimage.write_png(r, f)
        np.testing.assert_array_equal(timage.read_png(q), jimage.read_png(r))
