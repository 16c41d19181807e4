"""Vertex colours (COLOR_0) in the port against the JAX reference, on the
CPU: the cases of ``tests/test_vertex_colors.py`` (GLB ingest of float VEC3
/ VEC4 and normalised u8 colours, the processed-asset cache, the 32-lane
shade rows and their interpolation into the albedo, the ``World`` path and
a render), with the port's ``write_glb`` byte-equal to the reference's.

Where the reference compares its two shading paths the port's fast path is
held against both of the reference's; ``TestSlowPath`` holds the port's
path for scenes without shade rows (``shade_table``/``mat_table`` None)
against the reference's and against the port's fast path. Tolerance:
``atol 1e-6`` (the reference's own; the atlas's rgb9e5 words part by an
ulp, ROADMAP.md Queue 3); scene fields bit-equal.
"""

import json
import struct

import numpy as np
import pytest
import torch

from raytracer3_tpu.app import world as jworld
from raytracer3_tpu.scene import gltf as jgltf
from raytracer3_tpu.scene import types as jtypes
from raytracer3_tpu_torch.app import world as tworld
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.scene import assets as tassets
from raytracer3_tpu_torch.scene import gltf as tgltf
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def quad_arrays():
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(np.asarray([0, 0, 1], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    col = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    return pos, idx, nrm, uv, col


def _write_both(tmp_path, name, **kw):
    """The port's GLB, checked byte-equal to the reference writer's."""
    pos, idx, nrm, uv, _ = quad_arrays()
    p, q = str(tmp_path / name), str(tmp_path / ("ref_" + name))
    tgltf.write_glb(p, pos, idx, normals=nrm, uvs=uv, **kw)
    jgltf.write_glb(q, pos, idx, normals=nrm, uvs=uv, **kw)
    assert open(p, "rb").read() == open(q, "rb").read()
    return p


class TestIngest:
    def test_vec3_roundtrip(self, tmp_path):
        col = quad_arrays()[4]
        md = tgltf.load_glb(_write_both(tmp_path, "c3.glb", colors=col))
        np.testing.assert_allclose(md.colors, col, atol=1e-6)

    def test_vec4_alpha_dropped(self, tmp_path):
        col = quad_arrays()[4]
        col4 = np.concatenate([col, np.full((4, 1), 0.5, np.float32)], axis=1)
        md = tgltf.load_glb(_write_both(tmp_path, "c4.glb", colors=col4))
        np.testing.assert_allclose(md.colors, col, atol=1e-6)

    def test_no_colors_is_none(self, tmp_path):
        assert tgltf.load_glb(_write_both(tmp_path, "plain.glb")).colors is None

    def test_normalized_u8(self, tmp_path):
        # COLOR_0 rewritten as normalised u8: the accessor's de-normalisation.
        col = quad_arrays()[4]
        p = _write_both(tmp_path, "u8.glb", colors=col)
        with open(p, "rb") as f:
            data = f.read()
        js, bin_chunk = tgltf._parse_glb(data)
        acc = js["accessors"][js["meshes"][0]["primitives"][0]["attributes"]["COLOR_0"]]
        bv = js["bufferViews"][acc["bufferView"]]
        u8 = np.round(col * 255).astype(np.uint8).tobytes()
        u8 += b"\0" * ((-len(u8)) % 4)
        blob = bytearray(bin_chunk)
        blob[bv["byteOffset"]: bv["byteOffset"] + len(u8)] = u8
        acc["componentType"] = 5121
        acc["normalized"] = True
        bv["byteLength"] = len(u8)
        jsb = json.dumps(js).encode()
        jsb += b" " * ((-len(jsb)) % 4)
        with open(p, "wb") as f:
            f.write(struct.pack("<III", tgltf._MAGIC, 2, 12 + 8 + len(jsb) + 8 + len(blob)))
            f.write(struct.pack("<II", len(jsb), tgltf._CHUNK_JSON))
            f.write(jsb)
            f.write(struct.pack("<II", len(blob), tgltf._CHUNK_BIN))
            f.write(bytes(blob))
        md = tgltf.load_glb(p)
        np.testing.assert_allclose(md.colors, col, atol=1 / 255.0)
        np.testing.assert_array_equal(md.colors, jgltf.load_glb(p).colors)

    def test_cache_roundtrip(self, tmp_path):
        col = quad_arrays()[4]
        p = _write_both(tmp_path, "c.glb", colors=col)
        md1 = tassets.load_glb_cached(p, cache_dir=str(tmp_path / "cache"))
        md2 = tassets.load_glb_cached(p, cache_dir=str(tmp_path / "cache"))
        np.testing.assert_allclose(md1.colors, col, atol=1e-6)
        np.testing.assert_array_equal(md2.colors, md1.colors)


def _scene_kw(colors=True, base=(0.5, 1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0)):
    pos, idx, nrm, uv, col = quad_arrays()
    return dict(positions=pos, normals=nrm, uvs=uv, indices=idx, geo_id=np.zeros(2, np.int32),
                base_color=np.asarray([base], np.float32), emission=np.asarray([emission], np.float32),
                metallic=np.zeros(1, np.float32), roughness=np.ones(1, np.float32),
                colors=col if colors else None)


class TestShading:
    def test_wide_shade_table(self):
        scene = ttypes.make_scene(**_scene_kw(), device="cpu")
        ref = jtypes.make_scene(**_scene_kw())
        assert scene.shade_table.shape[1] == 32 and scene.vertex_colors is not None
        np.testing.assert_array_equal(scene.shade_table.numpy(), np.asarray(ref.shade_table))
        np.testing.assert_array_equal(scene.vertex_colors.numpy(), np.asarray(ref.vertex_colors))

    def test_colorless_scene_keeps_16_lanes(self):
        scene = ttypes.make_scene(**_scene_kw(colors=False), device="cpu")
        assert scene.shade_table.shape[1] == 16 and scene.vertex_colors is None

    @pytest.mark.parametrize("ref_fast", [True, False])
    def test_interpolation_into_albedo(self, ref_fast):
        # Triangle 0's vertices coloured r/g/b, base colour (0.5, 1, 1); the
        # port against the expected mix and the reference's fast or slow path.
        scene = ttypes.make_scene(**_scene_kw(), device="cpu")
        uv = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.25, 0.25]], np.float32)
        s = ttypes.hit_surface_info(scene, torch.zeros(3, dtype=torch.int32), torch.from_numpy(uv))
        w = np.asarray([[1, 0, 0], [0, 1, 0], [0.5, 0.25, 0.25]], np.float32)
        col = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
        np.testing.assert_allclose(s.albedo.numpy(), (w @ col) * np.asarray([0.5, 1.0, 1.0], np.float32), atol=1e-6)
        ref = jtypes.make_scene(**_scene_kw())
        if not ref_fast:
            ref = ref._replace(shade_table=None, mat_table=None)
        rs = jtypes.hit_surface_info(ref, np.zeros(3, np.int32), uv)
        np.testing.assert_allclose(s.albedo.numpy(), np.asarray(rs.albedo), atol=1e-6)

    def test_paths_agree(self):
        scene = ttypes.make_scene(**_scene_kw(), device="cpu")
        ref = jtypes.make_scene(**_scene_kw())
        prim = np.asarray([0, 1, 1, 0], np.int32)
        uv = np.asarray([[0.3, 0.2], [0.1, 0.6], [0.0, 1.0], [0.5, 0.5]], np.float32)
        got = ttypes.hit_surface_info(scene, torch.from_numpy(prim), torch.from_numpy(uv)).albedo.numpy()
        for r in (ref, ref._replace(shade_table=None, mat_table=None)):
            np.testing.assert_allclose(got, np.asarray(jtypes.hit_surface_info(r, prim, uv).albedo), atol=1e-6)


class TestSlowPath:
    """``hit_surface_info`` on a scene without shade rows: per-vertex
    normals, UVs and colours through ``indices``, materials through
    ``geo_id``, the atlas at ``footprint_log2`` as given (no texel density:
    the reference's slow path)."""

    @staticmethod
    def _pair(kind):
        if kind == "colour_quad":
            kw = _scene_kw()
        else:
            from test_torch_textures import _textured_atrium

            kw = _textured_atrium(colors=True)
            if kind == "legacy_array":
                kw.pop("tex_images")
                kw["textures"] = np.random.default_rng(5).random((7, 8, 8, 3)).astype(np.float32)
        ref = jtypes.make_scene(**kw)
        fast = ttypes.make_scene(**kw, device="cpu")
        rows_free = dict(shade_table=None, mat_table=None)
        return ref._replace(**rows_free), fast, ttypes.scene_from_numpy(ref._replace(**rows_free)._asdict(), "cpu")

    @pytest.mark.parametrize("kind,footprint", [("colour_quad", False), ("atlas_colors", False),
                                                ("atlas_colors", True), ("legacy_array", False)])
    def test_slow_path_matches_reference_and_fast_path(self, kind, footprint):
        ref, fast, slow = self._pair(kind)
        assert slow.shade_table is None and slow.mat_table is None
        rng = np.random.default_rng(13)
        n = 4096
        prim = rng.integers(-1, ref.num_triangles, n).astype(np.int32)
        uv = rng.random((n, 2)).astype(np.float32)
        uv = np.where(uv.sum(-1, keepdims=True) > 1.0, 1.0 - uv, uv).astype(np.float32)
        fp = rng.uniform(-14.0, 4.0, n).astype(np.float32) if footprint else None
        got = ttypes.hit_surface_info(slow, torch.from_numpy(prim), torch.from_numpy(uv),
                                      footprint_log2=None if fp is None else torch.from_numpy(fp))
        want = jtypes.hit_surface_info(ref, prim, uv, footprint_log2=fp)
        for k in got._fields:
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=0, atol=1e-6,
                                       err_msg=k)
        if not footprint:
            # Level 0 on both paths: the fast path's rows hold the same data.
            quick = ttypes.hit_surface_info(fast, torch.from_numpy(prim), torch.from_numpy(uv))
            for k in got._fields:
                np.testing.assert_allclose(getattr(got, k).numpy(), getattr(quick, k).numpy(), rtol=0, atol=1e-6,
                                           err_msg=k)


class TestWorldPath:
    def test_world_scene_carries_colors(self, tmp_path):
        col = quad_arrays()[4]
        p = _write_both(tmp_path, "c.glb", colors=col)
        md = tassets.load_glb_cached(p, cache_dir=str(tmp_path / "cache"))
        w, rw = tworld.World(), jworld.World()
        w.spawn(w.add_mesh_data(md))
        rw.spawn(rw.add_mesh_data(md))
        scene, ref = w.scene(device="cpu"), rw.scene()
        assert scene.shade_table.shape[1] == 32
        # The pool's padding vertices are white (the product's identity).
        assert scene.vertex_colors.shape[0] >= 4
        np.testing.assert_allclose(scene.vertex_colors.numpy()[:4], col, atol=1e-6)
        for name in ("shade_table", "vertex_colors", "mat_table"):
            np.testing.assert_array_equal(getattr(scene, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)

    def test_scene_instanced_carries_colors_not_textures(self, tmp_path):
        # Two meshes, one coloured: the instanced scene's rows carry the
        # colours (white for the plain mesh). The World never gives its
        # scenes textures, so an override row's tex_id finds no atlas and
        # the instance shades untextured, as in the reference.
        pos, idx, nrm, uv, col = quad_arrays()
        worlds = []
        for world_mod in (tworld, jworld):
            w = world_mod.World()
            m = w.add_material(base_color=(0.8, 0.6, 0.4, 1.0))
            a = w.add_mesh(pos, nrm, uv, idx, np.full(2, m, np.int32), colors=col)
            b = w.add_mesh(pos + 2.0, nrm, uv, idx, np.full(2, m, np.int32))
            w.spawn(a)
            e = w.spawn(b)
            w.set_instance_material(e, base_color=(0.2, 0.9, 0.3), tex_id=0)
            worlds.append(w)
        scene, ref = worlds[0].scene_instanced(device="cpu"), worlds[1].scene_instanced()
        assert scene.shade_table.shape[1] == 32 and scene.tex_atlas is None and scene.textures is None
        for name in ("shade_table", "vertex_colors", "inst_mat_table"):
            np.testing.assert_array_equal(getattr(scene, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
        prim = np.asarray([0, 1, 2, 3], np.int32)
        inst = np.asarray([0, 0, 1, 1], np.int32)
        bary = np.full((4, 2), 0.25, np.float32)
        got = ttypes.hit_surface_info(scene, torch.from_numpy(prim), torch.from_numpy(bary),
                                      torch.from_numpy(inst)).albedo.numpy()
        np.testing.assert_allclose(got, np.asarray(jtypes.hit_surface_info(ref, prim, bary, inst).albedo), atol=1e-6)
        np.testing.assert_allclose(got[2:], np.asarray([[0.2, 0.9, 0.3]] * 2), atol=1e-6)

    def test_render_with_colors(self):
        """A camera-facing coloured quad: the albedo of the primary hits
        shows the vertex gradient in the COLOR_0 order."""
        scene = ttypes.make_scene(**_scene_kw(base=(1, 1, 1, 1), emission=(1.0, 1.0, 1.0)), device="cpu")
        cam = tcamera.Camera.create(position=(0.5, 0.5, 2.0), direction=(0.0, 0.0, -1.0), fov_y_deg=40.0,
                                    aspect=1.0, device="cpu")
        o, d = tcamera.primary_rays(cam, 8, 8)
        hit = tintersect.intersect_bruteforce(o, d, *scene.tri_vertices())
        img = ttypes.hit_surface_info(scene, hit.prim_id, hit.uv).albedo.numpy().reshape(8, 8, 3)
        assert hit.hit.numpy().reshape(8, 8)[1:-1, 1:-1].all()
        assert img[-2, 1, 0] > 0.5 and img[-2, 1, 1] < 0.5
        assert img[-2, -2, 1] > 0.5 and img[-2, -2, 0] < 0.5
        assert img[1, -2, 2] > 0.5 and img[1, -2, 0] < 0.5
