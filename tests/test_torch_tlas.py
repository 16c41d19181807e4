"""The port's two-level (TLAS/BLAS) path against the JAX reference.

- Tables: ``build_two_level`` is bit-equal to the reference's on the box
  scenes of tests/test_tlas.py (3 instances; 23 for a deep TLAS) and on the
  instanced atrium world (shell mesh + one column mesh spawned 14 times with
  yawed transforms, both through GLB ingest).
- Traversal: K4's plain version (CPU tensors) against the reference's Pallas
  kernel in interpret mode (``interpret=True, sublanes=8``, as
  tests/test_tlas.py runs it) under the oracle rule: hit-mask mismatches
  ≤ max(2, n/500), t within rtol 2e-4 / atol 1e-4 on mutual hits; instance
  ids equal on every mutual hit that is no exact-t tie (two coplanar faces
  of two instances, such as a column's base on the floor, meet a ray at the
  same t). Occlusion and a transform-edit rebind too.
- Scenes: ``World.scene_instanced()`` fields bit-equal to the reference's
  before and after ``set_transform`` and ``set_instance_material``;
  ``hit_surface_info(inst=)`` within rtol 1e-5.
- Images: a 32×32, 2-bounce, 2-frame instanced render against the
  reference's under the golden rule (mean relative difference < 1e-3,
  ≥ 98% of pixels within 1e-3), for the atrium world and for box instances
  lit by the sky alone (an empty light list). Measured: 1.6e-6 and 99.9%;
  2.7e-8 and 100%.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.app import world as jworld
from raytracer3_tpu.ops import tlas as jtlas
from raytracer3_tpu.render import camera as jcamera
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu.scene import assets as jassets
from raytracer3_tpu.scene import gltf as jgltf
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu.scene import types as jtypes
from raytracer3_tpu.utils.config import RenderSettings
from raytracer3_tpu_torch.app import world as tworld
from raytracer3_tpu_torch.ops import tlas as ttlas
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import assets as tassets
from raytracer3_tpu_torch.scene import gltf as tgltf
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.scene import types as ttypes
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

SUBLANES = 8
N_RAYS = SUBLANES * 128


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _box_mesh():
    v, f = jprocedural._box_tris((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    return dict(positions=v, indices=f)


def _transform(tx=0.0, ty=0.0, tz=0.0, s=1.0, yaw=0.0):
    c, sn = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray([[c * s, 0, sn * s], [0, s, 0], [-sn * s, 0, c * s]], np.float32)
    m[:3, 3] = (tx, ty, tz)
    return m


def _rays(n, seed=3, spread=4.0, center=(0.0, 1.0, 0.0)):
    r = np.random.default_rng(seed)
    o = (r.uniform(-spread, spread, (n, 3)) + np.asarray(center)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _boxes(count):
    if count == 3:
        return [(0, _transform(-1.5, 0.5, 0.0)), (0, _transform(1.5, 0.5, 0.0, s=1.5, yaw=0.7)),
                (0, _transform(0.0, 2.0, 1.0, s=0.6, yaw=1.9))]
    r = np.random.default_rng(0)
    return [(0, _transform(*(r.uniform(-6, 6, 3)), s=r.uniform(0.4, 1.2))) for _ in range(count)]


# -- the instanced atrium world ---------------------------------------------

_COLUMN_MAT = 2  # the atrium's column material


def instanced_atrium_meshes(procedural, detail):
    """(shell, column) mesh dicts of the instanced atrium: every atrium
    triangle but the columns', and one column (cylinder + capital + base)
    at the origin with the atrium's column tessellation."""
    kw = procedural.atrium(detail=detail)
    shell = dict(kw, indices=kw["indices"][kw["geo_id"] != _COLUMN_MAT],
                 geo_id=kw["geo_id"][kw["geo_id"] != _COLUMN_MAT])
    parts = [procedural._cylinder((0.0, 0.0, 0.0), 0.45, 6.0, 12 * detail, 4 * detail),
             procedural._box_tris((-0.6, 5.9, -0.6), (0.6, 6.4, 0.6)),
             procedural._box_tris((-0.6, 0.0, -0.6), (0.6, 0.3, 0.6))]
    pos, idx, voff = [], [], 0
    for v, t in parts:
        pos.append(v)
        idx.append(t + voff)
        voff += len(v)
    pos, idx = np.concatenate(pos), np.concatenate(idx)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, idx[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    mat = slice(_COLUMN_MAT, _COLUMN_MAT + 1)
    column = dict(positions=pos, normals=nrm, uvs=(pos[:, [0, 2]] + 0.6) / 24.0, indices=idx,
                  geo_id=np.zeros(len(idx), np.int32), base_color=kw["base_color"][mat],
                  emission=kw["emission"][mat], metallic=kw["metallic"][mat], roughness=kw["roughness"][mat])
    return shell, column


def column_transforms():
    """The 14 column instances: the atrium's column positions, each with a
    yaw of 0.3·k rad."""
    out = []
    for k, (z, i) in enumerate((z, i) for z in (-3.0, 3.0) for i in range(7)):
        out.append(_transform(-9.0 + 3.0 * i, 0.0, z, yaw=0.3 * k))
    return out


def build_instanced_world(world, gltf, assets, procedural, detail, cache_dir, sky):
    """The instanced atrium through GLB ingest: shell spawned once, the
    column 14 times. Returns (world, column entities)."""
    handles = []
    for name, m in zip(("shell", "column"), instanced_atrium_meshes(procedural, detail)):
        path = os.path.join(cache_dir, f"instanced_{name}_d{detail}.glb")
        gltf.write_glb_multi(path, m["positions"], m["normals"], m["uvs"], m["indices"], m["geo_id"],
                             m["base_color"], m["emission"], m["metallic"], m["roughness"])
        handles.append(world.add_mesh_data(assets.load_glb_cached(path, cache_dir=cache_dir)))
    world.spawn(handles[0], name="shell")
    cols = [world.spawn(handles[1], transform=t, name=f"column{k}") for k, t in enumerate(column_transforms())]
    world.env_map = sky
    return world, cols


@pytest.fixture(scope="module")
def atrium_worlds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("instanced"))
    sky = jprocedural.sky_equirect(32, 64)
    jw, jcols = build_instanced_world(jworld.World(), jgltf, jassets, jprocedural, 1, d, sky)
    tw, tcols = build_instanced_world(tworld.World(), tgltf, tassets, tprocedural, 1, d, sky)
    return jw, jcols, tw, tcols


# -- tables ------------------------------------------------------------------


def _assert_tables_equal(got, ref):
    for name in ref._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            assert g == r, name


@pytest.mark.parametrize("count", [3, 23])
def test_two_level_tables_bit_equal_boxes(count):
    meshes, instances = [_box_mesh()], _boxes(count)
    ref = jtlas.build_two_level(meshes, instances, leaf_size=4, width=8)
    got = ttlas.build_two_level(meshes, instances, leaf_size=4, width=8)
    assert (got.tlas_nodes > 1) == (count > 8)
    _assert_tables_equal(got, ref)


def test_two_level_tables_bit_equal_atrium_world(atrium_worlds):
    jw, _, tw, _ = atrium_worlds
    ref = jw.tlas_backend(sublanes=SUBLANES, interpret=True).meta[1]
    got = tw.tlas_backend(device="cpu").meta[1]
    assert got.inst_table.shape[0] == 15
    _assert_tables_equal(got, ref)


# -- traversal ---------------------------------------------------------------


def _trace_both(meshes, instances, o, d, leaf_size=4, width=8, **kw):
    jb = jtlas.two_level_backend(meshes, instances, leaf_size=leaf_size, width=width, sublanes=SUBLANES,
                                 interpret=True)
    tb = ttlas.two_level_backend(meshes, instances, leaf_size=leaf_size, width=width, device="cpu")
    return _both_backends(jb, tb, o, d, **kw)


def _both_backends(jb, tb, o, d, t_max=None):
    jo, jd, to_, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    if t_max is None:
        return jb.intersect(jo, jd), tb.intersect(to_, td)
    return (np.asarray(jb.occluded(jo, jd, jnp.asarray(t_max))),
            tb.occluded(to_, td, torch.from_numpy(t_max)).numpy())


def _judge(ref, got, min_hits=0.05):
    h, rh = got.hit.numpy(), np.asarray(ref.hit)
    n = h.shape[0]
    assert h.mean() > min_hits
    assert (h != rh).sum() <= max(2, n // 500), f"{(h != rh).sum()} / {n} hit-mask mismatches"
    m = h & rh
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m], rtol=2e-4, atol=1e-4)
    inst, rinst = got.inst.numpy(), np.asarray(ref.inst)
    parted = m & (inst != rinst)
    assert (got.t.numpy()[parted] == np.asarray(ref.t)[parted]).all(), "instance ids differ off exact-t ties"
    assert (inst[~h] == -1).all() and (got.prim_id.numpy()[~h] == -1).all()
    same = m & (got.prim_id.numpy() == np.asarray(ref.prim_id))
    assert same.sum() > 0.9 * m.sum()
    np.testing.assert_allclose(got.uv.numpy()[same], np.asarray(ref.uv)[same], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("count,seed", [(3, 3), (3, 17), (23, 9)])
def test_k4_plain_matches_reference(count, seed):
    o, d = _rays(N_RAYS, seed=seed, spread=7.0 if count > 8 else 4.0)
    ref, got = _trace_both([_box_mesh()], _boxes(count), o, d)
    _judge(ref, got)


def test_k4_instance_ids_exact():
    instances = _boxes(3)
    centers = np.stack([t[:3, 3] for _, t in instances])
    o = np.zeros((N_RAYS, 3), np.float32)
    d = np.zeros((N_RAYS, 3), np.float32)
    for k in range(3):
        o[k::8] = centers[k] + [0, 5.0, 0]
        d[k::8] = [0, -1.0, 0]
    o[3::8] = [50.0, 50.0, 50.0]
    d[3::8] = [0, 1.0, 0]
    o[4::8], d[4::8] = _rays(N_RAYS // 8, seed=2)
    ref, got = _trace_both([_box_mesh()], instances, o, d)
    # The prims may differ: a ray through a box's centre meets the shared
    # diagonal of its top face, an exact-t tie.
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(ref.inst))
    for k in range(3):
        assert (got.inst.numpy()[k::8] == k).all()


@pytest.mark.parametrize("scale", [1.05, 0.95])
def test_k4_occlusion_matches_reference(scale):
    meshes, instances = [_box_mesh()], _boxes(3)
    o, d = _rays(N_RAYS, seed=5)
    t_ref = ttlas.two_level_backend(meshes, instances, leaf_size=4, width=8, device="cpu").intersect(
        torch.from_numpy(o), torch.from_numpy(d)).t.numpy()
    tmax = np.where(t_ref < 1e4, t_ref * scale, 1e-3).astype(np.float32)
    ref, got = _trace_both(meshes, instances, o, d, t_max=tmax)
    assert (got != ref).sum() <= 2
    mask = t_ref < 1e4
    assert got[mask].all() if scale > 1 else not got[mask].any()


def test_k4_transform_edit_rebind():
    meshes, instances = [_box_mesh()], _boxes(3)
    cache = {}
    b1 = ttlas.two_level_backend(meshes, instances, leaf_size=4, width=8, blas_cache=cache, device="cpu")
    moved = list(instances)
    moved[1] = (0, _transform(3.0, 0.5, -1.0, s=1.5, yaw=0.2))
    b2 = ttlas.two_level_backend(meshes, moved, leaf_size=4, width=8, blas_cache=cache, device="cpu")
    # BLAS reused: the same cluster tensor, no vertex rebuild.
    assert len([k for k in cache if isinstance(k, int)]) == 1
    assert b2.arrays["clusters"] is b1.arrays["clusters"]
    assert b2.arrays["clusters"].data_ptr() == b1.arrays["clusters"].data_ptr()
    assert b1.arrays["nodes"].shape == b2.arrays["nodes"].shape
    assert not torch.equal(b1.arrays["insts"], b2.arrays["insts"])
    jb = jtlas.two_level_backend(meshes, moved, leaf_size=4, width=8, sublanes=SUBLANES, interpret=True)
    o, d = _rays(N_RAYS, seed=11)
    _judge(*_both_backends(jb, b2, o, d), min_hits=0.02)


def test_k4_plain_matches_reference_on_atrium_world(atrium_worlds):
    jw, _, tw, _ = atrium_worlds
    jb = jw.tlas_backend(sublanes=SUBLANES, interpret=True)
    tb = tw.tlas_backend(device="cpu")
    # Rays from inside the courtyard, in every direction.
    o, d = _rays(N_RAYS, seed=23, spread=3.0, center=(0.0, 3.0, 0.0))
    o[:, 0] *= 3.0
    _judge(*_both_backends(jb, tb, o, d), min_hits=0.9)


def test_k4_cpu_calls_are_not_counted():
    meshes, instances = [_box_mesh()], _boxes(3)
    tb = ttlas.two_level_backend(meshes, instances, leaf_size=4, width=8, device="cpu")
    o, d = (torch.from_numpy(a) for a in _rays(256))
    before = dict(ttk.LAUNCHES)
    tb.intersect(o, d)
    tb.occluded(o, d, torch.ones(256))
    assert ttk.LAUNCHES == before


# -- scenes ------------------------------------------------------------------


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


def test_scene_instanced_bit_equal_through_edits(atrium_worlds, tmp_path):
    sky = jprocedural.sky_equirect(32, 64)
    d = str(tmp_path)
    jw, jcols = build_instanced_world(jworld.World(), jgltf, jassets, jprocedural, 1, d, sky)
    tw, tcols = build_instanced_world(tworld.World(), tgltf, tassets, tprocedural, 1, d, sky)
    s0 = tw.scene_instanced(device="cpu")
    _assert_fields_equal(s0, jw.scene_instanced())
    assert s0.inst_mat_table is None and s0.inst_normal_mats.shape == (15, 9)
    edits = [
        lambda w, cols: w.set_transform(cols[3], _transform(1.0, 0.2, -2.0, yaw=1.1)),
        lambda w, cols: w.set_instance_material(cols[5], base_color=(0.9, 0.1, 0.1), emission=(2.0, 1.0, 0.5)),
        lambda w, cols: w.set_instance_material(cols[6], base_color=(0.1, 0.2, 0.9)),
        lambda w, cols: w.set_instance_material(cols[5], base_color=None),
    ]
    for edit in edits:
        edit(jw, jcols)
        edit(tw, tcols)
        s = tw.scene_instanced(device="cpu")
        _assert_fields_equal(s, jw.scene_instanced())
        # Geometry and shading rows are the same tensors: no re-bake.
        assert s.shade_table is s0.shade_table and s.positions is s0.positions


def test_scene_instanced_without_emitters_bit_equal():
    # Box instances with no emissive material: an empty light list.
    w = {}
    for name, mod in (("j", jworld), ("t", tworld)):
        wd = mod.World()
        wd.add_material((0.2, 0.8, 0.2, 1.0))
        m = _box_mesh()
        nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (len(m["positions"]), 1))
        h = wd.add_mesh(m["positions"], nrm, np.zeros((len(m["positions"]), 2), np.float32), m["indices"],
                        np.zeros(len(m["indices"]), np.int32))
        for _, t in _boxes(3):
            wd.spawn(h, transform=t)
        w[name] = wd
    got = w["t"].scene_instanced(device="cpu")
    assert got.emissive.tri_ids.shape == (0,)
    _assert_fields_equal(got, w["j"].scene_instanced())
    # The reference's instanced scene converts as it is.
    w["j"].set_instance_material(w["j"]._entities[1], base_color=(0.9, 0.1, 0.1))
    ref = w["j"].scene_instanced()
    assert ref.inst_mat_table is not None
    _assert_fields_equal(ttypes.scene_from_numpy(ref._asdict(), "cpu"), ref)


def test_hit_surface_info_inst_matches_reference(atrium_worlds):
    jw, jcols, tw, tcols = atrium_worlds
    for w, cols in ((jw, jcols), (tw, tcols)):
        w.set_instance_material(cols[2], base_color=(0.9, 0.1, 0.1), emission=(1.0, 1.0, 1.0))
    js, ts = jw.scene_instanced(), tw.scene_instanced(device="cpu")
    r = np.random.default_rng(4)
    n = 4096
    pid = r.integers(-1, ts.num_triangles, n).astype(np.int32)
    uv = r.uniform(0, 0.5, (n, 2)).astype(np.float32)
    inst = r.integers(-1, 15, n).astype(np.int32)
    ref = jtypes.hit_surface_info(js, jnp.asarray(pid), jnp.asarray(uv), jnp.asarray(inst))
    got = ttypes.hit_surface_info(ts, torch.from_numpy(pid), torch.from_numpy(uv), torch.from_numpy(inst))
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    overridden = inst == 3  # cols[2] is instance 3: the shell is instance 0
    assert overridden.any()
    np.testing.assert_allclose(got.albedo.numpy()[overridden], np.tile([0.9, 0.1, 0.1], (overridden.sum(), 1)),
                               rtol=1e-6)


# -- images ------------------------------------------------------------------


def _box_worlds(sky):
    """Three box instances with no emitter and a sky: NEE samples the
    environment alone (an empty light list)."""
    worlds = []
    for mod in (jworld, tworld):
        w = mod.World()
        w.add_material((0.7, 0.5, 0.3, 1.0), roughness=0.6)
        m = _box_mesh()
        nrm = m["positions"] / np.linalg.norm(m["positions"], axis=-1, keepdims=True)
        h = w.add_mesh(m["positions"], nrm, np.zeros((len(m["positions"]), 2), np.float32), m["indices"],
                       np.zeros(len(m["indices"]), np.int32))
        for _, t in _boxes(3):
            w.spawn(h, transform=t)
        w.env_map = sky
        worlds.append(w)
    return worlds


@pytest.mark.parametrize("world", ["atrium", "boxes_env_only"])
def test_instanced_render_matches_reference(atrium_worlds, world):
    if world == "atrium":
        jw, _, tw, _ = atrium_worlds
        # Low, along the colonnade: in the default atrium view a 1-spp path
        # that meets the skylight panel's edge (in the plane of a gallery
        # slab's face) lands on the emitter or on the slab depending on the
        # last bits of its BRDF sample, and that one lane decides more than
        # 1e-3 of a 32×32 image.
        jcam = jcamera.Camera.create(position=(-10.0, 1.5, 0.0), direction=(1.0, -0.02, 0.1), fov_y_deg=65.0,
                                     aspect=1.0)
    else:
        jw, tw = _box_worlds(jprocedural.sky_equirect(32, 64))
        jcam = jcamera.Camera.create(position=(0.0, 1.2, -6.0), direction=(0.0, -0.05, 1.0), fov_y_deg=55.0,
                                     aspect=1.0)
    s = RenderSettings(width=32, height=32, bounces=2, samples=1, radiance_clamp=50.0)
    tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
    # A one-cluster box mesh has 8-wide rows; the TLAS must match them.
    kw = dict(leaf_size=12, width=16) if world == "atrium" else dict(leaf_size=4, width=8)
    jb = jw.tlas_backend(sublanes=SUBLANES, interpret=True, **kw)
    jisect, joccl = jb.bind(jb.arrays)
    js = jw.scene_instanced()
    frame = jax.jit(lambda fi: jwavefront.render_frame(js, jcam, s, fi, jisect, joccl, sort_rays=True))
    tb = tw.tlas_backend(device="cpu", **kw)
    tisect, toccl = tb.bind(tb.arrays)
    ts = tw.scene_instanced(device="cpu")
    assert (int(ts.emissive.tri_ids.shape[0]) == 0) == (world == "boxes_env_only")
    ref = np.zeros((32, 32, 3), np.float32)
    got = torch.zeros((32, 32, 3))
    for i in range(2):
        ref += np.asarray(frame(jnp.uint32(i)))
        got += twavefront.render_frame(ts, tcam, s, i, tisect, toccl, sort_rays=True)
    ref, got = ref / 2, got.numpy() / 2
    assert np.isfinite(got).all() and got.mean() > 0.0
    diff = np.abs(got - ref)
    assert diff.sum() / np.abs(ref).sum() < 1e-3
    assert (diff.max(-1) <= 1e-3).mean() >= 0.98


def test_sorted_occlusion_keeps_the_bits():
    # An any-hit answer does not depend on the order the rays are traced
    # in: a tail-shaped batch (shadow rays with caps, escape probes without,
    # parked lanes) through the two-level backend, coherence-sorted by
    # wavefront.sorted_occlusion and in the caller's order, answers the same
    # bits in the caller's order.
    _, tw = _box_worlds(jprocedural.sky_equirect(32, 64))
    tb = tw.tlas_backend(device="cpu", leaf_size=4, width=8)
    o, d = (torch.from_numpy(a) for a in _rays(3000, seed=13, spread=7.0))
    cap = torch.from_numpy(np.random.default_rng(14).uniform(0.5, 12.0, 3000).astype(np.float32))
    cap[1500:] = ttk._BG
    live = torch.arange(3000) % 7 != 0
    o = torch.where(live[:, None], o, 1e30)
    bounds = (torch.full((3,), -8.0), torch.full((3,), 8.0))
    got = twavefront.sorted_occlusion(tb.occluded, o, d, cap, live, bounds)
    ref = tb.occluded(o, d, cap)
    assert torch.equal(got, ref) and 0 < int(ref.sum()) < int(live.sum())


# -- the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_k4_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    meshes, instances = [_box_mesh()], _boxes(23)
    tb = ttlas.two_level_backend(meshes, instances, leaf_size=4, width=8, device="cuda")
    pt = tb.meta[0]
    o, d = (torch.from_numpy(a).cuda() for a in _rays(8192, seed=9, spread=7.0))
    before = dict(ttk.LAUNCHES)
    k = ttk.packet_intersect(pt, o, d)
    p = ttk.packet_intersect_plain(pt, o, d)
    tmax = torch.where(p.hit, p.t * 0.5, 1e-3).contiguous()
    ka = ttk.packet_intersect(pt, o, d, t_max=tmax, any_hit=True)
    pa = ttk.packet_intersect_plain(pt, o, d, t_max=tmax, any_hit=True)
    torch.cuda.synchronize()
    # Width 8 / leaf 4 is a shape the walk kernels are not compiled for.
    assert ttk.LAUNCHES["tlas_closest_general"] == before["tlas_closest_general"] + 1
    assert ttk.LAUNCHES["tlas_any_general"] == before["tlas_any_general"] + 1
    assert (k.hit != p.hit).sum().item() <= max(2, o.shape[0] // 500)
    m = k.hit & p.hit
    torch.testing.assert_close(k.t[m], p.t[m], rtol=1e-4, atol=1e-5)
    assert torch.equal(k.inst[m], p.inst[m])
    assert (ka.hit != pa.hit).sum().item() <= max(2, o.shape[0] // 500)


@pytest.mark.gpu
def test_k4_walk_kernel_on_card():
    """The walk kernel of K4 (width 16, leaf 12) and its counting form on
    the card: every hit field and every count equal ``traverse_plain``'s
    and the general loop's to the bit, the launch counted as the walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    # A 300-triangle soup as the mesh: a one-cluster BLAS (the box) has no
    # width-16 node row in either package.
    r = np.random.default_rng(9)
    c = r.uniform(-0.5, 0.5, (300, 3))
    pos = np.concatenate([c, c + r.normal(0, 0.12, (300, 3)), c + r.normal(0, 0.12, (300, 3))]).astype(np.float32)
    meshes = [dict(positions=pos, indices=np.arange(900, dtype=np.int32).reshape(3, 300).T.copy())]
    tb = ttlas.two_level_backend(meshes, _boxes(23), device="cuda")
    pt = tb.meta[0]
    assert ttk.trace_loop(pt.width, pt.leaf_size, two_level=True, stack_need=ttk.stack_depth(pt)) == "walk"
    o, d = (torch.from_numpy(a).cuda() for a in _rays(8192, seed=9, spread=7.0))
    cap = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 12.0, 8192).astype(np.float32)).cuda()
    cap[::5] = 0.0  # parked lanes
    for t_max in (ttk._BG, cap):
        before = dict(ttk.LAUNCHES)
        k = ttk.packet_intersect(pt, o, d, t_max=t_max)
        ks, counts = ttk.packet_intersect(pt, o, d, t_max=t_max, stats=True)
        assert ttk.LAUNCHES["tlas_closest"] == before["tlas_closest"] + 1
        assert ttk.LAUNCHES["tlas_closest_stats"] == before["tlas_closest_stats"] + 1
        # The general loop on the same rays, through the launcher the
        # wrapper uses (the wrapper itself picks the walk for this shape).
        g_t, g_u, g_v, g_prim, g_inst, g_counts = ttk._launch_packet(
            ttk.load_kernels(), pt, o, d, ttk._t_cap(t_max, o.shape[0], o.device), 1e-4, False, True, "general",
            torch.cuda.current_stream().cuda_stream)
        assert ttk.LAUNCHES["tlas_closest_general"] == before["tlas_closest_general"]
        ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=t_max)
        torch.cuda.synchronize()
        for f in ("hit", "t", "uv", "prim_id", "inst"):
            a = getattr(k, f)
            assert torch.equal(a, getattr(ks, f)) and torch.equal(a, getattr(ref, f)), f
        assert torch.equal(k.prim_id, g_prim) and torch.equal(k.inst, g_inst)
        assert torch.equal(k.t, torch.where(g_prim >= 0, g_t, ttk._BG))
        assert torch.equal(k.uv, torch.stack([g_u, g_v], dim=-1))
        assert torch.equal(counts, g_counts) and torch.equal(counts, ref_counts)
        assert int(k.hit.sum()) > 0


def _soup_mesh():
    # A 300-triangle soup: a one-cluster BLAS (the box) has no width-16
    # node row in either package.
    r = np.random.default_rng(9)
    c = r.uniform(-0.5, 0.5, (300, 3))
    pos = np.concatenate([c, c + r.normal(0, 0.12, (300, 3)), c + r.normal(0, 0.12, (300, 3))]).astype(np.float32)
    return dict(positions=pos, indices=np.arange(900, dtype=np.int32).reshape(3, 300).T.copy())


@pytest.mark.gpu
def test_k4_any_walk_kernel_on_card():
    """The any-hit walk of K4 (width 16, leaf 12) and its counting form on
    the card: every output and every count equal the general loop's and
    ``traverse_plain(any_hit=True)``'s to the bit, the launch counted as the
    walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    tb = ttlas.two_level_backend([_soup_mesh()], _boxes(23), device="cuda")
    pt = tb.meta[0]
    o, d = (torch.from_numpy(a).cuda() for a in _rays(8192, seed=11, spread=7.0))
    cap = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 12.0, 8192).astype(np.float32)).cuda()
    cap[::5] = 0.0  # parked lanes
    for t_max in (ttk._BG, cap):
        before = dict(ttk.LAUNCHES)
        k = ttk.packet_intersect(pt, o, d, t_max=t_max, any_hit=True)
        ks, counts = ttk.packet_intersect(pt, o, d, t_max=t_max, any_hit=True, stats=True)
        assert ttk.LAUNCHES["tlas_any"] == before["tlas_any"] + 1
        assert ttk.LAUNCHES["tlas_any_stats"] == before["tlas_any_stats"] + 1
        tc = ttk._t_cap(t_max, o.shape[0], o.device)
        stream = torch.cuda.current_stream().cuda_stream
        walk = ttk._launch_packet(ttk.load_kernels(), pt, o, d, tc, 1e-4, True, True, "walk", stream)
        general = ttk._launch_packet(ttk.load_kernels(), pt, o, d, tc, 1e-4, True, True, "general", stream)
        ref, ref_counts = ttk.traverse_plain(pt, o, d, t_max=t_max, any_hit=True)
        torch.cuda.synchronize()
        for a, b in zip(walk, general):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for f in ("hit", "t", "uv", "prim_id", "inst"):
            assert torch.equal(getattr(k, f), getattr(ks, f)) and torch.equal(getattr(k, f), getattr(ref, f)), f
        assert torch.equal(counts, walk[5]) and torch.equal(counts, ref_counts)
        assert 0 < int(k.hit.sum()) < o.shape[0]


@pytest.mark.gpu
def test_two_level_stack_dispatch_on_card():
    """K4 on the card by the tables' stack need: the walk kernels at the
    need the packing computed, the general loop's 512-entry instantiation
    at a need above 128 (the wrapper takes it without a ValueError), both
    equal to ``traverse_plain`` to the bit; past 512 the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    insts = []
    for k in range(200):  # a column of instances along +z
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (0.3 * np.sin(k), 0.3 * np.cos(k), 1.5 * k)
        insts.append((0, m))
    pt = ttlas.two_level_backend([_soup_mesh()], insts, device="cuda").meta[0]
    rng = np.random.default_rng(12)
    o = torch.from_numpy(np.concatenate([rng.uniform(-0.6, 0.6, (4096, 2)), np.full((4096, 1), -5.0)], 1)
                         .astype(np.float32)).cuda()
    d = torch.nn.functional.normalize(torch.from_numpy(
        np.concatenate([rng.normal(0, 0.01, (4096, 2)), np.ones((4096, 1))], 1).astype(np.float32)).cuda(), dim=-1)
    for need, loop in ((pt.stack_need, "walk"), (ttk.STACK_CAPACITY + 1, "deep")):
        tables = pt._replace(stack_need=need)
        assert ttk.trace_loop(tables.width, tables.leaf_size, two_level=True, stack_need=need) == loop
        for any_hit in (False, True):
            key = "tlas_" + ("any" if any_hit else "closest") + ("_deep" if loop == "deep" else "")
            before = dict(ttk.LAUNCHES)
            got, counts = ttk.packet_intersect(tables, o, d, any_hit=any_hit, stats=True)
            ref, ref_counts = ttk.traverse_plain(tables, o, d, any_hit=any_hit)
            torch.cuda.synchronize()
            assert ttk.LAUNCHES[key + "_stats"] == before[key + "_stats"] + 1
            for f in ("hit", "t", "prim_id", "inst"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), f
            assert torch.equal(counts, ref_counts) and int(got.hit.sum()) > 0
    with pytest.raises(ValueError, match="513-entry"):
        ttk.packet_intersect(pt._replace(stack_need=ttk.DEEP_STACK_CAPACITY + 1), o, d)
