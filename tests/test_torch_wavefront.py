"""The port's wavefront path tracer end to end against the JAX reference.

- Cornell box (brute-force backends on both sides, identical scene and
  camera state, the same RNG counters): ≥ 99% of film pixels within 1e-4
  after 4 progressive frames (measured: 100%, max |Δ| 6e-6).
- The atrium slice through the port's packet backend (the kernel's plain
  version on the CPU) against the stored golden of the reference's packet
  kernel: mean relative image difference < 1e-3 and ≥ 98% of pixels within
  1e-3 (measured: 1.1e-4 and 99.7%). What differs comes from exact-t ties
  and Russian-roulette flips, not from the algorithm.
- The progressive ``wavefront_pipeline`` display against the reference's.
- The port renders, the instanced path included, without ever loading jax
  or the JAX package (in a fresh process), and no module of the port nor
  ``chip_smoke.py`` imports either.
- The port's ``RenderSettings`` copy has the reference's fields and defaults.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.ops import rng as jrng
from raytracer3_tpu.render import film as jfilm
from raytracer3_tpu.render import pipelines as jpipelines
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu.scene import analytic as janalytic
from raytracer3_tpu.utils.config import RenderSettings
from raytracer3_tpu_torch.ops import intersect as tintersect
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.render import camera as tcamera
from raytracer3_tpu_torch.render import film as tfilm
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.scene import types as ttypes
from raytracer3_tpu_torch.utils import config as tconfig
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cornell():
    jscene = janalytic.cornell_box()
    jcam = janalytic.default_camera()
    tscene = ttypes.scene_from_numpy(jscene._asdict(), "cpu")
    tcam = tcamera.camera_from_numpy(jcam._asdict(), "cpu")
    return jscene, jcam, tscene, tcam


@pytest.mark.parametrize("sort_rays", [True, False])
def test_cornell_progressive_matches_reference(cornell, sort_rays):
    jscene, jcam, tscene, tcam = cornell
    s = RenderSettings(width=64, height=64, bounces=3, samples=1, diffuse_only=True)
    jb = jintersect.brute_backend(scene=jscene)
    jisect, joccl = jb.bind(jb.arrays)
    frame = jax.jit(lambda fi: jwavefront.render_frame(jscene, jcam, s, fi, jisect, joccl, sort_rays=sort_rays))
    tb = tintersect.brute_backend(scene=tscene, device="cpu")
    tisect, toccl = tb.bind(tb.arrays)
    jf = jfilm.Film.create(64, 64)
    tf = tfilm.Film.create(64, 64, device="cpu")
    for i in range(4):
        jf = jfilm.accumulate_progressive(jf, frame(jnp.uint32(i)))
        tf = tfilm.accumulate_progressive(
            tf, twavefront.render_frame(tscene, tcam, s, i, tisect, toccl, sort_rays=sort_rays))
    ref, got = np.asarray(jf.accum), tf.accum.numpy()
    assert tf.frame_index == int(jf.frame_index) == 4
    assert np.isfinite(got).all() and got.mean() > 0.05
    share = (np.abs(got - ref).max(-1) <= 1e-4).mean()
    assert share >= 0.99, share


def test_atrium_packet_slice_matches_golden():
    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    cam = tprocedural.atrium_camera(aspect=1.0, device="cpu")
    backend = ttk.packet_backend(host_tris=tris, device="cpu")
    isect, occl = backend.bind(backend.arrays)
    s = RenderSettings(width=48, height=48, bounces=2, samples=1, radiance_clamp=50.0)
    acc = torch.zeros((48, 48, 3))
    traced = 0
    for i in range(4):
        img, n = twavefront.render_frame(scene, cam, s, i, isect, occl, sort_rays=True, return_stats=True)
        acc += img
        traced += int(n)
    acc = (acc / 4).numpy()
    golden = np.load(os.path.join(REPO, "tests", "golden", "atrium_packet_48_4f.npy"))
    d = np.abs(acc - golden)
    assert d.sum() / np.abs(golden).sum() < 1e-3
    assert (d.max(-1) <= 1e-3).mean() >= 0.98
    # The meter counts primaries plus traced bounce and shadow lanes.
    assert 4 * 48 * 48 < traced <= 4 * 48 * 48 * (1 + 2 * 2)


def test_atrium_treelet_slice_matches_golden():
    # The large-scene path at small size: K3's plain version over two
    # treelets, the backend's own sorting (sort_rays=False) and its
    # presorted primary trace, held to the same golden and limits as the
    # single-level slice above.
    from raytracer3_tpu_torch.ops import treelets as ttreelets

    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    cam = tprocedural.atrium_camera(aspect=1.0, device="cpu")
    backend = ttreelets.treelet_backend(host_tris=tris, max_tris=4096, device="cpu")
    assert backend.meta.num_treelets >= 2 and backend.self_sorting
    isect, occl = backend.bind(backend.arrays)
    primary = backend.bind_primary(backend.arrays)
    s = RenderSettings(width=48, height=48, bounces=2, samples=1, radiance_clamp=50.0)
    acc = torch.zeros((48, 48, 3))
    for i in range(4):
        acc += twavefront.render_frame(scene, cam, s, i, isect, occl, sort_rays=not backend.self_sorting,
                                       primary_fn=primary)
    acc = (acc / 4).numpy()
    golden = np.load(os.path.join(REPO, "tests", "golden", "atrium_packet_48_4f.npy"))
    d = np.abs(acc - golden)
    assert d.sum() / np.abs(golden).sum() < 1e-3
    assert (d.max(-1) <= 1e-3).mean() >= 0.98


def test_sorted_occlusion_keeps_the_treelet_bits():
    # The treelet backend sorts its rays itself (its frames pass
    # sort_rays=False); wavefront.sorted_occlusion around it still answers
    # the bits of the caller's order (K3's plain version over two treelets).
    from raytracer3_tpu_torch.ops import treelets as ttreelets

    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    backend = ttreelets.treelet_backend(host_tris=tris, max_tris=4096, device="cpu")
    rng = np.random.default_rng(15)
    n = 4000
    o = torch.from_numpy(rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)) + torch.tensor([0.0, 4.0, 0.0])
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    cap = torch.from_numpy(rng.uniform(0.5, 20.0, n).astype(np.float32))
    live = torch.arange(n) % 5 != 0
    bounds = (scene.positions.amin(0), scene.positions.amax(0))
    got = twavefront.sorted_occlusion(backend.occluded, o, d, cap, live, bounds)
    ref = backend.occluded(o, d, cap)
    assert torch.equal(got, ref) and 0 < int(ref.sum()) < n


def test_cornell_sample_batch_matches_reference(cornell):
    # settings.sample_batch: both samples in ONE wavefront of 2·W·H lanes.
    jscene, jcam, tscene, tcam = cornell
    s = RenderSettings(width=32, height=32, bounces=2, samples=2, sample_batch=True, diffuse_only=True)
    bn = jrng.generate_blue_noise(16)
    jb = jintersect.brute_backend(scene=jscene)
    jisect, joccl = jb.bind(jb.arrays)
    tb = tintersect.brute_backend(scene=tscene, device="cpu")
    tisect, toccl = tb.bind(tb.arrays)
    for i in range(2):
        ref, jn = jax.jit(lambda fi: jwavefront.render_frame(
            jscene, jcam, s, fi, jisect, joccl, blue_noise=jnp.asarray(bn), return_stats=True))(jnp.uint32(i))
        got, tn = twavefront.render_frame(tscene, tcam, s, i, tisect, toccl, blue_noise=torch.from_numpy(bn),
                                          return_stats=True)
        assert got.shape == (32, 32, 3) and bool(got.isfinite().all())
        share = (np.abs(got.numpy() - np.asarray(ref)).max(-1) <= 1e-4).mean()
        assert share >= 0.99, share
        # The ray meter may differ by a lane whose fate flips on a last-bit
        # difference (a Russian-roulette or NEE threshold).
        assert abs(int(tn) - int(jn)) <= max(2, int(jn) // 1000)


@pytest.mark.parametrize("samples", [1, 2])
def test_wavefront_pipeline_display_matches_reference(cornell, samples):
    jscene, jcam, tscene, tcam = cornell
    s = RenderSettings(width=32, height=32, bounces=2, samples=samples)
    bn = jrng.generate_blue_noise(16)
    jstep, jinit = jpipelines.wavefront_pipeline(
        jscene, s, backend=jintersect.brute_backend(scene=jscene), blue_noise=jnp.asarray(bn))
    tstep, tinit = tpipelines.wavefront_pipeline(
        tscene, s, backend=tintersect.brute_backend(scene=tscene, device="cpu"), blue_noise=torch.from_numpy(bn),
        device="cpu")
    jstate, tstate = jinit(), tinit()
    for i in range(2):
        jdisp, jstate = jstep(jstate, cam=jcam, frame_index=jnp.uint32(i))
        tdisp, tstate = tstep(tstate, tcam, i)
    assert tdisp.shape == (32, 32, 3)
    share = (np.abs(tdisp.numpy() - np.asarray(jdisp)).max(-1) <= 1e-4).mean()
    assert share >= 0.99, share


@pytest.mark.parametrize("frame", [0, 1, 7, 2**24 + 1, 2**31 + 3])
def test_progressive_blendfactor_bit_equal(frame):
    ref = np.asarray(jfilm.progressive_blendfactor(jnp.uint32(frame)))
    got = tfilm.progressive_blendfactor(frame, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_settings_are_the_reference_settings():
    # The port keeps its own copy: the same fields, types and defaults.
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert tconfig.RenderSettings is not RenderSettings
    assert fields(tconfig.RenderSettings) == fields(RenderSettings)
    assert tconfig.RenderSettings.__dataclass_params__.frozen
    s, r = tconfig.RenderSettings(width=64, height=32), RenderSettings(width=64, height=32)
    assert (s.n_pixels, s.probe_grid) == (r.n_pixels, r.probe_grid)


def test_settings_the_slice_does_not_cover_raise(cornell):
    # Every setting of RenderSettings is ported now, so none raises:
    # lane_diet and fuse_shadow render, and fuse_shadow without a fused
    # trace (the caller passes no fused_fn) is the split path to the bit.
    _, _, tscene, tcam = cornell
    tb = tintersect.brute_backend(scene=tscene, device="cpu")
    isect, occl = tb.bind(tb.arrays)
    base = RenderSettings(width=8, height=8, bounces=2)
    split = twavefront.render_frame(tscene, tcam, base, 0, isect, occl)
    for kw in (dict(lane_diet=True), dict(fuse_shadow=True)):
        img = twavefront.render_frame(tscene, tcam, dataclasses.replace(base, **kw), 0, isect, occl)
        assert img.shape == (8, 8, 3) and bool(img.isfinite().all()) and float(img.mean()) > 0
        if "fuse_shadow" in kw:
            assert torch.equal(img, split)


_NO_JAX_SCRIPT = """
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import raytracer3_tpu_torch
for m in pkgutil.walk_packages(raytracer3_tpu_torch.__path__, "raytracer3_tpu_torch."):
    importlib.import_module(m.name)
assert {"raytracer3_tpu_torch.tools.perf_probe", "raytracer3_tpu_torch.utils.profiling",
        "raytracer3_tpu_torch.ops.bvh", "raytracer3_tpu_torch.ops.traverse", "raytracer3_tpu_torch.parallel.mesh",
        "raytracer3_tpu_torch.tools.frame_probe", "raytracer3_tpu_torch.tools.quality_table",
        "raytracer3_tpu_torch.tools.mesh_encoder", "raytracer3_tpu_torch.bench",
        "raytracer3_tpu_torch.tools.make_ground_truth", "raytracer3_tpu_torch.tools.interactive_evidence",
        "raytracer3_tpu_torch.tools.meshopt_bench", "raytracer3_tpu_torch.tools.bench_headline_only"} <= set(sys.modules)
from raytracer3_tpu_torch import bench
assert bench._T0 is None  # importing the bench starts no clock
from raytracer3_tpu_torch.app import world
from raytracer3_tpu_torch.ops import intersect
from raytracer3_tpu_torch.render import pipelines, wavefront
from raytracer3_tpu_torch.scene import analytic, assets, gltf, procedural
from raytracer3_tpu_torch.utils.config import RenderSettings

scene = analytic.cornell_box(device="cpu")
cam = analytic.default_camera(device="cpu")
s = RenderSettings(width=16, height=16, bounces=2)
step, init = pipelines.wavefront_pipeline(scene, s, backend=intersect.brute_backend(scene=scene, device="cpu"), device="cpu")
disp, state = step(init(), cam, 0)
assert disp.shape == (16, 16, 3) and bool(disp.isfinite().all())

# World through GLB ingest, with two instances, and a tiny instanced render.
kw = procedural.atrium(detail=1)
d = tempfile.mkdtemp()
path = os.path.join(d, "a.glb")
gltf.write_glb_multi(path, *(kw[k] for k in ("positions", "normals", "uvs", "indices", "geo_id",
                                              "base_color", "emission", "metallic", "roughness")))
w = world.World()
h = w.add_mesh_data(assets.load_glb_cached(path, cache_dir=d))
w.spawn(h)
t = np.eye(4, dtype=np.float32)
t[:3, 3] = (0.0, 0.0, 20.0)
w.spawn(h, transform=t)
w.env_map = procedural.sky_equirect(16, 32)
b = w.tlas_backend(device="cpu")
isect, occl = b.bind(b.arrays)
img = wavefront.render_frame(w.scene_instanced(device="cpu"), procedural.atrium_camera(1.0, device="cpu"),
                             RenderSettings(width=8, height=8, bounces=2), 0, isect, occl, sort_rays=True)
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "raytracer3_tpu"
             or m.startswith("raytracer3_tpu."))
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_package():
    paths = sorted(glob.glob(os.path.join(REPO, "raytracer3_tpu_torch", "**", "*.py"), recursive=True))
    # chip_smoke.py and the test subprocess that runs parallel/mesh's ranks.
    paths += [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "torch_mesh_worker.py")]
    assert len(paths) > 30
    scanned = {os.path.relpath(p, REPO) for p in paths}
    assert {"raytracer3_tpu_torch/ops/bvh.py", "raytracer3_tpu_torch/ops/traverse.py",
            "raytracer3_tpu_torch/parallel/mesh.py", "raytracer3_tpu_torch/tools/frame_probe.py",
            "raytracer3_tpu_torch/tools/quality_table.py", "raytracer3_tpu_torch/tools/mesh_encoder.py"} <= scanned
    bad = [(os.path.relpath(p, REPO), m) for p in paths for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "raytracer3_tpu")]
    assert not bad, bad
