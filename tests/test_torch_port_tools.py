"""The port's tools against the reference's: ``tools/mesh_encoder.py``
(tests/test_app_utils.py's TestMeshEncoderCLI), ``tools/frame_probe.py``
and ``tools/quality_table.py``.

- mesh_encoder: the encoded bytes equal the reference tool's for the same
  GLB (optimised and not), each package decodes the other's file to equal
  arrays, and the ``--analyze`` report is the reference's text.
- frame_probe: runs on the CPU (``--device cpu``, 32×16, the plain
  versions) with and without ``--stub`` and prints one finite record per
  variant; without a card and without ``--device cpu`` it exits 1.
- quality_table: ``block_means`` and ``ssim`` equal the reference's on the
  same images; one mode's row on a small seeded oracle (48×32, atrium
  detail 1, 2 frames, brute force) within 2e-3 of the reference pipeline's
  row (the probe display parts from the reference's at the 1e-3 level on
  edge-tie pixels, ROADMAP.md Queue 3).
~30 s alone, most of it the frame probe's plain traversal and the reference's
jit of the probe pipeline.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.scene import gltf as jgltf
from raytracer3_tpu_torch.scene import gltf as tgltf
from raytracer3_tpu_torch.tools import frame_probe, mesh_encoder as tenc, quality_table as tquality
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import mesh_encoder as jenc  # noqa: E402  (the reference's tool)


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    reference_native.load()


@pytest.fixture(scope="module")
def quad_glb(tmp_path_factory):
    glb = str(tmp_path_factory.mktemp("enc") / "m.glb")
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(np.asarray([0, 0, 1], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tgltf.write_glb(glb, pos, idx, normals=nrm, uvs=uv, base_color=(0.5, 0.5, 0.5, 1))
    return glb


@pytest.fixture(scope="module")
def noisy_glb(tmp_path_factory):
    glb = str(tmp_path_factory.mktemp("enc") / "n.glb")
    pos = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, 64, (100, 3)).astype(np.int32)
    tgltf.write_glb(glb, pos, idx)
    return glb


def _assert_mesh_equal(a, b):
    for k in ("positions", "normals", "uvs", "indices", "geo_id", "base_color", "emission", "metallic",
              "roughness", "base_color_texture"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_mesh_encoder_roundtrip(quad_glb):
    md = tgltf.load_glb(quad_glb)
    blob = tenc.encode(md)
    md2 = tenc.decode(blob)
    assert md2.indices.shape == (2, 3)
    assert np.abs(np.sort(md2.positions, 0) - np.sort(md.positions, 0)).max() < 1e-3
    assert np.sum(md2.normals * md.normals, axis=-1).min() > 0.99


@pytest.mark.parametrize("optimize", [True, False])
def test_mesh_encoder_bytes_equal_the_reference(noisy_glb, optimize):
    blob = tenc.encode(tgltf.load_glb(noisy_glb), optimize=optimize)
    assert blob == jenc.encode(jgltf.load_glb(noisy_glb), optimize=optimize)
    # Each package decodes the other's file.
    _assert_mesh_equal(tenc.decode(blob), jenc.decode(blob))


def test_mesh_encoder_cli(noisy_glb, tmp_path, capsys):
    assert tenc.main([noisy_glb, "--analyze"]) == 0
    out = capsys.readouterr().out
    assert "ACMR" in out
    assert jenc.main([noisy_glb, "--analyze"]) == 0
    assert capsys.readouterr().out == out
    ours, theirs = str(tmp_path / "t.rtmesh"), str(tmp_path / "j.rtmesh")
    assert tenc.main([noisy_glb, ours]) == 0 and jenc.main([noisy_glb, theirs]) == 0
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("stub", [False, True])
def test_frame_probe_on_the_cpu(capsys, stub):
    argv = ["--device", "cpu", "--width", "32", "--height", "16", "--detail", "1", "--reps", "1"]
    assert frame_probe.main(argv + (["--stub"] if stub else [])) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["variant"] for r in recs] == ["full (4b, nee, sort)", "no nee", "bounces=1", "bounces=2"] + (
        ["stub no sort"] if stub else [])
    assert all(r["film_finite"] and r["frame_ms"] > 0 and r["stub"] == stub for r in recs)


def test_tools_without_a_card_exit_1(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert frame_probe.main(["--width", "32"]) == 1
    assert tquality.main(["--frames", "1"]) == 1


def test_quality_table_helpers_match_the_reference():
    import quality_table as jquality

    rng = np.random.default_rng(3)
    a, b = rng.uniform(size=(2, 36, 52, 3)).astype(np.float32)
    np.testing.assert_array_equal(tquality.block_means(a), jquality.block_means(a))
    assert tquality.ssim(a, b) == jquality.ssim(a, b)


def test_quality_table_row_against_the_reference(tmp_path):
    # A small seeded "oracle" at the atrium's detail 1: the port's row for
    # probe_gi against the same row computed the reference tool's way.
    import quality_table as jquality
    from raytracer3_tpu.ops import intersect as jintersect
    from raytracer3_tpu.ops import tonemap as jtonemap
    from raytracer3_tpu.render import pipelines as jpipelines
    from raytracer3_tpu.scene import procedural as jprocedural
    from raytracer3_tpu.utils.config import RenderSettings as JSettings

    h, w = 32, 48
    radiance = np.random.default_rng(4).uniform(0.0, 2.0, (h, w, 3)).astype(np.float32)
    path = str(tmp_path / "oracle.npz")
    np.savez(path, radiance=radiance, spp=np.int32(1), bounces=np.int32(1), detail=np.int32(1))
    (row,) = tquality.table(frames=2, oracle=path, device="cpu", modes=tquality.MODES[:1])

    scene, _ = jprocedural.atrium_scene(detail=1, return_host=True)
    step, init_state = jpipelines.probe_gi_pipeline(
        scene, JSettings(width=w, height=h, bounces=1, samples=1, probe_spacing=12, probe_res=8),
        backend=jintersect.brute_backend(scene=scene))
    state = init_state()
    cam = jprocedural.atrium_camera(aspect=w / h)
    for i in range(2):
        disp, state = step(state, cam=cam, frame_index=jnp.uint32(i))
    d_full = np.asarray(disp)
    ref_disp = np.asarray(jtonemap.agx_tonemap(jnp.asarray(radiance), look="punchy"))
    diff = np.abs(jquality.block_means(d_full) - jquality.tonemap_blocks(radiance))
    assert row["mode"] == "probe_gi" and row["frames"] == 2
    assert row["mean_block_diff"] == pytest.approx(float(diff.mean()), abs=2e-3)
    assert row["p99_block_diff"] == pytest.approx(float(np.percentile(diff, 99)), abs=2e-3)
    assert row["brightness_ratio"] == pytest.approx(
        float(jquality.block_means(d_full).mean() / jquality.tonemap_blocks(radiance).mean()), abs=2e-3)
    assert row["ssim"] == pytest.approx(jquality.ssim(d_full, ref_disp), abs=2e-3)


@pytest.mark.gpu
def test_tools_on_card(capsys):
    """frame_probe (real and stubbed) and one quality-table row on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    for stub in ([], ["--stub"]):
        assert frame_probe.main(["--width", "64", "--height", "32", "--reps", "1"] + stub) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(recs) == 9 and all(r["film_finite"] for r in recs)
    (row,) = tquality.table(frames=2, device="cuda", modes=tquality.MODES[:1])
    assert 0.0 < row["mean_block_diff"] < 0.5 and 0.0 < row["ssim"] <= 1.0
