"""The port's entry-point tools against the reference's:
``tools/make_ground_truth.py``, ``tools/meshopt_bench.py``,
``tools/interactive_evidence.py`` and ``quality_table.tonemap_blocks``.

- ``render_reference`` at 24×16, 16 spp, atrium ``detail=2`` through the
  LBVH (``--device cpu``) against the reference's ``render_reference(cpu=
  True)``: the image rule's mean relative difference < 1e-3 (measured 2.9e-4)
  and ≥ 95% of pixels within 1e-4 (measured 96.9%). Reference mode's frame
  rule (≥ 99.5% within 1e-4, measured on the Cornell box) does not hold on
  the atrium at 16 spp even with brute force on both sides (97.7%): its
  shared edges and GGX lobes turn a last-bit difference of t into another
  path.
- ``main`` writes the stored oracles' npz fields (``--skip-720``, ``--v2``)
  under a temporary directory and nothing into ``resources/``; the 720p
  showcase needs the card.
- The mesh report equals the reference tool's (a subprocess) line by line
  with the ms figures masked, up to the list of what does not apply, which
  names a ray tracer instead of a TPU.
- The interactive loop at 64×36 on the atrium ``detail=1`` with the probe
  pipeline (through the LBVH), 60 frames and 20 timed: the reference's trace
  and summary fields (``docs/interactive_trace_r5.json``), the film's count
  restarting on every moving frame, the five PNGs.
~70 s alone, most of it the reference's jit of reference mode and its
LBVH.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu_torch.ops import traverse as ttraverse
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.scene import procedural as tprocedural
from raytracer3_tpu_torch.tools import bench_headline_only as theadline
from raytracer3_tpu_torch.tools import interactive_evidence as tevidence
from raytracer3_tpu_torch.tools import make_ground_truth as tgt
from raytracer3_tpu_torch.tools import meshopt_bench as tmeshopt
from raytracer3_tpu_torch.tools import quality_table as tquality
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_ground_truth as jgt  # noqa: E402  (the reference's tools)
import quality_table as jquality  # noqa: E402

ORACLES = ("oracle_atrium_192x108.npz", "oracle_atrium_384x216.npz", "oracle_atrium_ggx_384x216.npz")


def test_render_reference_matches_reference():
    w, h = 24, 16
    jscene, jtris = jprocedural.atrium_scene(detail=2, return_host=True)
    tscene, ttris = tprocedural.atrium_scene(detail=2, return_host=True, device="cpu")
    ref = jgt.render_reference(jscene, jtris, jprocedural.atrium_camera(aspect=w / h), w, h, 4, 16, cpu=True)
    got = tgt.render_reference(tscene, ttris, tprocedural.atrium_camera(aspect=w / h, device="cpu"), w, h, 4, 16,
                               device="cpu")
    assert got.shape == ref.shape == (h, w, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.sum() / np.abs(ref).sum() < 1e-3
    assert (d.max(-1) <= 1e-4).mean() >= 0.95


def test_main_writes_the_stored_oracles_fields(tmp_path, monkeypatch):
    calls = []

    def fake(scene, tris, cam, width, height, bounces, spp, batch=8, seed0=0, *, device, backend=None):
        calls.append((width, height, bounces, spp, batch, str(device)))
        return np.full((height, width, 3), 0.5, np.float32)

    monkeypatch.setattr(tgt, "render_reference", fake)
    before = {n: os.stat(os.path.join(REPO, "resources", n)).st_mtime_ns for n in ORACLES}
    out = tmp_path / "gt"
    assert tgt.main(["--skip-720", "--device", "cpu", "--spp", "16", "--out", str(out)]) == 0
    assert tgt.main(["--v2", "--device", "cpu", "--spp", "16", "--out", str(out)]) == 0
    assert calls == [(192, 108, 4, 16, 8, "cpu"), (384, 216, 4, 16, 8, "cpu"), (384, 216, 4, 16, 8, "cpu")]
    for name in ORACLES:
        got, stored = np.load(out / name), np.load(os.path.join(REPO, "resources", name))
        assert got.files == stored.files
        for k in stored.files:
            assert got[k].dtype == stored[k].dtype and got[k].shape == stored[k].shape, (name, k)
            if k not in ("radiance", "spp"):
                assert str(got[k]) == str(stored[k]), (name, k)
        assert int(got["spp"]) == 16
    assert {n: os.stat(os.path.join(REPO, "resources", n)).st_mtime_ns for n in ORACLES} == before
    with pytest.raises(RuntimeError, match="on the card"):
        tgt.main(["--skip-oracle", "--device", "cpu", "--out", str(out)])


def test_tonemap_blocks_matches_reference():
    rad = np.random.default_rng(7).gamma(1.5, 0.6, (24, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(tquality.tonemap_blocks(rad), np.asarray(jquality.tonemap_blocks(rad)),
                               rtol=1e-5, atol=1e-6)


def _mask_ms(text):
    return re.sub(r"\(\s*[0-9.]+ ms\)", "(ms)", text).splitlines()


def test_meshopt_report_matches_reference(capsys):
    reference_native.load()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "tools/meshopt_bench.py", "--detail", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert tmeshopt.main(["--detail", "1"]) == 0
    got, want = _mask_ms(capsys.readouterr().out), _mask_ms(ref.stdout)
    cut = next(i for i, ln in enumerate(want) if ln.startswith("not applicable"))
    assert got[:cut] == want[:cut] and len(got) == len(want)
    assert got[cut] == "not applicable to a ray tracer (docs/PARITY.md):"
    assert [ln.split(":")[0] for ln in got[cut + 1:]] == [ln.split(":")[0] for ln in want[cut + 1:]]
    assert any("ACMR" in ln for ln in got) and any("max-collapse-err" in ln for ln in got)


def test_interactive_loop_small(tmp_path):
    w, h = 64, 36
    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    isect, occl, _ = ttraverse.make_bvh_backend(scene)
    s = RenderSettings(width=w, height=h, bounces=1, samples=1)
    step, init_state = tpipelines.probe_gi_pipeline(scene, s, isect, occl, device="cpu")
    cam = tprocedural.atrium_camera(aspect=w / h, device="cpu")
    out = tmp_path / "ie"
    res = tevidence.evidence(tris, step, init_state, cam, s, 60, str(out), device="cpu")
    ref = json.load(open(os.path.join(REPO, "docs", "interactive_trace_r5.json")))
    trace, summ = res["trace"], res["summary"]
    assert len(trace) == 60 and all(set(t) == set(ref["trace"][0]) for t in trace)
    assert set(ref["summary"]) <= set(summ) and summ["all_displays_finite"]
    assert (summ["width"], summ["height"], summ["tris"], summ["frames"], summ["move_stop_frame"]) == (
        w, h, tris[0].shape[0], 60, 38)
    assert summ["move_to_90pct_converged_s"] > 0
    # The film restarts on every moving frame; the count then climbs again.
    assert [t["spp"] for t in trace[28:41]] == [29, 30, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 4]
    assert [t["phase"] for t in trace[29:39]] == ["warmup"] + ["moving"] * 8 + ["reconverge"]
    assert json.load(open(out / "interactive_trace.json")) == json.loads(json.dumps(res))
    from PIL import Image

    for tag in tevidence.SNAPS.values():
        assert np.asarray(Image.open(out / f"{tag}.png")).shape == (h // 2, w // 2, 3)


@pytest.mark.parametrize("main", [tevidence.main, theadline.main])
def test_tools_need_the_card_unless_told(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])

