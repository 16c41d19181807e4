"""The port's bench (``raytracer3_tpu_torch/bench.py``) against ``bench.py``.

- ``run_config`` on the atrium ``detail=1`` at 32×18, 2 bounces, 1 timed
  frame, through ``packet_backend`` (K1/K2's plain version) and through a
  forced treelet backend at 2 samples (sample batch and lane diet on): the
  record carries ``bench.py``'s keys (read from its ``run_config`` with
  ``ast``) without ``ideal_v5e8_fps`` and with the port's own; the film it
  accumulates is bit-equal to ``render_frame`` → ``accumulate_progressive``
  composed by hand; the traced-ray count of each timed frame equals the
  reference's ``render_frame(..., return_stats=True)`` count on the same
  frame through its brute-force backend.
- Both ``_Emitter`` classes fed the same records print the same headline
  lines (the reference's works in a temporary directory, so the repo's
  ``BENCH_DETAILS.json`` is never touched), and their details files hold the
  same records; ``vs_baseline`` is measured Mray/s over the one-card north
  star, 8× the reference's per-chip share.
- ``_pick_spp`` picks as the reference's does over a grid of remaining
  budgets, ``_remaining`` patched in both.
- ``main`` with the renders replaced by stand-ins: ``bench.py``'s eight
  configs in its order, the ladders' top rungs, a raising config isolated
  as an error entry, the details file and the headline line.
- Importing the module does no work: no clock is started.
~25 s alone, most of it the plain traversal and the reference's jit.
"""

import ast
import dataclasses
import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer3_tpu.ops import intersect as jintersect
from raytracer3_tpu.render import wavefront as jwavefront
from raytracer3_tpu.scene import procedural as jprocedural
from raytracer3_tpu.utils.config import RenderSettings
from raytracer3_tpu_torch import bench as tbench
from raytracer3_tpu_torch.ops import rng as trng
from raytracer3_tpu_torch.ops import treelets as ttreelets
from raytracer3_tpu_torch.render import film as tfilm
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import procedural as tprocedural
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, BOUNCES = 32, 18, 2
# The port's keys beside the reference's.
PORT_KEYS = {"frame_ms_each", "warmup_ms", "capture_ms", "host_ms_per_frame", "peak_gib", "launches_per_frame",
             "traced_rays_each"}


@pytest.fixture(scope="module")
def reference_bench():
    spec = importlib.util.spec_from_file_location("reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_record_keys():
    tree = ast.parse(open(os.path.join(REPO, "bench.py"), encoding="utf-8").read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_config")
    ret = next(n for n in fn.body if isinstance(n, ast.Return))  # the record; inner functions return tuples
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def atrium():
    scene, tris = tprocedural.atrium_scene(detail=1, return_host=True, device="cpu")
    cam = tprocedural.atrium_camera(aspect=W / H, device="cpu")
    return scene, tris, cam


@pytest.fixture(scope="module")
def runs(atrium):
    """Both runs of run_config: (record, film, backend, samples) by kind;
    the film is the one ``frames_run`` accumulated inside run_config."""
    scene, tris, cam = atrium
    films = []
    frames_run = tbench.frames_run

    def keep_film(*a, **kw):
        rec = frames_run(*a, **kw)
        films.append(rec["film"])
        return rec

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbench, "frames_run", keep_film)
        rec = tbench.run_config("headline", scene, tris, cam, W, H, BOUNCES, n_frames=1, device="cpu")
        out["packet"] = (rec, films[-1], None, 1)
        tb = ttreelets.treelet_backend(host_tris=tris, max_tris=4096, device="cpu")
        assert tb.meta.num_treelets >= 2 and tb.self_sorting
        rec = tbench.run_config("treelets", scene, tris, cam, W, H, BOUNCES, n_frames=1, samples=2, backend=tb,
                                device="cpu")
        out["treelet_2spp"] = (rec, films[-1], tb, 2)
    return out


@pytest.mark.parametrize("kind", ["packet", "treelet_2spp"])
def test_run_config_record(runs, kind):
    rec, _, _, samples = runs[kind]
    ref_keys = _reference_record_keys()
    assert "ideal_v5e8_fps" in ref_keys and "frame_ms" in ref_keys
    assert set(rec) == (ref_keys - {"ideal_v5e8_fps"}) | PORT_KEYS
    assert (rec["width"], rec["height"], rec["bounces"], rec["samples_per_frame"]) == (W, H, BOUNCES, samples)
    assert rec["frame_ms"] > 0 and rec["fps"] > 0 and rec["mrays_per_s_per_chip"] > 0
    assert len(rec["frame_ms_each"]) == 1 and rec["peak_gib"] is None  # the host has no device memory count
    assert rec["launches_per_frame"] == {}  # the plain versions launch no kernel
    per_px = sum(rec["traced_rays_each"]) / (W * H)
    assert rec["measured_rays_per_pixel"] == round(per_px, 2)
    assert samples * 1 < per_px <= samples * (1 + 2 * BOUNCES)


@pytest.mark.parametrize("kind", ["packet", "treelet_2spp"])
def test_run_config_film_is_the_frames_composed_by_hand(atrium, runs, kind):
    from raytracer3_tpu_torch.ops import traverse_kernel as ttk

    scene, tris, cam = atrium
    _, film, tb, samples = runs[kind]
    backend = tb if tb is not None else ttk.packet_backend(host_tris=tris, device="cpu")
    settings = tbench.bench_settings(W, H, BOUNCES, samples)
    assert (settings.sample_batch, settings.lane_diet, settings.radiance_clamp) == (samples > 1, samples > 1, 50.0)
    isect, occl = backend.bind(backend.arrays)
    bn = torch.as_tensor(trng.generate_blue_noise(64))
    hand = tfilm.Film.create(H, W, device="cpu")
    for fi in range(2):
        radiance = twavefront.render_frame(scene, cam, settings, fi, isect, occl, sort_rays=not backend.self_sorting,
                                           blue_noise=bn, primary_fn=backend.bind_primary(backend.arrays))
        hand = tfilm.accumulate_progressive(hand, radiance)
    assert film.frame_index == hand.frame_index == 2
    assert torch.equal(film.accum, hand.accum)


@pytest.mark.parametrize("kind", ["packet", "treelet_2spp"])
def test_run_config_ray_count_is_the_reference_count(runs, kind):
    rec, _, _, samples = runs[kind]
    jscene, _ = jprocedural.atrium_scene(detail=1, return_host=True)
    jcam = jprocedural.atrium_camera(aspect=W / H)
    s = RenderSettings(**dataclasses.asdict(tbench.bench_settings(W, H, BOUNCES, samples)))
    jb = jintersect.brute_backend(scene=jscene)
    jisect, joccl = jb.bind(jb.arrays)
    bn = jnp.asarray(trng.generate_blue_noise(64))
    _, n = jax.jit(lambda fi: jwavefront.render_frame(jscene, jcam, s, fi, jisect, joccl, sort_rays=True,
                                                      blue_noise=bn, return_stats=True))(jnp.uint32(1))
    assert rec["traced_rays_each"] == [int(n)]


def _records(runs):
    """Eight records named as bench.py's configs, one error entry."""
    head = runs["packet"][0]
    sponza = dict(runs["treelet_2spp"][0])
    out = [dict(head, config="headline")]
    out.append(dict(sponza, config="sponza720", frame_ms=1101.7, spp_per_s=29.05))
    out.append(dict(sponza, config="sponza1080", frame_ms=2350.2, spp_per_s=6.81, mrays_per_s_per_chip=91.5))
    for tag, fps in (("sponza1080_probe_gi", 30.1), ("sponza720_probe_gi", 41.2), ("sponza720_hybrid_gi", 33.3),
                     ("probe_gi", 51.0), ("hybrid_gi", 40.4)):
        out.append({"config": tag, "width": 960, "height": 544, "tris": 19188, "frame_ms": round(1e3 / fps, 1),
                    "fps": fps})
    return out


def test_emitters_print_the_same_headline_lines(runs, reference_bench, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the reference's _Emitter writes BENCH_DETAILS.json into the working directory
    details = str(tmp_path / "port" / "BENCH_DETAILS.json")
    port, ref = tbench._Emitter(details), reference_bench._Emitter()
    lines = {"port": [], "ref": []}
    for r in _records(runs):
        for name, em in (("port", port), ("ref", ref)):
            em.add(r)
            lines[name].append(capsys.readouterr().out)
    for name, em in (("port", port), ("ref", ref)):
        em.fail("sponza_scene", RuntimeError("stand-in"))
        lines[name].append(capsys.readouterr().out)
    assert lines["port"] == lines["ref"]
    last = json.loads(lines["port"][-1].strip().splitlines()[-1])
    assert {"sponza1080_mrays", "sponza720_spp_per_s", "sponza720_probe_gi_fps", "sponza1080_probe_gi_fps"} <= set(last)
    got = json.load(open(details))
    want = json.load(open(tmp_path / "BENCH_DETAILS.json"))
    assert got == want and got[-1] == {"config": "sponza_scene", "error": "RuntimeError: stand-in"}
    # vs_baseline: measured Mray/s over the north star on one card.
    assert tbench.BASELINE_MRAYS_PER_CHIP == pytest.approx(313.344)
    assert tbench.BASELINE_MRAYS_PER_CHIP == pytest.approx(8 * reference_bench.BASELINE_MRAYS_PER_CHIP)
    head = runs["packet"][0]
    mrays = sum(head["traced_rays_each"]) / len(head["traced_rays_each"]) / (head["frame_ms_each"][0] / 1e3) / 1e6
    assert head["vs_baseline"] == round(mrays / 313.344, 4)


def test_emitters_fallback_lines(reference_bench, tmp_path, monkeypatch, capsys):
    # No headline: both print the same error line.
    monkeypatch.chdir(tmp_path)
    port, ref = tbench._Emitter(str(tmp_path / "d.json")), reference_bench._Emitter()
    outs = []
    for mod, em in ((tbench, port), (reference_bench, ref)):
        em.fail("headline", TimeoutError("stand-in"))
        mod._finish(em)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and json.loads(outs[0].strip().splitlines()[-1])["value"] == 0.0


@pytest.mark.parametrize("ladder, per_spp_s, compile_s, n_frames, share", [
    ([32, 16, 8, 4], 0.6, 400.0, 2, 0.45),
    ([16, 8, 4], 2.3, 500.0, 2, 0.8),
    ([32, 16, 8, 4], tbench.PER_SPP_S_720, tbench.WARMUP_S_720, 2, 0.45),
    ([16, 8, 4], tbench.PER_SPP_S_1080, tbench.WARMUP_S_1080, 2, 0.8),
    ([8, 4], 1.0, 0.0, 3, 1.0),
])
def test_pick_spp_matches_reference(reference_bench, monkeypatch, ladder, per_spp_s, compile_s, n_frames, share):
    for remaining in [-10.0, 0.0, 5.0, 12.0, 50.0, 100.0, 300.0, 900.0, 1000.0, 1100.0, 1200.0, 1300.0, 1500.0, 4000.0]:
        monkeypatch.setattr(tbench, "_remaining", lambda: remaining)
        monkeypatch.setattr(reference_bench, "_remaining", lambda: remaining)
        args = (list(ladder), per_spp_s, compile_s, n_frames, share)
        assert tbench._pick_spp(*args) == reference_bench._pick_spp(*args), remaining


def test_main_runs_the_reference_configs_in_order(tmp_path, monkeypatch, capsys):
    # The renders replaced by stand-ins: main's order, ladders, isolation,
    # details file and headline line.
    calls = []
    tris = tuple(np.zeros((3, 3), np.float32) for _ in range(3))
    monkeypatch.setattr(tprocedural, "atrium_scene", lambda **kw: ("small", tris))
    monkeypatch.setattr(tprocedural, "sponza_world_scene", lambda detail, **kw: ("big", tris))
    monkeypatch.setattr(tprocedural, "atrium_camera", lambda aspect, **kw: aspect)

    def run_config(tag, scene, host_tris, cam, width, height, bounces, n_frames=3, samples=1, **kw):
        calls.append((tag, scene, width, height, bounces, n_frames, samples))
        if tag == "sponza1080":
            raise MemoryError("stand-in")
        return {"config": tag, "frame_ms": 10.0, "fps": 100.0, "spp_per_s": 100.0 * samples,
                "mrays_per_s_per_chip": 5.0, "nominal_mrays_per_s_per_chip": 6.0, "vs_baseline": 0.016}

    def run_probe_config(tag, scene, host_tris, cam, width, height, n_frames=3, hybrid=False, settings_kw=None, **kw):
        calls.append((tag, scene, width, height, hybrid, settings_kw))
        return {"config": tag, "frame_ms": 20.0, "fps": 50.0}

    monkeypatch.setattr(tbench, "run_config", run_config)
    monkeypatch.setattr(tbench, "run_probe_config", run_probe_config)
    monkeypatch.setattr(tbench, "_T0", None)
    details = tmp_path / "b" / "BENCH_DETAILS.json"
    assert tbench.main(["--device", "cpu", "--details", str(details)]) == 0
    assert calls == [
        ("headline", "small", 960, 544, 4, 3, 1),
        ("sponza720", "big", 1280, 720, 2, 2, 32),
        ("sponza1080", "big", 1920, 1088, 4, 2, 16),
        ("sponza1080_probe_gi", "big", 1920, 1088, False, {"probe_texel_splits": 2}),
        ("sponza720_probe_gi", "big", 1280, 720, False, None),
        ("sponza720_hybrid_gi", "big", 1280, 720, True, None),
        ("probe_gi", "small", 960, 544, False, None),
        ("hybrid_gi", "small", 960, 544, True, None),
    ]
    recs = json.load(open(details))
    assert [r["config"] for r in recs] == ["headline", "sponza720", "sponza1080_probe_gi", "sponza720_probe_gi",
                                          "sponza720_hybrid_gi", "probe_gi", "hybrid_gi", "sponza1080"]
    assert recs[-1] == {"config": "sponza1080", "error": "MemoryError: stand-in"}
    assert recs[1]["spp_ladder"] == [32, 16, 8, 4] and recs[1]["budget_left_s"] > 1000
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"metric": "mrays_per_s_per_chip", "value": 5.0, "unit": "Mray/s", "vs_baseline": 0.016,
                    "nominal_value": 6.0, "headline_frame_ms": 10.0, "sponza720_spp_per_s": 3200.0,
                    "sponza720_probe_gi_fps": 50.0, "sponza1080_probe_gi_fps": 50.0}


def test_main_caps_the_720p_ladder(tmp_path, monkeypatch):
    spp = []
    tris = tuple(np.zeros((3, 3), np.float32) for _ in range(3))
    monkeypatch.setattr(tprocedural, "atrium_scene", lambda **kw: ("small", tris))
    monkeypatch.setattr(tprocedural, "sponza_world_scene", lambda detail, **kw: ("big", tris))
    monkeypatch.setattr(tprocedural, "atrium_camera", lambda aspect, **kw: aspect)
    rec = {"frame_ms": 10.0, "fps": 100.0, "spp_per_s": 100.0, "mrays_per_s_per_chip": 5.0,
           "nominal_mrays_per_s_per_chip": 6.0, "vs_baseline": 0.016}
    monkeypatch.setattr(tbench, "run_config", lambda tag, *a, samples=1, **kw: spp.append((tag, samples)) or
                        dict(rec, config=tag))
    monkeypatch.setattr(tbench, "run_probe_config", lambda tag, *a, **kw: dict(rec, config=tag))
    monkeypatch.setenv("RT3_BENCH_MAX_SPP720", "8")
    tbench.main(["--device", "cpu", "--details", str(tmp_path / "d.json")])
    assert spp == [("headline", 1), ("sponza720", 8), ("sponza1080", 16)]


def test_cuda_asked_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--details", str(tmp_path / "d.json")])
    assert not (tmp_path / "d.json").exists()


def test_import_does_no_work():
    mod = importlib.reload(tbench)
    assert mod._T0 is None
