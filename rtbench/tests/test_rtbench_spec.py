"""Cells, configurations, traffic mixes, per-layer metrics and frame paths
are found by name from data files; a cell, and a frame path, come in from
new files alone."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest

from rtbench import run, spec
from rtbench.tests import helpers

ALIAS = ("from rtbench.frames.wavefront import colour_state, frame_fn, reference_frames, reference_state"
         "  # noqa: F401\n")


def test_root_benchmark_cells_resolve():
    b = spec.load_benchmark(helpers.ROOT)
    assert {w["name"] for w in b["workloads"]} == {"sponza1080.walk1", "sponza1080.still16", "atrium1080.walk1"}
    for w in b["workloads"]:
        c = spec.cell(w["name"], b)
        assert c.config["name"] == w["config"] and c.traffic["name"] == w["traffic"]
        assert set(c.limits) == {"film_err_p50", "worst_frame_bad_pct"}
        names = [m["name"] for m in c.end_to_end]
        assert "frame_ms" in names and "setup_s" in names
        assert ("latency_ms_p95" in names) == w["name"].endswith(".walk1")
        for m in c.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        # The wavefront path's pass metrics apply to these cells.
        assert {"trace_pass_ms", "display_passes_ms"} <= {m["name"] for m in c.per_layer}


def test_a_configuration_without_frame_takes_the_wavefront_path():
    b = spec.load_benchmark(helpers.ROOT)
    cells = [(spec.cell(w["name"], b), spec.HERE) for w in b["workloads"]]
    cells += [(helpers.cell(name), helpers.DATA) for name in ("tiny.tinywalk1", "tiny.tinystill16")]
    for c, here in cells:
        assert "frame" not in c.config
        assert c.frame.__file__ == os.path.join(here, "frames", "wavefront.py")
    mod = spec.frame_path("wavefront")
    for fn in ("frame_fn", "colour_state", "reference_state", "reference_frames"):
        assert callable(getattr(mod, fn))


def test_unknown_frame_path_is_refused(tmp_path):
    here = tmp_path / "rtbench"
    shutil.copytree(helpers.DATA, here)
    cfg = json.loads((here / "configs" / "tiny.json").read_text())
    cfg["frame"] = "nope"
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError):
        spec.cell("tiny.tinywalk1", helpers.bench(), here=str(here))
    with pytest.raises(KeyError):
        spec.frame_path("nope")


def test_benchmark_json_keys_and_names():
    b = spec.load_benchmark(helpers.ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(helpers.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in b["per_layer"]:
        assert m["moves"] == "frame_ms"
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_a_cell_added_from_new_files_only(tmp_path):
    here = tmp_path / "rtbench"
    shutil.copytree(helpers.DATA, here)
    cfg = json.loads((here / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny2"
    cfg["render"]["bounces"] = 3
    cfg["frame"] = "tinyalias"
    (here / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    (here / "frames" / "tinyalias.py").write_text(ALIAS)
    tr = json.loads((here / "traffic" / "tinywalk1.json").read_text())
    tr["name"] = "tinyorbit"
    tr["still_frames"] = [2, 4]
    (here / "traffic" / "tinyorbit.json").write_text(json.dumps(tr))
    (here / "limits" / "tiny2.tinyorbit.json").write_text(json.dumps({"film_err_p50": 1e-4,
                                                                       "worst_frame_bad_pct": 20.0}))
    (here / "metrics" / "frames_traced.py").write_text("def read(ctx):\n    return float(ctx['frames'])\n")
    b = helpers.bench(extra_cells=[{"name": "tiny2.tinyorbit", "config": "tiny2", "traffic": "tinyorbit",
                                    "chips": 1, "why": "new"}],
                      extra_metrics=[{"name": "frames_traced", "unit": "frames", "better": "higher",
                                      "source": "device_trace", "layer": "device", "moves": "frame_ms",
                                      "workloads": ["tiny2.tinyorbit"]}])
    c = spec.cell("tiny2.tinyorbit", b, here=str(here))
    assert c.config["render"]["bounces"] == 3 and c.traffic["still_frames"] == [2, 4]
    assert [m["name"] for m in c.per_layer][-1] == "frames_traced"
    assert spec.metric_reader("frames_traced", here=str(here))({"frames": 8}) == 8.0
    assert spec.metric_reader("stretch_frames", here=str(here))({"frames": 2}) == 2.0
    # The old cells do not report the new cell's metric, and keep their frame path.
    old = spec.cell("tiny.tinywalk1", b, here=str(here))
    assert "frames_traced" not in [m["name"] for m in old.per_layer]
    assert old.frame.__file__ == str(here / "frames" / "wavefront.py")
    # The new frame path is the new configuration's, and a whole run takes it.
    assert c.frame.__file__ == str(here / "frames" / "tinyalias.py")
    res, _ = run.run_cell(c, 17, 3.0, False, "cpu", time.perf_counter(), log=lambda *a, **k: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("nope.nope", helpers.bench(), here=helpers.DATA)
