"""Cells, configurations, traffic mixes, per-layer metrics and frame paths
are found by name from data files; a cell, and a frame path, come in from
new files alone."""

from __future__ import annotations

import glob
import json
import os
import shutil
import time

import pytest

from rtbench import run, spec
from rtbench.tests import helpers

ALIAS = ("from rtbench.frames.wavefront import colour_state, frame_fn, reference_frames, reference_state"
         "  # noqa: F401\n")
FRAME_FUNCTIONS = ("frame_fn", "colour_state", "reference_state", "reference_frames")
LIMITS = {"film_err_p50", "worst_frame_bad_pct"}
MARKER_METRICS = ("trace_pass_ms", "display_passes_ms")  # read the wavefront's pass markers


def _here(root: str) -> str:
    return os.path.join(root, "rtbench")


def check_benchmark(root: str):
    """The harness's rules over whatever ``root``'s BENCHMARK.json names
    (an AssertionError, or the harness's own KeyError or OSError, where one
    breaks): names are unique; each configuration's file is the one the
    harness loads; each cell resolves to its configuration and traffic,
    holds both limits and reports ``frame_ms`` and ``setup_s``; a metric
    with a ``workloads`` list applies to exactly the cells it lists, each
    a cell of the benchmark, and each cell it applies to reports the
    end-to-end metric it moves; every per-layer metric has a reader; and
    the wavefront's pass-marker metrics apply only to cells of that path."""
    b = spec.load_benchmark(root)
    here = _here(root)
    metrics = b["end_to_end"] + b["per_layer"]
    for kind, entries in (("configuration", b["configs"]), ("cell", b["workloads"]), ("metric", metrics)):
        names = [e["name"] for e in entries]
        assert len(set(names)) == len(names), f"a {kind} name repeats: {names}"
    for c in b["configs"]:
        assert c["file"] == f"rtbench/configs/{c['name']}.json", f"configuration {c['name']}: file {c['file']}"
    cells = {w["name"] for w in b["workloads"]}
    for m in metrics:
        unknown = set(m.get("workloads", ())) - cells
        assert not unknown, f"metric {m['name']} lists cells the benchmark lacks: {sorted(unknown)}"
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"], here=here)), m["name"]
    for w in b["workloads"]:
        c = spec.cell(w["name"], b, here=here)
        assert w["config"] in {x["name"] for x in b["configs"]}, f"{w['name']}: configuration {w['config']}"
        assert c.config["name"] == w["config"] and c.traffic["name"] == w["traffic"], w["name"]
        assert set(c.limits) == LIMITS, f"{w['name']}: limits keys {sorted(c.limits)}"
        e2e = {m["name"] for m in c.end_to_end}
        reported = e2e | {m["name"] for m in c.per_layer}
        assert {"frame_ms", "setup_s"} <= e2e, f"{w['name']}: end-to-end metrics {sorted(e2e)}"
        for m in metrics:
            listed = "workloads" not in m or w["name"] in m["workloads"]
            assert (m["name"] in reported) == listed, f"{w['name']}: metric {m['name']}"
        for m in c.per_layer:
            assert m["moves"] in e2e, f"{w['name']}: {m['name']} moves {m['moves']}, which the cell lacks"
        if spec.frame_name(c.config) != spec.DEFAULT_FRAME:
            wrong = reported & set(MARKER_METRICS)
            assert not wrong, f"{w['name']} takes frame path {c.config['frame']} but reports {sorted(wrong)}"


def check_frame_paths(root: str):
    """Each configuration of ``root``'s BENCHMARK.json resolves to
    ``frames/<its "frame">.py`` (``wavefront.py`` where it names none), and
    every module under ``frames/`` provides the four functions of a frame
    path (and, where it declares ``PASSES``, a tuple of distinct names)."""
    b = spec.load_benchmark(root)
    here = _here(root)
    for c in b["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            name = spec.frame_name(json.load(f))
        mod = spec.frame_path(name, here=here)
        assert mod.__file__ == os.path.join(here, "frames", f"{name}.py"), c["name"]
    paths = sorted(glob.glob(os.path.join(here, "frames", "*.py")))
    assert paths
    for path in paths:
        mod = spec.frame_path(os.path.basename(path)[:-3], here=here)
        for fn in FRAME_FUNCTIONS:
            assert callable(getattr(mod, fn, None)), f"{path} lacks {fn}"
        passes = getattr(mod, "PASSES", None)
        assert passes is None or (isinstance(passes, tuple) and len(set(passes)) == len(passes)
                                  and all(isinstance(p, str) for p in passes)), f"{path}: PASSES {passes!r}"


def test_root_benchmark_cells_resolve():
    check_benchmark(helpers.ROOT)


def test_a_configuration_without_frame_takes_the_wavefront_path():
    check_frame_paths(helpers.ROOT)
    for name in helpers.TINY:
        c = helpers.cell(name)
        assert "frame" not in c.config
        assert c.frame.__file__ == os.path.join(helpers.DATA, "frames", "wavefront.py")
    mod = spec.frame_path("wavefront")
    for fn in FRAME_FUNCTIONS:
        assert callable(getattr(mod, fn))


PROOF_CONFIG, PROOF_FRAME, PROOF_METRIC = "sponza1080proof", "probeproof", "proof_pass_ms"
PROOF_CELL = f"{PROOF_CONFIG}.walk1"


def _rehearsal(tmp_path):
    """The root BENCHMARK.json and ``rtbench/`` copied to ``tmp_path``, with
    a configuration of another frame path, its frame path (the wavefront's
    functions under a new name), the cell's limits, the cell on ``walk1``
    and a per-layer metric of that cell alone added as new files and
    entries."""
    root = tmp_path / "repo"
    root.mkdir()
    shutil.copy(os.path.join(helpers.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(os.path.join(helpers.ROOT, "rtbench"), root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "rtbench"
    cfg = json.loads((here / "configs" / "sponza1080.json").read_text())
    cfg.update(name=PROOF_CONFIG, frame=PROOF_FRAME)
    (here / "configs" / f"{PROOF_CONFIG}.json").write_text(json.dumps(cfg))
    (here / "frames" / f"{PROOF_FRAME}.py").write_text(ALIAS)
    (here / "limits" / f"{PROOF_CELL}.json").write_text((here / "limits" / "sponza1080.walk1.json").read_text())
    (here / "metrics" / f"{PROOF_METRIC}.py").write_text(
        "from rtbench import spans\n\n\n"
        "def read(ctx):\n"
        "    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ('probe_trace',)))\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    src = next(c for c in b["configs"] if c["name"] == "sponza1080")
    b["configs"].append(dict(src, name=PROOF_CONFIG, file=f"rtbench/configs/{PROOF_CONFIG}.json"))
    b["workloads"].append({"name": PROOF_CELL, "config": PROOF_CONFIG, "traffic": "walk1", "chips": 1,
                           "why": "a frame path of its own on the walk"})
    b["per_layer"].append({"name": PROOF_METRIC, "unit": "ms", "better": "lower", "source": "device_trace",
                           "layer": "probe passes", "moves": "frame_ms", "workloads": [PROOF_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, b


def _mutate(root, b, mutation: str):
    here = root / "rtbench"
    if mutation == "marker_metric_lists_it":
        m = next(m for m in b["per_layer"] if m["name"] == MARKER_METRICS[0])
        m["workloads"].append(PROOF_CELL)
    elif mutation == "unknown_cell_listed":
        next(m for m in b["per_layer"] if m["name"] == PROOF_METRIC)["workloads"].append("sponza1080proof.nope")
    elif mutation == "frame_without_module":
        (here / "frames" / f"{PROOF_FRAME}.py").unlink()
    elif mutation == "limits_missing_key":
        (here / "limits" / f"{PROOF_CELL}.json").write_text(json.dumps({"film_err_p50": 1e-4}))
    elif mutation == "metric_without_reader":
        (here / "metrics" / f"{PROOF_METRIC}.py").unlink()
    (root / "BENCHMARK.json").write_text(json.dumps(b))


MUTATIONS = {"marker_metric_lists_it": "reports", "unknown_cell_listed": "lists cells the benchmark lacks",
             "frame_without_module": "no frame path", "limits_missing_key": "limits keys",
             "metric_without_reader": PROOF_METRIC}


@pytest.mark.parametrize("mutation", [None] + sorted(MUTATIONS))
def test_a_frame_path_added_to_the_real_benchmark_from_new_files_only(tmp_path, mutation):
    """The real benchmark takes a cell of another frame path from new files
    and entries alone, and the checks above pass on it; each rule broken in
    that copy fails them. No cell runs: 1080p is too slow for the CPU."""
    root, b = _rehearsal(tmp_path)
    if mutation is not None:
        _mutate(root, b, mutation)
        with pytest.raises((AssertionError, KeyError, OSError), match=MUTATIONS[mutation]):
            check_benchmark(str(root))
            check_frame_paths(str(root))
        return
    check_benchmark(str(root))
    check_frame_paths(str(root))
    here = str(root / "rtbench")
    c = spec.cell(PROOF_CELL, b, here=here)
    assert c.frame.__file__ == os.path.join(here, "frames", f"{PROOF_FRAME}.py")
    names = {m["name"] for m in c.per_layer}
    assert PROOF_METRIC in names and not names & set(MARKER_METRICS)
    # The old cells keep their metrics; the tiny cells built from the copy
    # do not report the new cell's metric.
    old = spec.cell("sponza1080.walk1", b, here=here)
    assert PROOF_METRIC not in {m["name"] for m in old.per_layer}
    tiny = helpers.bench(root=str(root))
    for name in helpers.TINY:
        names = {m["name"] for m in helpers.cell(name, b=tiny).per_layer}
        assert PROOF_METRIC not in names and set(MARKER_METRICS) <= names


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
