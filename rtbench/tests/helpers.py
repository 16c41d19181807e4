"""Shared pieces of the harness's tests: the tiny CPU cells under
``data/`` (a 32x16 atrium at detail 1, 2 bounces)."""

from __future__ import annotations

import json
import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = ("tiny.tinywalk1", "tiny.tinystill16")


def _config(here: str, name: str) -> dict:
    with open(os.path.join(here, "configs", f"{name}.json")) as f:
        return json.load(f)


def bench(extra_cells=(), extra_metrics=(), root: str = ROOT) -> dict:
    """A BENCHMARK.json for the tiny cells, with the metrics of ``root``'s.
    A listed end-to-end metric goes to the tiny walk; a listed per-layer
    metric goes to both tiny cells where its list names a cell of their
    frame path, and to neither where it names none."""
    from rtbench import spec

    b = spec.load_benchmark(root)
    here = os.path.join(root, "rtbench")
    paths = {w["name"]: spec.frame_name(_config(here, w["config"])) for w in b["workloads"]}
    tiny_path = spec.frame_name(_config(DATA, "tiny"))
    cells = [{"name": f"tiny.tiny{t}", "config": "tiny", "traffic": f"tiny{t}", "chips": 1,
              "why": "a CPU test size"} for t in ("walk1", "still16")]
    e2e = [dict(m) for m in b["end_to_end"]]
    for m in e2e:
        if "workloads" in m:
            m["workloads"] = ["tiny.tinywalk1"]
    per_layer = [dict(m) for m in b["per_layer"]]
    for m in per_layer:
        if "workloads" in m:
            ours = any(paths.get(n) == tiny_path for n in m["workloads"])
            m["workloads"] = [c["name"] for c in cells] if ours else []
    return dict(b, workloads=cells + list(extra_cells), end_to_end=e2e, per_layer=per_layer + list(extra_metrics))


def cell(name: str, here: str = DATA, b: dict | None = None):
    from rtbench import spec

    return spec.cell(name, bench() if b is None else b, here=here)
