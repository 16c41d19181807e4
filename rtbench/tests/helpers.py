"""Shared pieces of the harness's tests: the tiny CPU cells under
``data/`` (a 32x16 atrium at detail 1, 2 bounces)."""

from __future__ import annotations

import json
import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench(extra_cells=(), extra_metrics=()) -> dict:
    """A BENCHMARK.json for the tiny cells, with the root file's metrics."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        root = json.load(f)
    cells = [{"name": f"tiny.tiny{t}", "config": "tiny", "traffic": f"tiny{t}", "chips": 1,
              "why": "a CPU test size"} for t in ("walk1", "still16")]
    e2e = [dict(m) for m in root["end_to_end"]]
    for m in e2e:
        if "workloads" in m:
            m["workloads"] = ["tiny.tinywalk1"]
    per_layer = [dict(m) for m in root["per_layer"]]
    for m in per_layer:  # the wavefront path's metrics: both tiny cells take that path
        if "workloads" in m:
            m["workloads"] = [c["name"] for c in cells]
    return dict(root, workloads=cells + list(extra_cells), end_to_end=e2e, per_layer=per_layer + list(extra_metrics))


def cell(name: str, here: str = DATA, b: dict | None = None):
    from rtbench import spec

    return spec.cell(name, bench() if b is None else b, here=here)
