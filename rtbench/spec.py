"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, configurations and metrics; each
configuration is ``configs/<name>.json``, each traffic mix
``traffic/<name>.json``, each per-layer metric's reader
``metrics/<name>.py`` and each cell's limits ``limits/<cell>.json``, all
under this directory. A cell is added by adding files and entries; no file
here needs an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files read."""
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json names no workload {name!r}")
    w = entries[0]
    return Cell(
        name=name,
        config=_load_json(os.path.join(here, "configs", f"{w['config']}.json")),
        traffic=_load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{name}.json")),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, here: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
