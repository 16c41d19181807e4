"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, configurations and metrics; each
configuration is ``configs/<name>.json``, each traffic mix
``traffic/<name>.json``, each per-layer metric's reader
``metrics/<name>.py``, each cell's limits ``limits/<cell>.json`` and each
frame path ``frames/<name>.py``, all under this directory. A cell is added
by adding files and entries; no file here needs an edit.

A configuration names its frame path under the optional key ``"frame"``
(``"wavefront"`` where it has none): the rendering mode, and everything
the harness does that depends on it. A frame path's module provides

- ``frame_fn(program)``: the port's viewer frame function for the cell
  (``(film, cam, frame_index) -> (film, display)``), built through the
  port's public entry points from the ``program.Program``'s scene,
  backend, settings and blue noise; it carries ``rays_traced()``, the
  traced rays it counts on the device, which ``traverse_roofline_pct``
  reads;
- ``colour_state(viewer)``: the ``[H, W, 3]`` colour state that the check
  compares as the film;
- ``reference_state(mesh, sky, device)``: the plain reference's own scene
  and tables, from the raw inputs;
- ``reference_frames(config, traffic, state, blue_noise, schedule,
  base_index, n_frames, pix_flat, colour_dtype=None)``: the reference's
  film and display ``[n, P, 3]`` at the sampled pixels after each window
  frame (with ``colour_dtype`` the control's);
- optionally ``PASSES``: the compiled frame's pass order, which the pass
  markers delimit; readers name the passes they read (``spans.passes_us``)
  and find nothing in a frame path without it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_FRAME = "wavefront"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list
    frame: types.ModuleType  # the configuration's frame path (frames/<name>.py)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(kind: str, name: str, here: str) -> types.ModuleType:
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def frame_name(config: dict) -> str:
    """The name of the configuration's frame path."""
    return config.get("frame", DEFAULT_FRAME)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files read and
    its configuration's frame path loaded."""
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json names no workload {name!r}")
    w = entries[0]
    config = _load_json(os.path.join(here, "configs", f"{w['config']}.json"))
    return Cell(
        name=name,
        config=config,
        traffic=_load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{name}.json")),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        frame=frame_path(frame_name(config), here=here),
    )


def frame_path(name: str, here: str = HERE) -> types.ModuleType:
    """The module ``frames/<name>.py``; a ``KeyError`` where there is none."""
    if not os.path.isfile(os.path.join(here, "frames", f"{name}.py")):
        raise KeyError(f"no frame path {name!r} under {here}")
    return _load_module("frames", name, here)


def metric_reader(name: str, here: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _load_module("metrics", name, here).read
