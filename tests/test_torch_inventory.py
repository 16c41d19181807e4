"""Completeness of the port: every module of the JAX package has a
counterpart in ``raytracer3_tpu_torch/``, with each public top-level
function and class of the reference's module and each public method of
``World``; so has each of the reference's programs outside the package
(``bench.py`` and ``tools/*.py``, in ``raytracer3_tpu_torch/`` and its
``tools/``). Both are read with ``ast``; nothing is imported.

The exceptions are ROADMAP.md's "Not to port" list (TPU devices the port
has no use for, and the programs it does not port) and names that moved to
another module of the port; each is listed below with its reason.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "raytracer3_tpu", "raytracer3_tpu_torch"

# The port's module for a reference module at another path.
MODULE_MAP = {"ops/pallas/traverse_kernel.py": "ops/traverse_kernel.py"}
# Reference names that live in another module of the port.
MOVED = {("scene/types.py", "sample_texture_array"): "scene/textures.py"}
# ROADMAP.md, "Not to port".
NOT_TO_PORT = {
    # One-hot MXU traversal, built because TPU gathers are slow.
    ("ops/cluster_bvh.py", "cbvh_intersect"),
    ("ops/cluster_bvh.py", "cluster_backend"),
    ("ops/cluster_bvh.py", "make_cluster_backend"),
    # Chunking around the TPU's T(8,128) padding.
    ("ops/mathx.py", "map_row_gather"),
    # The XLA compilation cache and the tunnel watchdog.
    ("utils/runtime.py", "init_compilation_cache"),
    ("utils/runtime.py", "pull_guarded"),
}


# The reference's programs outside the package: the port's file for each.
ENTRY_MAP = {"bench.py": "bench.py"}
MOVED_ENTRY = {("bench.py", "sponza_world_scene"): "scene/procedural.py"}
_RECIPES = "a TPU drive or A/B recipe; chip_smoke.py is the port's counterpart"
# ROADMAP.md, "Not to port": the programs the port has no counterpart of.
NOT_PORTED_ENTRY = {
    "__graft_entry__.py": _RECIPES,
    "tools/dryrun_multihost.py": "the port's multi-process runs are tests/test_torch_parallel_mesh.py over "
                                 "tests/torch_mesh_worker.py (gloo, 2 and 4 processes)",
    "tools/regen_goldens.py": "it rewrites the reference's goldens, which are the port's yardstick",
    **{f"tools/{name}.py": _RECIPES for name in (
        "probe1080", "probe_driver", "probe_fused", "probe_gather", "probe_gather2", "probe_gi1080", "probe_gt",
        "probe_headline_treelet", "probe_leaf", "probe_packet_flags", "probe_r3", "probe_shard_overhead",
        "probe_spp", "probe_stub", "probe_sublanes", "probe_summary", "probe_tail", "verify_drive", "verify_r5",
        "verify_render", "verify_treelet_render")},
}


def _modules():
    root = os.path.join(REPO, REF)
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")


def _top_level(path):
    """{name: node} of a module's top-level functions and classes."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    return {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _port_path(rel):
    return os.path.join(REPO, PORT, MODULE_MAP.get(rel, rel))


REF_MODULES = sorted(_modules())
ENTRY_POINTS = ["__graft_entry__.py", "bench.py"] + sorted(
    f"tools/{f}" for f in os.listdir(os.path.join(REPO, "tools")) if f.endswith(".py"))


def _entry_port_path(rel):
    return os.path.join(REPO, PORT, ENTRY_MAP.get(rel, rel))


def test_reference_has_its_modules():
    # The scan sees the package: 43 modules besides the packages' __init__.
    assert len([m for m in REF_MODULES if not m.endswith("__init__.py")]) == 43


@pytest.mark.parametrize("rel", [m for m in REF_MODULES if not m.endswith("__init__.py")])
def test_module_has_a_counterpart(rel):
    port = _port_path(rel)
    assert os.path.exists(port), f"{REF}/{rel} has no counterpart ({os.path.relpath(port, REPO)})"
    ours = _top_level(port)
    missing = []
    for name in _top_level(os.path.join(REPO, REF, rel)):
        if name.startswith("_") or (rel, name) in NOT_TO_PORT:
            continue
        where = MOVED.get((rel, name))
        if name not in (ours if where is None else _top_level(os.path.join(REPO, PORT, where))):
            missing.append(name)
    assert not missing, f"{REF}/{rel}: no counterpart for {missing}"


def test_reference_has_its_entry_points():
    assert "bench.py" in ENTRY_POINTS and len(ENTRY_POINTS) == 33


@pytest.mark.parametrize("rel", ENTRY_POINTS)
def test_entry_point_has_a_counterpart(rel):
    port = _entry_port_path(rel)
    if rel in NOT_PORTED_ENTRY:
        assert NOT_PORTED_ENTRY[rel] and not os.path.exists(port), f"{rel} is ported: drop it from NOT_PORTED_ENTRY"
        return
    assert os.path.exists(port), f"{rel} has no counterpart ({os.path.relpath(port, REPO)})"
    ours = _top_level(port)
    missing = []
    for name in _top_level(os.path.join(REPO, rel)):
        if name.startswith("_"):
            continue
        where = MOVED_ENTRY.get((rel, name))
        if name not in (ours if where is None else _top_level(os.path.join(REPO, PORT, where))):
            missing.append(name)
    assert not missing, f"{rel}: no counterpart for {missing}"


def test_world_methods():
    ref = _top_level(os.path.join(REPO, REF, "app", "world.py"))["World"]
    port = _top_level(os.path.join(REPO, PORT, "app", "world.py"))["World"]

    def methods(cls):
        return {n.name for n in cls.body if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}

    assert methods(ref) - methods(port) == set()


def test_exceptions_are_still_needed():
    # Every allowlisted name still exists in the reference and is still
    # absent from the port's module, so the lists cannot go stale.
    for rel, name in NOT_TO_PORT:
        assert name in _top_level(os.path.join(REPO, REF, rel)), (rel, name)
        assert name not in _top_level(_port_path(rel)), (rel, name)
    for (rel, name), where in MOVED.items():
        assert name in _top_level(os.path.join(REPO, REF, rel)) and name not in _top_level(_port_path(rel))
        assert name in _top_level(os.path.join(REPO, PORT, where))
    for rel in NOT_PORTED_ENTRY:
        assert os.path.exists(os.path.join(REPO, rel)) and not os.path.exists(_entry_port_path(rel)), rel
    for (rel, name), where in MOVED_ENTRY.items():
        assert name in _top_level(os.path.join(REPO, rel)) and name not in _top_level(_entry_port_path(rel))
        assert name in _top_level(os.path.join(REPO, PORT, where))
