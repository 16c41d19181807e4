"""Completeness of the port: every module of the JAX package has a
counterpart in ``raytracer3_tpu_torch/``, with each public top-level
function and class of the reference's module and each public method of
``World``. Both packages are read with ``ast``; nothing is imported.

The exceptions are ROADMAP.md's "Not to port" list (TPU devices the port
has no use for) and names that moved to another module of the port; each
is listed below with its reason.
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
