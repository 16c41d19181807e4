"""The guard that the port's tests put in front of the reference's native
library (``tests/reference_native.py``).

Both cases point the reference's ``_LIB_PATH`` at a file under ``tmp_path``
(and ``_SRC`` at a missing file, so that ``get_lib()`` never compiles): the
real ``native/librt3native.so`` is never touched, since other test workers
may be building or loading it.
"""

import os
import subprocess
import threading

import pytest

import reference_native
from raytracer3_tpu import native
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def short_library(tmp_path, monkeypatch):
    """A library path that holds the first bytes of an ELF file only, as
    when another worker's g++ has not finished writing it, and a counter of
    the guard's ``get_lib()`` calls."""
    path = tmp_path / "librt3native.so"
    path.write_bytes(b"\x7fELF\x02\x01\x01")
    monkeypatch.setattr(native, "_LIB_PATH", str(path))
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    calls = []
    get_lib = native.get_lib

    def counted():
        calls.append(1)
        return get_lib()

    monkeypatch.setattr(native, "get_lib", counted)
    return path, calls


def test_guard_fails_once_its_bound_runs_out(short_library):
    _, calls = short_library
    with pytest.raises(pytest.fail.Exception, match="did not load within 0.6 s"):
        reference_native.load(bound_s=0.6, pause_s=0.05)
    # It retried the file after each OSError rather than raising on the first.
    assert len(calls) >= 3


def test_guard_waits_out_a_library_being_written(short_library, tmp_path):
    path, calls = short_library
    built = tmp_path / "built.so"
    subprocess.run(
        ["g++", "-O0", "-shared", "-fPIC", "-std=c++17",
         os.path.join(REPO, "native", "rt3native.cpp"), "-o", str(built)],
        check=True, capture_output=True, timeout=300,
    )
    # The "other worker" finishes its library 0.4 s after the first load.
    finish = threading.Timer(0.4, os.replace, (str(built), str(path)))
    finish.start()
    try:
        lib = reference_native.load(bound_s=60.0, pause_s=0.05)
    finally:
        finish.join()
    assert len(calls) >= 2
    assert hasattr(lib, "rt3_build_sah_bvh")
