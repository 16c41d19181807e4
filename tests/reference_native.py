"""Load the JAX package's native library before a test builds tables with it.

``raytracer3_tpu.native.get_lib()`` compiles ``native/librt3native.so``
straight onto its final path, loads it as soon as the file exists, and marks
itself as tried before it loads. Under ``pytest -n`` several workers start on
a tree without the library at once: one can load the file while another's
g++ is still writing it, and the ``OSError`` ("file too short") escapes from
whatever fixture first built a cluster table. The reference is not changed
for this; the port's tests wait here instead.

``load()`` calls ``get_lib()`` until it returns the library, resetting the
module's ``_tried``/``_lib`` after each ``OSError`` (or a ``None``: the file
was missing and this process's own build failed), for at most ``bound_s``
seconds. Then it fails the test. It never lets the reference fall back to its
Python builders, which give other tables than the library.
"""

from __future__ import annotations

import time

import pytest

BOUND_S = 120.0


def load(bound_s: float = BOUND_S, pause_s: float = 0.25):
    from raytracer3_tpu import native

    deadline = time.monotonic() + bound_s
    tries = 0
    while True:
        tries += 1
        try:
            lib = native.get_lib()
        except OSError as e:
            why = f"{type(e).__name__}: {e}"
        else:
            if lib is not None:
                return lib
            why = "get_lib() returned None"
        if time.monotonic() >= deadline:
            pytest.fail(
                f"the reference's native library ({native._LIB_PATH}) did not load "
                f"within {bound_s:g} s, {tries} tries; last: {why}",
                pytrace=False,
            )
        with native._lock:
            native._lib = None
            native._tried = False
        time.sleep(pause_s)
