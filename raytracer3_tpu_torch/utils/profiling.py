"""Tracing and timing helpers (port of ``raytracer3_tpu/utils/profiling.py``).

- ``pass_scope(name)`` labels a region for the profiler: a
  ``torch.profiler.record_function`` range, and an NVTX range when a CUDA
  device is present.
- ``trace(logdir)`` captures host and, with a CUDA device, device activity
  with ``torch.profiler``; the profile is yielded (``key_averages()``) and,
  given a ``logdir``, exported there as a chrome trace.
- ``FrameTimer`` keeps rolling per-frame host times with percentiles;
  ``end(*tensors)`` first waits for the devices those tensors live on.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


@contextlib.contextmanager
def pass_scope(name: str):
    """Label a region for the profiler (and NVTX on a CUDA device)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the body (CPU activity, and CUDA activity when a device is
    present); yields the ``torch.profiler.profile``. With ``logdir`` the
    chrome trace is written to ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class FrameTimer:
    """Rolling frame-time statistics (waits for the device at ``end``)."""

    def __init__(self, window: int = 120):
        self.samples: deque = deque(maxlen=window)
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self, *tensors):
        for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.samples.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        m = sum(self.samples) / max(len(self.samples), 1)
        return 1.0 / m if m > 0 else 0.0

    def percentile_ms(self, p: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        i = min(len(s) - 1, int(p / 100.0 * len(s)))
        return 1e3 * s[i]

    def report(self) -> str:
        return (
            f"{self.mean_ms:.2f} ms/frame ({self.fps:.1f} fps), "
            f"p50 {self.percentile_ms(50):.2f} ms, p99 {self.percentile_ms(99):.2f} ms"
        )
