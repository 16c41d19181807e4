"""Tracing helpers (port of ``raytracer3_tpu/utils/profiling.py``).

- ``span(name, args=None)`` labels a region for the profiler: with a
  profiler on, a ``torch.profiler.record_function`` range (a
  ``user_annotation`` event on the trace's timeline, so it shares its clock
  with the device's kernels) and an NVTX range when a CUDA device is
  present; with none on, a shared null context, so a span in a hot loop
  costs one boolean read. ``pass_scope(name)`` is a span.
- ``trace(logdir)`` captures host and, with a CUDA device, device activity
  with ``torch.profiler``; the profile is yielded (``key_averages()``) and,
  given a ``logdir``, exported there as a chrome trace.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A context that labels its body ``name`` in a profile (``args``, any
    value, recorded as its string); the shared null context when no
    profiler is on (the flag ``torch.profiler.profile`` and the autograd
    profiler set on entry and clear on exit)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, None if args is None else str(args))


@contextlib.contextmanager
def _recorded(name: str, args):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name, args):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def pass_scope(name: str):
    """Label a region for the profiler (and NVTX on a CUDA device)."""
    return span(name)


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
