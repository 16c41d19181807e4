"""The traced run's reading of ``torch.profiler``: the stretch of frames
that the window ran under the profiler (CPU and CUDA activity), exported as
a Chrome trace and reduced to device intervals and kernel names for the
per-layer metrics' readers (``metrics/<name>.py``), the device's busy and
window seconds, and the breakdown the result line carries."""

from __future__ import annotations

import collections
import json
import os

import torch

from rtbench import window as window_mod

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")


def profiler():
    """A profiler of CPU and CUDA activity, to be entered around the
    stretch."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def events(prof, path: str) -> list:
    """The trace's events (Chrome-trace dicts), exported through ``path``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def context(evs: list, frames: int, traced_rays, device_name: str, passes) -> dict:
    """What the readers read: the stretch's window (µs, the trace's clock),
    its device ops and kernels (name, start µs, length µs), the host's
    events, its frame count, where counted its traced rays (a list; the
    run gives the stretch's one total, from the frame function's own
    counter) and the frame path's pass order (``PASSES``; None where it
    declares none)."""
    span = [e for e in evs if e.get("ph") == "X" and e.get("name") == "rtbench:stretch"
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError("the trace holds no rtbench:stretch range")
    # The profiler ran over the stretch alone (the frames before it
    # drained), so every device op in the trace is the stretch's. The window
    # runs from the first op to the last: the drained start, before the
    # first frame reaches the device, is not the frame loop's idle time.
    dev_ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"]) for e in evs
               if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if dev_ops:
        lo = min(s for _, s, _, _ in dev_ops)
        hi = max(s + d for _, s, d, _ in dev_ops)
    else:
        lo = float(span[0]["ts"])
        hi = lo + float(span[0]["dur"])
    host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in evs
            if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
    return {"window_us": (lo, hi), "device_ops": dev_ops,
            "kernels": [(n, s, d) for n, s, d, c in dev_ops if c == "kernel"], "host": host,
            "frames": frames, "traced_rays": traced_rays, "device_name": device_name, "passes": passes}


def busy_window_s(ctx: dict) -> tuple:
    lo, hi = ctx["window_us"]
    busy = window_mod.busy([(s, s + d) for _, s, d, _ in ctx["device_ops"]], lo, hi)
    return busy / 1e6, (hi - lo) / 1e6


def breakdown(ctx: dict) -> dict:
    """The ten device ops that took most time (summed by name), and the ten
    longest idle gaps, each named by the innermost host event over its
    middle."""
    by_name = collections.Counter()
    for n, _, d, _ in ctx["device_ops"]:
        by_name[n] += d / 1e6
    lo, hi = ctx["window_us"]
    gaps = window_mod.gaps([(s, s + d) for _, s, d, _ in ctx["device_ops"]], lo, hi)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = (s + e) / 2.0
        over = [(d, n) for n, hs, d in ctx["host"] if hs <= mid <= hs + d and n != "rtbench:stretch"]
        named.append([min(over)[1] if over else "host idle", (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in by_name.most_common(10)], "idle_gaps": named}


def kinds(ctx: dict) -> dict:
    """Device ms a frame by kind of kernel (``window.kind``): the port's own
    traversal kernels, its shade kernel and pass markers, and the shading
    chain's elementwise, gather/scatter, sort, cat, reduction and other
    kernels."""
    out = collections.Counter()
    for n, _, d in ctx["kernels"]:
        out[window_mod.kind(n)] += d / 1e3 / ctx["frames"]
    return dict(out.most_common())
