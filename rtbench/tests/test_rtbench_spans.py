"""The readers of the program's spans and pass markers on synthetic traces:
the viewer's own time a step, the graph run and the wait inside
``viewer:step``, and the device time of the passes named in the frame
path's pass order."""

from __future__ import annotations

import pytest

import re

from rtbench import spec
from rtbench.frames import wavefront

NEW = ("step_self_ms", "graph_run_ms", "step_wait_ms", "trace_pass_ms", "display_passes_ms")


def _mark(i):
    return f"void (anonymous namespace)::pass_mark_kernel<{i}>()"


def _ctx(frames=2, wait_in_second=True):
    # Two steps of 100 µs each: a 60 µs graph run in both, a 25 µs wait in
    # the second; a drain's wait of 40 µs after them belongs to no step.
    host = [("rtbench:stretch", 0.0, 1000.0),
            ("viewer:step", 10.0, 100.0), ("graph:run", 20.0, 60.0), ("cudaGraphLaunch", 25.0, 50.0),
            ("viewer:step", 200.0, 100.0), ("graph:run", 205.0, 60.0)]
    if wait_in_second:
        host.append(("viewer:wait", 270.0, 25.0))
    host.append(("viewer:wait", 400.0, 40.0))
    # Per frame: a fill before the graph, markers 0..3 around trace (two
    # kernels), blend and post.
    kernels = []
    for f in range(frames):
        t = 1000.0 * f
        kernels += [("fill_kernel", t, 2.0), (_mark(0), t + 10, 1.0),
                    ("void (anonymous namespace)::traverse_walk_kernel<16, 12>(x)", t + 12, 30.0),
                    ("void at::native::vectorized_elementwise_kernel<4>(x)", t + 50, 20.0), (_mark(1), t + 80, 1.0),
                    ("blend_kernel", t + 82, 5.0), (_mark(2), t + 90, 1.0), ("agx_kernel", t + 92, 7.0),
                    (_mark(3), t + 100, 1.0), ("clone_kernel", t + 105, 3.0)]
    kernels.reverse()  # the readers order kernels by start
    dev = [(n, s, d, "kernel") for n, s, d in kernels]
    return {"window_us": (0.0, 2000.0), "device_ops": dev, "kernels": kernels, "host": host, "frames": frames,
            "traced_rays": None, "device_name": "NVIDIA H100 80GB HBM3", "passes": wavefront.PASSES}


def _by_marker_number(ctx, lo, hi):
    """Kernel ms a frame from marker ``lo`` up to marker ``hi``, as the
    pass readers once took it."""
    total, at = 0.0, None
    for n, _, d in sorted(ctx["kernels"], key=lambda k: k[1]):
        m = re.search(r"pass_mark_kernel<(\d+)>", n)
        if m:
            at = int(m.group(1))
        elif at is not None and lo <= at < hi:
            total += d
    return total / 1e3 / ctx["frames"]


def _read(ctx):
    return {n: spec.metric_reader(n)(ctx) for n in NEW}


def test_span_and_marker_readers_on_a_synthetic_trace():
    got = _read(_ctx())
    assert got["graph_run_ms"] == pytest.approx(120.0 / 2 / 1e3)
    assert got["step_wait_ms"] == pytest.approx(25.0 / 2 / 1e3)  # the drain's wait is not a step's
    assert got["step_self_ms"] == pytest.approx((200.0 - 120.0 - 25.0) / 2 / 1e3)
    assert got["trace_pass_ms"] == pytest.approx(2 * 50.0 / 2 / 1e3)  # markers and the fill left out
    assert got["display_passes_ms"] == pytest.approx(2 * 12.0 / 2 / 1e3)


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_pass_readers_read_as_by_marker_number_to_the_bit(frames):
    """By pass name over the wavefront's order, the readers give what
    markers 0→1 and 1→3 gave, bit for bit."""
    ctx = _ctx(frames=frames)
    got = _read(ctx)
    assert got["trace_pass_ms"] == _by_marker_number(ctx, 0, 1)
    assert got["display_passes_ms"] == _by_marker_number(ctx, 1, 3)


def test_pass_readers_find_nothing_where_the_frame_path_lacks_the_passes():
    ctx = _ctx()
    assert [_read(dict(ctx, passes=p))["trace_pass_ms"] for p in (None, ())] == [None, None]
    # A frame path of other passes: neither reader finds its passes, even
    # where a marker brackets a pass of another name.
    got = _read(dict(ctx, passes=("gbuffer", "probe_gi", "post")))
    assert got["trace_pass_ms"] is None and got["display_passes_ms"] is None
    got = _read(dict(ctx, passes=("trace", "post")))
    assert got["trace_pass_ms"] == _by_marker_number(ctx, 0, 1) and got["display_passes_ms"] is None


def test_a_step_that_did_not_wait_reads_zero():
    got = _read(_ctx(wait_in_second=False))
    assert got["step_wait_ms"] == 0.0
    assert got["step_self_ms"] == pytest.approx((200.0 - 120.0) / 2 / 1e3)


def test_readers_find_nothing_without_spans_or_markers():
    ctx = _ctx()
    no_steps = dict(ctx, host=[h for h in ctx["host"] if h[0] != "viewer:step"])
    no_marks = dict(ctx, kernels=[k for k in ctx["kernels"] if "pass_mark_kernel" not in k[0]])
    got_h, got_d = _read(no_steps), _read(no_marks)
    assert [got_h[n] for n in ("step_self_ms", "graph_run_ms", "step_wait_ms")] == [None, None, None]
    assert [got_d[n] for n in ("trace_pass_ms", "display_passes_ms")] == [None, None]
    # Each reads what the other trace still holds.
    assert got_h["trace_pass_ms"] is not None and got_d["graph_run_ms"] is not None
