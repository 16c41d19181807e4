"""The arithmetic of a run, apart from any device: the window's rate and
latency tail from host timestamps, the union of device intervals, idle
gaps, and the classifier of kernel names (a frozen copy of
``raytracer3_tpu_torch/tools/frame_probe.py``'s, with the kernels of
``csrc/oracle_bvh.cu`` added and kinds of their own for the shade kernel
and the pass markers).

Frame times: frame k is called at ``call[k]`` (host clock) and its display
is seen done at ``done[k]`` (the first poll of its event after it
completed; the host waits on the oldest frame in flight, so the poll comes
as the frame ends). The window opens at ``t0`` with nothing in flight and
closes at ``t_end``; frames seen done by ``t_end`` count.

- ``frame_ms``: from ``t0`` to the last display done in the window, over
  the number done in it: a rate over the window's work and time, which a
  frame cut by the close does not quantise.
- ``latency_ms_p95``: the nearest-rank 95th percentile of done − call over
  the frames done in the window."""

from __future__ import annotations

import math
import re

# The port's own CUDA kernels (csrc/traverse.cu, csrc/oracle_bvh.cu).
OWN_KERNELS = (
    "traverse_kernel", "segment_kernel", "tlas_kernel",
    "traverse_stats_kernel", "segment_stats_kernel", "tlas_stats_kernel",
    "traverse_walk_kernel", "traverse_walk_any_kernel", "segment_walk_kernel", "segment_walk_any_kernel",
    "tlas_walk_kernel", "tlas_walk_any_kernel",
    "lbvh_topology_kernel", "lbvh_fit_kernel", "lbvh_walk_kernel", "cluster_walk_kernel", "wide_walk_kernel",
    "rounds_pick_kernel", "rounds_merge_kernel",
)
_OWN_RE = re.compile(r"(?:^|[\s:*&])(" + "|".join(OWN_KERNELS) + r")\s*(?:<|\(|$)")
# Kinds of the other kernels, matched in order on the lower-cased name: the
# port's shade kernel (csrc/shade.cu) and pass markers (csrc/traverse.cu),
# which the shading chain's metrics count as not its own, then PyTorch's.
KINDS = (("shade", ("shade_kernel",)), ("marker", ("pass_mark_kernel",)), ("sort", ("sort", "radix")),
         ("gather/scatter", ("index", "gather", "scatter")), ("cat", ("cat",)), ("reduction", ("reduce",)),
         ("elementwise", ("elementwise", "vectorized")))


def is_own(name: str) -> bool:
    """Whether a device kernel's (demangled) name is one of the port's."""
    return _OWN_RE.search(name) is not None


def kind(name: str) -> str:
    """``traversal`` for the port's own kernels, else the kind of kernel."""
    if is_own(name):
        return "traversal"
    low = name.lower()
    return next((k for k, words in KINDS if any(w in low for w in words)), "other")


def done_in_window(done: list, t_end: float) -> list:
    """Indices of the frames whose display was seen done by ``t_end``."""
    return [k for k, t in enumerate(done) if t is not None and t <= t_end]


def frame_ms(t0: float, done: list, t_end: float):
    """Window from ``t0`` to the last display done by ``t_end``, over the
    displays done in it, in ms; None when none was."""
    ks = done_in_window(done, t_end)
    if not ks:
        return None
    return (max(done[k] for k in ks) - t0) / len(ks) * 1e3


def percentile(values: list, q: float):
    """Nearest-rank percentile (q in (0, 100]); None for no values."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def latency_ms_p95(call: list, done: list, t_end: float):
    lat = [(done[k] - call[k]) * 1e3 for k in done_in_window(done, t_end)]
    return percentile(lat, 95.0)


def merge(intervals: list) -> list:
    """Union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of intervals clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merge(intervals))


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in merge(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
