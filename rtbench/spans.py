"""The program's own spans and pass markers in a traced stretch, for the
per-layer readers (``metrics/<name>.py``).

Host spans (``user_annotation`` ranges in ``ctx["host"]``, µs): the
viewer's ``viewer:step`` around a whole ``Viewer.step``, ``graph:run``
around the compiled step's call into the device and ``viewer:wait`` around
a wait on a frame in flight; a child belongs to the step whose range holds
its start (a wait from ``drain`` belongs to none).

Device markers (``ctx["kernels"]``): ``pass_mark_kernel<I>``, launched by
the compiled frame before pass I of its order and once after the last. A
kernel belongs to the last marker that started before it. The order is the
frame path's ``PASSES`` (``ctx["passes"]``; the wavefront frame's is
trace, blend, post), so a reader names the passes it reads, not markers."""

from __future__ import annotations

import re

STEP, RUN, WAIT = "viewer:step", "graph:run", "viewer:wait"
_MARK = re.compile(r"pass_mark_kernel<(\d+)>")


def _ranges(ctx, name: str) -> list:
    return [(s, d) for n, s, d in ctx["host"] if n == name]


def in_steps_us(ctx, name: str):
    """µs in the ``name`` spans that start inside a ``viewer:step``; None
    when the stretch holds no step."""
    steps = _ranges(ctx, STEP)
    if not steps:
        return None
    return sum(d for s, d in _ranges(ctx, name) if any(a <= s <= a + b for a, b in steps))


def step_self_us(ctx):
    """µs in ``viewer:step`` less its ``graph:run`` and ``viewer:wait``
    children; None when the stretch holds no step."""
    steps = _ranges(ctx, STEP)
    if not steps:
        return None
    return sum(d for _, d in steps) - in_steps_us(ctx, RUN) - in_steps_us(ctx, WAIT)


def passes_us(ctx, names: tuple):
    """Kernel µs in the passes ``names``: the kernels after the marker
    before each named pass and before the next marker (the markers left
    out). None when the frame path declares no passes or not each of
    ``names``, or the stretch holds no marker."""
    order = ctx.get("passes")
    if not order or any(n not in order for n in names):
        return None
    want = {order.index(n) for n in names}
    total, seen, at = 0.0, False, None
    for n, _, d in sorted(ctx["kernels"], key=lambda k: k[1]):
        m = _MARK.search(n)
        if m:
            seen, at = True, int(m.group(1))
        elif at in want:
            total += d
    return total if seen else None


def per_frame_ms(ctx, us):
    return None if us is None else us / 1e3 / ctx["frames"]
