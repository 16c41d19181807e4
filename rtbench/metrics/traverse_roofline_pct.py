"""The traversal's share of its roofline: the least time the stretch's
traced rays need (``rtbench.roofline``: each ray's inputs read once and
its hit written once, over the card's HBM bandwidth) over the time of the
port's own kernels."""

from rtbench import roofline, window


def read(ctx):
    own_us = sum(d for n, _, d in ctx["kernels"] if window.is_own(n))
    rays = ctx.get("traced_rays")
    if own_us <= 0.0 or not rays:
        return None
    floor_s = sum(roofline.traversal_floor_s(r, ctx["device_name"]) for r in rays)
    return 100.0 * floor_s / (own_us / 1e6)
