"""Share of the traced stretch with no operation on the device: the union
of its kernels, copies and sets against the stretch's length."""

from rtbench import window


def read(ctx):
    lo, hi = ctx["window_us"]
    if not ctx["device_ops"] or hi <= lo:
        return None
    return 100.0 * (1.0 - window.busy([(s, s + d) for _, s, d, _ in ctx["device_ops"]], lo, hi) / (hi - lo))
