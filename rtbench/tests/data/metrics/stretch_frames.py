"""Frames in the traced stretch: a reader of the test data's own, found
by name under a copy of this directory."""


def read(ctx):
    return float(ctx["frames"]) if ctx["frames"] else None
