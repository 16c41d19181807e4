"""Device kernels a frame in the traced stretch (the captured graph's
kernels; copies and sets not counted)."""


def read(ctx):
    if not ctx["kernels"]:
        return None
    return len(ctx["kernels"]) / ctx["frames"]
