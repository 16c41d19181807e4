"""Device time a frame in every kernel that is not the port's own CUDA: the
shading chain's PyTorch kernels (elementwise, gather/scatter, sort, cat,
reduction, other)."""

from rtbench import window


def read(ctx):
    rest = [d for n, _, d in ctx["kernels"] if not window.is_own(n)]
    if not rest:
        return None
    return sum(rest) / ctx["frames"] / 1e3
