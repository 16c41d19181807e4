"""Device time a frame in the port's own CUDA kernels (csrc/traverse.cu,
csrc/oracle_bvh.cu), matched by name."""

from rtbench import window


def read(ctx):
    own = [d for n, _, d in ctx["kernels"] if window.is_own(n)]
    if not own:
        return None
    return sum(own) / ctx["frames"] / 1e3
