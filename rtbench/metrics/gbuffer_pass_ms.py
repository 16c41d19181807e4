"""Device ms a frame in the probe frame's G-buffer pass (the tile-ordered
primaries through the backend and the packed words): the kernels between
the pass markers that bracket the frame path's ``gbuffer`` pass, the
markers left out; nothing where the frame path declares no such pass."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("gbuffer",)))
