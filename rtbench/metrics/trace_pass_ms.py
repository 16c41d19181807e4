"""Device ms a frame in the trace pass: the kernels between the pass
markers that bracket the frame path's ``trace`` pass, the markers left out;
nothing where the frame path declares no ``trace`` pass."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("trace",)))
