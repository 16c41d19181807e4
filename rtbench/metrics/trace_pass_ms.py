"""Device ms a frame in the trace pass: the kernels between pass markers 0
and 1 of the compiled wavefront frame, the markers left out."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.marked_us(ctx, 0, 1))
