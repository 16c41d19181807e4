"""Device ms a frame in the film blend and the display (AgX): the kernels
between pass markers 1 and 3 of the compiled wavefront frame, the markers
left out."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.marked_us(ctx, 1, 3))
