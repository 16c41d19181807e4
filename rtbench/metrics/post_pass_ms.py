"""Device ms a frame in the display (AgX) alone: the kernels between the
pass markers that bracket the frame path's ``post`` pass, the markers left
out; for a frame path with no ``blend`` pass, which ``display_passes_ms``
needs beside it."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("post",)))
