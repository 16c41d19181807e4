"""Device ms a frame in the film blend and the display (AgX): the kernels
between the pass markers that bracket the frame path's ``blend`` and
``post`` passes, the markers left out; nothing where the frame path lacks
either."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("blend", "post")))
