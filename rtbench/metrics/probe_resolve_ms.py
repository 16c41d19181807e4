"""Device ms a frame in the probe math that traces nothing: the passes
``sis`` (each probe's ray budget), ``sh`` (the atlas's SH3 projection) and
``interpolate`` (the lit image from four probes a pixel); nothing where
the frame path lacks one of them."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("sis", "sh", "interpolate")))
