"""Device ms a frame in the probe frame's ``probe_trace`` pass: one ray a
probe texel and its NEE shadow ray through the backend, their shading and
the atlas's temporal blend; nothing where the frame path declares no such
pass."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.passes_us(ctx, ("probe_trace",)))
