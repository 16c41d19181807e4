"""Host ms a frame in the compiled step's call into the device
(``graph:run`` inside ``viewer:step``: on the card the graph replay with
its input copies and output clones)."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.in_steps_us(ctx, spans.RUN))
