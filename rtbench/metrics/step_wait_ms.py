"""Host ms a frame that ``Viewer.step`` waits on a frame in flight
(``viewer:wait`` inside ``viewer:step``; 0 where no step waited)."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.in_steps_us(ctx, spans.WAIT))
