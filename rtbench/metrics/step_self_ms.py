"""Host ms a frame in ``Viewer.step`` outside its call into the device and
its wait on a frame in flight (``viewer:step`` less its ``graph:run`` and
``viewer:wait`` children): the viewer's own work in a step."""

from rtbench import spans


def read(ctx):
    return spans.per_frame_ms(ctx, spans.step_self_us(ctx))
