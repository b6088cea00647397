"""device_idle: the share of the traced window in which no device
activity (kernel, copy, fill) runs, from the union of their intervals,
in %."""

from portbench import tracing


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - tracing.busy_s(ctx.trace) / w) if w > 0 else None
