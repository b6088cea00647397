"""mfu: the model FLOPs of the work completed in the traced window
(portbench/flops.py's own_type_only count of each frame or step) over
the window and the card's matmul peak at the configuration's precision,
in %."""


def read(ctx):
    if ctx.peak is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.window.model_flops / ctx.trace.window_s / ctx.peak[0]
