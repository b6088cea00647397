"""select_ms.md: the self device time of aten::topk, the per-type
neighbour selection of env_mat's _env_sections, per NVT step in the
traced window, ms."""

from portbench import tracing


def read(ctx):
    s = tracing.self_device_s(ctx.trace, "aten::topk")
    return s / ctx.window.counts["steps"] * 1e3 if s else None
