"""host_step_ms.md: the median host time of an NVTIntegrator.step call
(the harness's span). The step never reads the device, so the span is the
host's enqueue cost, unless the device's launch queue is full and the
host waits for room in it. Read in the untraced window the traced run
makes before its profiled one."""

import statistics


def read(ctx):
    spans = ctx.plain.spans.get("host_step_s")
    return statistics.median(spans) * 1e3 if spans else None
