"""host_call_ms.infer: the median host time of a DeepPot.eval call, from
entering it until it returns, before the read to the host: the host's
cost of enqueueing one call (the harness's span). Read in the untraced
window the traced run makes before its profiled one."""

import statistics


def read(ctx):
    spans = ctx.plain.spans.get("host_call_s")
    return statistics.median(spans) * 1e3 if spans else None
