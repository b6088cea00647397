"""gemm_roofline: the GEMM ops' (aten::mm, addmm, bmm, baddbmm) share of
their roofline: the larger of their operations (2 m n k per call, from
the input shapes recorded) over the card's matmul peak at the
configuration's precision and their bytes (inputs read once, output
written once) over its HBM bandwidth, divided by their self device time,
in %. Read in the short window the traced run profiles with shapes
recorded after its profiled one: every call or step runs the same GEMMs,
and the recording slows the host, not the kernels."""

import sys

from portbench import tracing


def read(ctx):
    if ctx.peak is None:
        return None
    r = tracing.gemm_roofline(ctx.shapes, ctx.peak[0], ctx.peak[1],
                              ctx.itemsize)
    if r is None:
        return None
    print(f"gemm_roofline: {r['ops']} GEMM ops, {r['flops']} FLOP, "
          f"{r['bytes']} bytes, {r['device_s']} s of device, "
          f"{r['bound']}-bound", file=sys.stderr)
    return r["share_pct"]
