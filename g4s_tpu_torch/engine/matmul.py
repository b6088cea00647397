"""Dense matmul through the graph engine (counterpart of
g4s_tpu/engine/matmul.py).

The engine's dense degree-regular graph runs as one `torch.matmul`: the
reference leaves this product to XLA outside any Pallas kernel. Full fp32
precision is the package default (see g4s_tpu_torch/__init__.py), so the
reference's `precision` argument has no counterpart here.
"""

from __future__ import annotations

import torch


def dense_matmul(x, w, *, accum_dtype=None):
    """x @ w in the promoted dtype, accumulating bf16 inputs in f32."""
    out = torch.promote_types(x.dtype, w.dtype)
    acc = accum_dtype
    if acc is None:
        acc = torch.float32 if out == torch.bfloat16 else out
    return torch.matmul(x.to(acc), w.to(acc)).to(out)
