"""Segment reduction primitives (counterpart of g4s_tpu/ops/segment.py).

Sums go through `index_add_`; max/min/prod through
`scatter_reduce(..., include_self=False)` over an output pre-filled with the
identity that `jax.ops.segment_{max,min,prod}` leaves in empty segments.
"""

from __future__ import annotations

import torch

_REDUCE = {"max": "amax", "min": "amin", "mul": "prod"}


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, indices_are_sorted: bool = False):
    """Sum `data` (along dim 0) into `num_segments` buckets."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.to(data.device).long(), data)


def sorted_segment_sum(data, segment_ids, num_segments: int):
    """segment_sum with sorted segment ids."""
    return segment_sum(data, segment_ids, num_segments,
                       indices_are_sorted=True)


def _identity(op: str, dtype: torch.dtype):
    if op == "mul":
        return 1
    if dtype == torch.bool:
        return op == "min"
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "add", *,
                   indices_are_sorted: bool = False):
    """Generalized segment reduction: op in {add, max, min, mul}."""
    if op == "add":
        return segment_sum(data, segment_ids, num_segments)
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     _identity(op, data.dtype), dtype=data.dtype,
                     device=data.device)
    ids = segment_ids.to(data.device).long()
    ids = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce=_REDUCE[op],
                               include_self=False)
