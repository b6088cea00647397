"""Segment reduction primitives (counterpart of g4s_tpu/ops/segment.py).

`sorted_segment_sum` keeps the reference's sorted-ids contract: on a CUDA
tensor of f32 or f64 it runs the csrc/segment_sum.cu kernel, which adds
each segment's run in index order, so every sum is bitwise repeatable and
equal to the host CPU's `index_add_` (the plain version). The kernel reads
int32 or int64 ids and order as given (other integer types as int64), so a
caller that keeps its plan in int32 moves half the index bytes. Sums over
unsorted ids go through `index_add_`, which adds atomically on CUDA;
max/min/prod through `scatter_reduce(..., include_self=False)` over an
output pre-filled with the identity that `jax.ops.segment_{max,min,prod}`
leaves in empty segments.
"""

from __future__ import annotations

import math

import torch

from g4s_tpu_torch.kernels import _build

_REDUCE = {"max": "amax", "min": "amin", "mul": "prod"}
_KERNELS = {(torch.float32, torch.int64): "g4s_sorted_segment_sum_f32",
            (torch.float64, torch.int64): "g4s_sorted_segment_sum_f64",
            (torch.float32, torch.int32): "g4s_sorted_segment_sum_f32_i32",
            (torch.float64, torch.int32): "g4s_sorted_segment_sum_f64_i32"}
_INT32_MAX = 2**31 - 1

# launches of the segment_sum kernel (CUDA tensors only)
LAUNCHES = 0


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, indices_are_sorted: bool = False):
    """Sum `data` (along dim 0) into `num_segments` buckets."""
    if indices_are_sorted:
        return sorted_segment_sum(data, segment_ids, num_segments)
    return _sorted_segment_sum_plain(data, segment_ids, num_segments)


def _sorted_segment_sum_plain(data, segment_ids, num_segments: int,
                              order=None):
    """Plain PyTorch version of the segment_sum kernel: index_add_, which
    on the CPU adds each segment's terms in index order (and takes ids in
    any order)."""
    if order is not None:
        data = data[order.to(data.device).long()]
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.to(data.device).long(), data)


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, *, order=None):
    """segment_sum with sorted segment ids, summed in a fixed order.

    `order` (optional) gathers the rows first: the result is that of
    data[order], without the gathered copy. A CPU tensor goes through the
    plain version; a CUDA tensor of f32 or f64 through the kernel. Integer
    and bool sums do not depend on the order of addition, so on CUDA they
    keep index_add_; other floating types raise."""
    global LAUNCHES
    if data.device.type == "cpu":
        return _sorted_segment_sum_plain(data, segment_ids, num_segments,
                                         order)
    if not data.is_cuda:
        raise ValueError(f"sorted_segment_sum: unsupported device "
                         f"{data.device}")
    if not (data.dtype.is_floating_point or data.dtype.is_complex):
        return _sorted_segment_sum_plain(data, segment_ids, num_segments,
                                         order)
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sorted_segment_sum: the kernel takes f32 and f64, "
                        f"not {data.dtype}")
    n = data.shape[0] if order is None else order.shape[0]
    if segment_ids.shape != (n,) or (order is not None and order.dim() != 1):
        raise ValueError(f"sorted_segment_sum: {n} rows to sum, ids of "
                         f"shape {tuple(segment_ids.shape)}")
    data = data.contiguous()
    index = _index_dtype(segment_ids, max(n, data.shape[0]), num_segments)
    ids = segment_ids.to(device=data.device, dtype=index).contiguous()
    if order is not None:
        order = order.to(device=data.device, dtype=index).contiguous()
    d = math.prod(data.shape[1:])
    out = torch.empty((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out
    name = _KERNELS[data.dtype, index]
    lib = _build.load()
    with torch.cuda.device(data.device):
        rc = getattr(lib, name)(
            data.data_ptr(), ids.data_ptr(),
            None if order is None else order.data_ptr(), n, d,
            out.data_ptr(), num_segments,
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    _build.check(rc, name)
    return out


def _index_dtype(segment_ids, rows: int, num_segments: int) -> torch.dtype:
    """The kernel's id and order type: int32 where the ids come as int32
    and every row index and segment fits below 2^31 - 1, else int64."""
    if segment_ids.dtype == torch.int32 and max(rows, num_segments) \
            < _INT32_MAX:
        return torch.int32
    return torch.int64


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
        return segment_sum(data, segment_ids, num_segments,
                           indices_are_sorted=indices_are_sorted)
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     _identity(op, data.dtype), dtype=data.dtype,
                     device=data.device)
    ids = segment_ids.to(data.device).long()
    ids = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce=_REDUCE[op],
                               include_self=False)
