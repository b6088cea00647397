"""Semirings for the GraphBLAS-style engine (counterpart of
g4s_tpu/engine/semiring.py): (add, mul) monoid pairs so graph algorithms
(min-plus shortest path, or-and reachability) run through mxv/vxm."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _reducer(fn):
    """Wrap a torch reduction so `axis=None` reduces every dimension."""
    def reduce(x, axis=None):
        return fn(x) if axis is None else fn(x, dim=axis)
    return reduce


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add: Callable          # elementwise combine
    mul: Callable
    zero: Any              # additive identity
    add_reduce: Callable   # reduction along an axis: f(x, axis)

    def reduce(self, x, axis=None):
        return self.add_reduce(x, axis=axis)


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, 0.0,
                      _reducer(torch.sum))
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, float("inf"),
                    _reducer(torch.amin))
MAX_PLUS = Semiring("max_plus", torch.maximum, torch.add, float("-inf"),
                    _reducer(torch.amax))
OR_AND = Semiring("or_and", torch.logical_or, torch.logical_and, False,
                  _reducer(torch.any))
MAX_TIMES = Semiring("max_times", torch.maximum, torch.mul, float("-inf"),
                     _reducer(torch.amax))
