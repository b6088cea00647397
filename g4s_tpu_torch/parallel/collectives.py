"""Global reductions, the MPI_Allreduce replacement (counterpart of
g4s_tpu/parallel/collectives.py).

CitcomS's CG dot products reduce over all processors but count each
shared boundary node once: `global_vdot` (citcoms/lib/
Global_operations.c:496-529) multiplies by a 0/1 ownership mask before
the allreduce. Here the mask is an explicit `weight` argument and the
allreduce is `dist.all_reduce` over a RankGrid axis or axis set;
sub-communicator reductions (Regional_parallel_related.c:134-204) use the
grid's group of that axis subset.

Each call returns a new tensor, equal on every rank of the group: a host
branch on it takes the same way everywhere.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from g4s_tpu_torch.parallel.mesh import AxisNames, RankGrid


def _all_reduce(x, grid: RankGrid, axes: AxisNames, op):
    x = x.clone()
    dist.all_reduce(x, op=op, group=grid.group(axes))
    return x


def psum_scalar(x, grid: RankGrid, axes: AxisNames = None):
    """Sum of x (a scalar or any tensor, elementwise) over the ranks."""
    return _all_reduce(x, grid, axes, dist.ReduceOp.SUM)


def pdot(a, b, grid: RankGrid, axes: AxisNames = None, *, weight=None):
    """Global <a, b> with per-node ownership weights (global_vdot)."""
    if weight is not None:
        a = a * weight
    return psum_scalar(torch.dot(a.reshape(-1), b.reshape(-1)), grid, axes)


def pnorm2(a, grid: RankGrid, axes: AxisNames = None, *, weight=None):
    """Global L2 norm."""
    return torch.sqrt(pdot(a, a, grid, axes, weight=weight))


def pmax(x, grid: RankGrid, axes: AxisNames = None):
    """Largest entry of x over the ranks."""
    return _all_reduce(x.max(), grid, axes, dist.ReduceOp.MAX)


def pmin(x, grid: RankGrid, axes: AxisNames = None):
    """Smallest entry of x over the ranks."""
    return _all_reduce(x.min(), grid, axes, dist.ReduceOp.MIN)
