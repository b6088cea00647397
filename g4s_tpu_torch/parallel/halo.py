"""Halo exchange between neighbouring ranks, the MPI Sendrecv replacement
(counterpart of g4s_tpu/parallel/halo.py).

The reference's domain decomposition shares boundary *nodes* between
neighboring processors: after an element-wise operator application each
processor holds partial sums on its boundary planes, and
`regional_exchange_id_d` (citcoms/lib/Regional_parallel_related.c:744-789)
packs each shared plane, MPI_Sendrecv's it to the face neighbor, and
*additively* unpacks (`U[...] += R[k][j-1]`, :777).

Here each rank holds its local (overlapping) block; the boundary planes go
to the axis neighbours in one `dist.batch_isend_irecv` per axis, and the
received planes are added in place. Edge and corner contributions compose
by exchanging the axes in turn: after the first axis the second axis's
boundary planes already hold the first neighbours' contributions, so the
second exchange forwards them to the diagonal neighbours, as the
reference's ordered pass loop does. An end rank receives zeros (it
adds nothing on that side).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from g4s_tpu_torch.parallel.mesh import RankGrid


def _plane(u, dim: int, i: int):
    return u.select(dim, i).contiguous()


def halo_exchange_axis(u, grid: RankGrid, axis: str, dim: int, *,
                       mode: str = "add"):
    """Exchange the two boundary planes of `u` along one grid axis.

    Node-sharing convention (as in the reference): the high plane of rank i
    and the low plane of rank i+1 along `axis` are the SAME physical nodes.
    With mode='add' both copies end up holding the sum of the two partial
    values (the `exchange_id_d` additive combine). With mode='replace' the
    lower-indexed rank owns the shared plane: each rank's low plane is
    overwritten by its left neighbour's (authoritative) high plane.
    Returns a new tensor."""
    if mode not in ("add", "replace"):
        raise ValueError(f"unknown mode {mode!r}")
    n = u.shape[dim]
    left, right = grid.neighbor(axis, -1), grid.neighbor(axis, +1)
    if left is None and right is None:
        return u                          # adding zeros changes nothing
    lo, hi = _plane(u, dim, 0), _plane(u, dim, n - 1)
    from_left = torch.empty_like(lo)      # arrives at my low plane
    from_right = torch.empty_like(hi)     # arrives at my high plane
    ops = []
    if right is not None:
        ops.append(dist.P2POp(dist.isend, hi, right))
    if left is not None:
        ops.append(dist.P2POp(dist.irecv, from_left, left))
    if mode == "add":
        if left is not None:
            ops.append(dist.P2POp(dist.isend, lo, left))
        if right is not None:
            ops.append(dist.P2POp(dist.irecv, from_right, right))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    u = u.clone()
    if mode == "replace":
        if left is not None:
            u.select(dim, 0).copy_(from_left)
        return u
    if left is not None:
        u.select(dim, 0).add_(from_left)
    if right is not None:
        u.select(dim, n - 1).add_(from_right)
    return u


def halo_exchange_add(u, grid: RankGrid, axes: Sequence[tuple]):
    """Additive halo exchange over several grid axes.

    axes: sequence of (grid_axis_name, array_dim). The exchanges run in
    turn so corner/edge nodes accumulate all diagonal contributions (the
    reference achieves the same through its ordered pass tables,
    Regional_parallel_related.c:446)."""
    for axis, dim in axes:
        u = halo_exchange_axis(u, grid, axis, dim, mode="add")
    return u


def halo_copy_ghost(u, grid: RankGrid, axes: Sequence[tuple]):
    """Ghost-plane refresh (replace mode) over several grid axes."""
    for axis, dim in axes:
        u = halo_exchange_axis(u, grid, axis, dim, mode="replace")
    return u
