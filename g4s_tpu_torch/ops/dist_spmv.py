"""Distributed SpMV: row-block sharding over ranks (counterpart of
g4s_tpu/ops/dist_spmv.py).

The reference's "1D row parallelism" (graph-engine vertex striding across
MPI ranks, RedlichKwongMFTP.cpp:949; FLOP-balanced row partitioning,
BIN.h:100-122): each rank holds one block of the operator's rows as ELL,
x is replicated, each rank computes its rows with the port's `spmv_ell`,
and y stays sharded; `all_gather_rows` gives the whole vector.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from g4s_tpu_torch.ops.spmv import spmv_ell
from g4s_tpu_torch.parallel.mesh import RankGrid
from g4s_tpu_torch.sparse.containers import CSR, ELL, resolve_device
from g4s_tpu_torch.sparse.convert import ell_arrays


def shard_rows_ell(a: CSR, n_shards: int, rank: int, *, pad_to: int = 8,
                   device="cuda") -> Tuple[ELL, int, Tuple[int, int]]:
    """Block `rank` of A's rows split into n_shards equal blocks, as ELL on
    `device`: rows [rank * rows_per, (rank + 1) * rows_per), the rows past
    A's last zero (col 0, val 0), every block as wide as A's widest row
    (csr_to_ell of the whole A, pad_to). Returns (block, rows_per,
    A's shape)."""
    dev = resolve_device(device)
    n_rows = a.shape[0]
    rows_per = -(-n_rows // n_shards)
    cols, vals = ell_arrays(a, pad_to=pad_to)
    r0, r1 = rank * rows_per, min((rank + 1) * rows_per, n_rows)
    c = np.zeros((rows_per, cols.shape[1]), np.int32)
    v = np.zeros((rows_per, cols.shape[1]), vals.dtype)
    if r1 > r0:
        c[:r1 - r0], v[:r1 - r0] = cols[r0:r1], vals[r0:r1]
    block = ELL(torch.from_numpy(c).to(dev), torch.from_numpy(v).to(dev),
                (rows_per, a.shape[1]))
    return block, rows_per, tuple(a.shape)


def dist_spmv(block: ELL, x):
    """y = A @ x for this rank's row block, x replicated: (rows_per,)."""
    return spmv_ell(block, x)


def all_gather_rows(y, grid: RankGrid, axes=None, n_rows=None):
    """The whole y from every rank's (equal-length) block, in rank order
    along `axes`, trimmed to n_rows."""
    parts = [torch.empty_like(y) for _ in range(grid.size(axes))]
    dist.all_gather(parts, y.contiguous(), group=grid.group(axes))
    return torch.cat(parts)[:n_rows]
