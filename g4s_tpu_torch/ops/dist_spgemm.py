"""Multi-rank SpGEMM: row-block sharding of A over ranks (counterpart of
g4s_tpu/ops/dist_spgemm.py).

The reference parallelizes SpGEMM by FLOP-balanced row partitions across
threads/ranks (mm/inc/BIN.h:100-122 set_rows_offset; heap_mult.h:56-86
column split). Here each row block of A gets its own two-phase plan on
the host (spgemm_plan of the block's rows, its A offsets shifted to index
the whole A.data); the numeric phase then needs no communication, since
C's rows partition like A's: every rank forms its block's products and
sums them with the port's spgemm numeric (a sorted segment sum, which runs
csrc/segment_sum.cu on the card). `dist_spgemm` gathers the blocks into
one CSR on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from g4s_tpu_torch.ops.spgemm import SpGEMMPlan, spgemm_numeric, spgemm_plan
from g4s_tpu_torch.parallel.mesh import RankGrid
from g4s_tpu_torch.sparse.containers import CSR, as_numpy, resolve_device


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One row block's plan: rows [r0, r1) of A and C."""

    rows: Tuple[int, int]
    plan: Optional[SpGEMMPlan]     # None for a block with no rows
    shape: Tuple[int, int]         # C's shape


def shard_spgemm_plan(a: CSR, b: CSR, n_shards: int, rank: int, *,
                      device="cuda") -> BlockPlan:
    """Row block `rank` of n_shards equal blocks of A: its plan on the host
    (src_a offset into the whole A.data), staged on `device`."""
    dev = resolve_device(device)
    n_rows = a.shape[0]
    rows_per = -(-n_rows // n_shards)
    r0, r1 = rank * rows_per, min((rank + 1) * rows_per, n_rows)
    shape = (a.shape[0], b.shape[1])
    if r1 <= r0:
        return BlockPlan((r0, r0), None, shape)
    indptr = as_numpy(a.indptr).astype(np.int64)
    lo, hi = int(indptr[r0]), int(indptr[r1])
    sub = CSR(torch.from_numpy(indptr[r0:r1 + 1] - lo),
              torch.from_numpy(as_numpy(a.indices)[lo:hi]),
              torch.from_numpy(as_numpy(a.data)[lo:hi]),
              (r1 - r0, a.shape[1]))
    plan = spgemm_plan(sub, b, device=dev)
    src_a = plan.src_a.to(torch.int64) + lo
    if a.nnz < 2 ** 31:
        src_a = src_a.to(plan.src_a.dtype)
    return BlockPlan((r0, r1), dataclasses.replace(plan, src_a=src_a),
                     shape)


def dist_spgemm_numeric(bp: BlockPlan, a_data, b_data):
    """This block's C.data, with no communication: every rank owns its row
    block's products end to end."""
    if bp.plan is None:
        return torch.zeros(0, dtype=torch.as_tensor(a_data).dtype)
    return spgemm_numeric(torch.as_tensor(a_data), torch.as_tensor(b_data),
                          bp.plan)


def _gather_var(x, grid: RankGrid, axes):
    """Every rank's 1-D x (lengths may differ), in rank order."""
    n = grid.size(axes)
    group = grid.group(axes)
    length = torch.tensor([x.numel()], dtype=torch.int64, device=x.device)
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    lengths = [int(v) for v in torch.cat(lengths).tolist()]
    padded = torch.zeros(max(max(lengths), 1), dtype=x.dtype,
                         device=x.device)
    padded[:x.numel()] = x
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    return [p[:k] for p, k in zip(parts, lengths)]


def dist_spgemm(a: CSR, b: CSR, grid: RankGrid, axes=None, *,
                device="cuda") -> CSR:
    """C = A @ B with A (and C) row-sharded over the ranks of `axes`; the
    whole C, gathered, on every rank's device."""
    dev = resolve_device(device)
    rank = int(np.ravel_multi_index(
        [grid.index(x) for x in grid.axes(axes)],
        [grid.sizes[grid.names.index(x)] for x in grid.axes(axes)]))
    bp = shard_spgemm_plan(a, b, grid.size(axes), rank, device=dev)
    data = dist_spgemm_numeric(bp, torch.as_tensor(a.data).to(dev),
                               torch.as_tensor(b.data).to(dev)).to(dev)
    if bp.plan is None:
        indptr = torch.zeros(1, dtype=torch.int32, device=dev)
        indices = torch.zeros(0, dtype=torch.int32, device=dev)
    else:
        indptr, indices = bp.plan.c_indptr, bp.plan.c_indices
    ptrs = _gather_var(indptr, grid, axes)
    idx = _gather_var(indices, grid, axes)
    vals = _gather_var(data, grid, axes)
    base, out_ptr = 0, [ptrs[0][:1]]
    for p in ptrs:
        out_ptr.append(p[1:] + base)
        base += int(p[-1])
    return CSR(torch.cat(out_ptr), torch.cat(idx), torch.cat(vals),
               bp.shape)
