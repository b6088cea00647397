"""Block-ESC SpGEMM: the ESC engine at dense-block granularity
(counterpart of g4s_tpu/ops/spgemm_block.py).

FE stiffness matrices have bs x bs dense node blocks by construction
(CitcomS: 3 dofs per node). The scalar ESC engine (ops/spgemm_esc.py)
prices K @ K badly there: flop/nnz ~ 144 blows the product stream up and
its one sort dominates. At block granularity the same plan machinery runs
on the node pattern: one sort key per block pair-product, with the bs*bs
block components riding the sort as payload. Each pair's block product is
bs^3 broadcast multiplies of (nb, Mh, W) class tiles; layouts keep the
component axis leading, (bs*bs, N).

The scalar CSR -> slab map is composed at plan time (entry e -> block t ->
slab slot p(t), component c), so one small sort and one monotone spread
move a.data straight into the (bs*bs, na) class slabs. Blocks with missing
scalar entries read 0 from the spread's fill: dense-block algebra with
explicit zeros, pruned only when a scalar CSR is asked for.

The reference ships the plan's distance arrays as bit masks and sparse
pairs and expands them on the TPU, because its host link was slow; here
the same dense arrays go to the device directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.ops.shifts import compact, runsum, spread, stages_for
from g4s_tpu_torch.ops.spgemm_esc import (ESCPlan, _class_regions,
                                          _reorder, _slot_order, esc_plan)
from g4s_tpu_torch.sparse.containers import (CSR, as_numpy, as_tensor,
                                              resolve_device)


def block_cover(a: CSR, bs: int) -> float:
    """Fraction of a bs-block cover that is real entries (1.0 = perfect
    blocks). Cheap host statistic for dispatch decisions."""
    if a.shape[0] % bs or a.shape[1] % bs:
        return 0.0
    sp = a.to_scipy().tocoo()
    ids = (sp.row // bs).astype(np.int64) * (a.shape[1] // bs) \
        + sp.col // bs
    return a.nnz / (np.unique(ids).size * bs * bs)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static schedule for C = A @ B over bs x bs blocks."""

    plan: ESCPlan               # scalar ESC plan on the block pattern
    bs: int
    shape: Tuple[int, int]      # scalar shape
    # scalar-CSR -> component-major slab maps (one sort + one spread)
    a_rank: torch.Tensor        # (nnz_a,) int32
    a_d: torch.Tensor           # (bs*bs*na,) int32 spread dists (-1 dead)
    t_a: int
    b_rank: torch.Tensor        # (nnz_b,)
    b_d: torch.Tensor           # (bs*bs*nb_len,)
    t_b: int
    nnz_a: int
    nnz_b: int

    @property
    def c_indptr(self):         # block CSR structure of C
        return self.plan.c_indptr

    @property
    def c_indices(self):
        return self.plan.c_indices

    @property
    def nnz_blocks(self) -> int:
        return self.plan.nnz


def _block_pattern(a: CSR, bs: int):
    """Host: block-cover pattern of a + per-entry (block id, component)."""
    import scipy.sparse as sps
    m, n = a.shape
    if m % bs or n % bs:
        raise ValueError(f"shape {a.shape} not divisible by bs={bs}")
    sp = a.to_scipy()
    sp.sort_indices()
    coo = sp.tocoo()            # data order == CSR entry order
    nbc = n // bs
    idt = np.int32 if (m // bs) * nbc < (1 << 31) else np.int64
    br = (coo.row // bs).astype(idt)
    bc = (coo.col // bs).astype(idt)
    comp = (coo.row % bs).astype(np.int64) * bs + coo.col % bs
    ids = br * idt(nbc) + bc
    # block cover pattern; entry -> block position by one searchsorted
    # against the row-major-sorted unique ids
    pat = sps.coo_matrix(
        (np.ones(ids.size, np.float32), (br, bc)),
        shape=(m // bs, nbc)).tocsr()
    pat.sort_indices()
    uids = np.repeat(
        np.arange(pat.shape[0], dtype=idt),
        np.diff(pat.indptr)) * idt(nbc) + pat.indices.astype(idt)
    inv = np.searchsorted(uids, ids)
    pat.data[:] = 1.0
    return CSR.from_scipy(pat), inv, comp


def _slab_pos(rank: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Compose the inner plan's (rank-sort, spread) into per-entry slab
    positions: entry t lands at rank[t] + d[rank[t]] (or -1 if dead).
    Inactive entries carry an INT32_MAX sentinel rank."""
    pos1 = np.asarray(rank, np.int64)
    dd = np.asarray(d, np.int64)
    live = pos1 < dd.shape[0]
    dpos = np.where(live, dd[np.minimum(pos1, dd.shape[0] - 1)], -1)
    return np.where(dpos >= 0, pos1 + dpos, -1)


def _entry_map(inv: np.ndarray, comp: np.ndarray, slab_of_block,
               slab_len: int, bs: int):
    """Scalar entry e -> flat component-major slab target
    comp[e] * slab_len + slab_of_block[inv[e]]; returns the (rank,
    spread-dists, stages) triple that realizes the map. Sort-free: targets
    are inverted through two O(n) scatters."""
    k2 = bs * bs
    nnz = inv.size
    nblk = slab_of_block.size
    out_len = k2 * slab_len
    # slab position -> block index (injective where live)
    inv_slab = np.full(slab_len, -1, np.int64)
    blive = slab_of_block >= 0
    inv_slab[slab_of_block[blive]] = np.nonzero(blive)[0]
    # (block, component) slot -> entry index (holes: missing entries)
    eid = np.full(nblk * k2, -1, np.int64)
    eid[inv * k2 + comp] = np.arange(nnz, dtype=np.int64)
    # g[c, p] = entry destined for flat slot c*slab_len + p
    g = np.where(inv_slab[None, :] >= 0,
                 eid[np.maximum(inv_slab[None, :], 0) * k2
                     + np.arange(k2, dtype=np.int64)[:, None]],
                 -1).ravel()
    tgt_live = np.nonzero(g >= 0)[0]          # targets, ascending
    order = g[tgt_live]                       # entries in target order
    n_live = order.size
    rank = np.full(nnz, np.iinfo(np.int32).max, np.int32)
    rank[order] = np.arange(n_live, dtype=np.int32)
    # dead entries (block inactive in this product): stable tail ranks
    dead = np.nonzero(rank == np.iinfo(np.int32).max)[0]
    rank[dead] = np.arange(n_live, nnz, dtype=np.int32)
    d = np.full(out_len, -1, np.int32)
    dist = tgt_live - np.arange(n_live, dtype=np.int64)
    d[:n_live] = dist.astype(np.int32)
    t = stages_for(int(dist.max(initial=0)))
    return rank, d, t


def block_plan(a: CSR, b: CSR, bs: int = 3, *, device="cuda") -> BlockPlan:
    """Symbolic phase: scalar ESC plan on the block cover plus the composed
    scalar-entry -> slab maps. Host work, O(nnz) + O(block flops), staged
    on `device`."""
    device = resolve_device(device)
    pa, inv_a, comp_a = _block_pattern(a, bs)
    if b is a:
        pb, inv_b, comp_b = pa, inv_a, comp_a
    else:
        pb, inv_b, comp_b = _block_pattern(b, bs)
    plan = esc_plan(pa, pb, device="cpu")
    sa = _slab_pos(as_numpy(plan.a_rank), as_numpy(plan.d_a))
    sb = _slab_pos(as_numpy(plan.b_rank), as_numpy(plan.d_b))
    # A block element A[p, r] multiplies as the LEFT factor: component
    # layout index p*bs + r. B[r, q] is the RIGHT factor: r*bs + q. Both
    # equal (row%bs)*bs + col%bs in their own matrices.
    a_rank, a_d, t_a = _entry_map(inv_a, comp_a, sa, plan.na, bs)
    b_rank, b_d, t_b = _entry_map(inv_b, comp_b, sb, plan.nb_len, bs)
    put = lambda v: as_tensor(v).to(device)  # noqa: E731
    return BlockPlan(
        plan=plan.to(device), bs=bs, shape=(a.shape[0], b.shape[1]),
        a_rank=put(a_rank), a_d=put(a_d), t_a=t_a,
        b_rank=put(b_rank), b_d=put(b_d), t_b=t_b,
        nnz_a=a.nnz, nnz_b=b.nnz)


def _to_slabs(data, rank, d, slab_len: int, t: int, k2: int):
    """Scalar values -> (k2, slab_len) component-major slabs."""
    v = _reorder(data, rank)
    pad = k2 * slab_len - v.shape[0]
    if pad > 0:
        v = torch.cat([v, v.new_zeros(pad)])
    elif pad < 0:
        # more entries than slab slots: the excess is all dead (inactive
        # block columns/rows), rank-sorted to the tail
        v = v[:k2 * slab_len]
    return spread(v, d, t).view(k2, slab_len)


def block_numeric(a_data: torch.Tensor, b_data: torch.Tensor,
                  bp: BlockPlan) -> torch.Tensor:
    """Value phase on the plan's device: C's block data, component-major
    (bs*bs, nnz_blocks) with component index p*bs+q, from the scalar CSR
    value arrays of A and B. Reusable across value updates."""
    p = bp.plan
    dev = p.device
    bs, k2 = bp.bs, bp.bs * bp.bs
    xa = _to_slabs(a_data.to(dev), bp.a_rank, bp.a_d, p.na, bp.t_a, k2)
    xb = _to_slabs(b_data.to(dev), bp.b_rank, bp.b_d, p.nb_len, bp.t_b, k2)
    prod = torch.empty((k2, p.m2), dtype=torch.promote_types(xa.dtype,
                                                             xb.dtype),
                       device=dev)
    # expand: per class and output component (p, q), the block product
    # sum_r A[p,r] * B[r,q] as bs broadcast multiplies of (nb, Mh, W)
    for nb, mh, w, aoff, boff, poff in _class_regions(p.classes):
        ta = xa[:, aoff:aoff + nb * mh].reshape(bs, bs, nb, mh)
        tb = xb[:, boff:boff + nb * w].reshape(bs, bs, nb, w)
        for i in range(bs):
            for j in range(bs):
                acc = prod[i * bs + j, poff:poff + nb * mh * w] \
                    .view(nb, mh, w)
                torch.mul(ta[i, 0][:, :, None], tb[0, j][:, None, :],
                          out=acc)
                for r in range(1, bs):
                    acc.addcmul_(ta[i, r][:, :, None], tb[r, j][:, None, :])
    # compress: drop pads, one sort carrying the k2 components, reduce
    prod = compact(prod, p.d_pad, p.t_pad)[:, : p.flops]
    sums = runsum(prod[:, _slot_order(p)], p.off_c, p.t_sum)
    return compact(sums, p.d_head, p.t_head)[:, : p.nnz]


def spgemm_block(a: CSR, b: CSR, bs: int = 3,
                 plan: Optional[BlockPlan] = None, *, device="cuda"):
    """C = A @ B through the block-ESC engine. Returns (plan, c_data) with
    c_data component-major (bs*bs, nnz_blocks) where the plan lives; block
    CSR structure lives on the plan."""
    if plan is None:
        plan = block_plan(a, b, bs, device=device)
    return plan, block_numeric(a.data, b.data, plan)


def block_c_to_scipy(bp: BlockPlan, c_data, *, prune: bool = True):
    """Host re-inflation of the BCSR result to a scalar scipy CSR
    (validation / interchange path). prune drops the explicit zeros that
    dense-block storage carries for block-cover holes."""
    import scipy.sparse as sps
    bs = bp.bs
    dat = as_numpy(c_data).reshape(bs, bs, -1).transpose(2, 0, 1)
    out = sps.bsr_matrix((dat, as_numpy(bp.c_indices),
                          as_numpy(bp.c_indptr)),
                         shape=bp.shape, blocksize=(bs, bs)).tocsr()
    if prune:
        out.eliminate_zeros()
    return out
