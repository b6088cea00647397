"""Sparse matrix-vector products in plain PyTorch (counterpart of
g4s_tpu/ops/spmv.py).

  ELL  — `vals * x[cols]` over a fixed-width padded grid, then a row sum.
  SELL — the ELL product per degree-binned slice, un-permuted by a gather.
  CSR  — gather by nnz, then a sorted segment sum over row ids.
  DIA  — a sum of shifted elementwise multiplies, with no gather.
"""

from __future__ import annotations

import torch

from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.sparse.containers import CSR, DIA, ELL, SELL


def spmv_ell(ell: ELL, x, *, accum_dtype=None):
    """y[i] = sum_k vals[i,k] * x[cols[i,k]]."""
    prod = ell.vals * x[ell.cols.long()]
    if accum_dtype is not None:
        prod = prod.to(accum_dtype)
    return prod.sum(dim=1)


def spmv_sell(sell: SELL, x):
    """Per-slice ELL products, restored to row order with `packed[iperm]`."""
    parts = [spmv_ell(s, x) for s in sell.slices]
    packed = torch.cat(parts) if len(parts) > 1 else parts[0]
    return packed[sell.iperm.long()]


def spmv_csr(csr: CSR, x, *, row_ids=None):
    """Sorted-segment-sum SpMV over CSR; pass `row_ids` (the (nnz,) row of
    each stored entry) precomputed to skip rebuilding them."""
    if row_ids is None:
        row_ids = torch.repeat_interleave(
            torch.arange(csr.shape[0], device=csr.indptr.device),
            (csr.indptr[1:] - csr.indptr[:-1]).long())
    prod = csr.data * x[csr.indices.long()]
    return sorted_segment_sum(prod, row_ids, csr.shape[0])


def spmv_dia(dia: DIA, x):
    """y = A @ x for diagonal storage: sum of shifted multiplies."""
    n = dia.shape[0]
    offs = dia.offsets
    maxoff = max((abs(o) for o in offs), default=0)
    xp = torch.nn.functional.pad(x, (maxoff, maxoff))
    y = torch.zeros((n,), dtype=torch.promote_types(dia.vals.dtype, x.dtype),
                    device=x.device)
    for i, o in enumerate(offs):
        y = y + dia.vals[i] * xp[maxoff + o: maxoff + o + n]
    return y


def spmv_dense_rows(edge_weight, x_gathered):
    """The degree-regular dense case: every vertex has exactly `degree`
    neighbors with a dense weight block. Both (n_vertices, degree)."""
    return (edge_weight * x_gathered).sum(dim=1)


def spmv(a, x):
    """Layout-dispatching spmv."""
    if isinstance(a, DIA):
        return spmv_dia(a, x)
    if isinstance(a, ELL):
        return spmv_ell(a, x)
    if isinstance(a, SELL):
        return spmv_sell(a, x)
    if isinstance(a, CSR):
        return spmv_csr(a, x)
    dt = torch.promote_types(a.dtype, x.dtype)
    return torch.matmul(a.to(dt), x.to(dt))
