"""Streaming SpMV for unstructured patterns: expand -> route -> reduce
(counterpart of g4s_tpu/ops/stream_spmv.py).

The schedule is the reference's, built by the same host code:

  1. expand  columns are grouped by width class (degree rounded up a
             geometric ladder); x is permuted once into class-compact
             order (`xplan`) and each class's values broadcast over their
             column-major (L, c) value block.
  2. route   the product stream moves from column-grouped to row-grouped
             order through one static permutation (`route2`).
  3. reduce  per-slice column-major (w, rows) sums, then a permutation
             (`rowplan`) restores the original row order.

All three permutations run through the permute_gather kernel
(ops/route.py), which also reads the unpadded x and y_sorted as if they
were padded with zeros. Heavy hub columns and rows leave the stream and
run as dense `torch.matmul` products plus an `index_add_`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.ops.route import (MAX_M, TILE, PermutePlan, apply_permute,
                                     build_permute_plan, permute_gather)
from g4s_tpu_torch.sparse.containers import as_tensor, resolve_device


def _ladder_up(deg: np.ndarray) -> np.ndarray:
    """Round degrees up to the next rung of the ladder {1, 2, 3, 4, 6, 8,
    12, 16, ...} (pow2 and 1.5*pow2): padding waste <= 4/3."""
    deg = np.maximum(deg, 1)
    p = 2 ** np.ceil(np.log2(deg)).astype(np.int64)          # pow2 >= deg
    three_q = (3 * p) // 4                                   # 1.5 * p/2
    return np.where((deg <= three_q) & (p > 2), three_q, p)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static schedule for one matrix; apply with spmv_stream(plan, x)."""

    xplan: PermutePlan        # x (padded) -> class-compact column order
    vals_e: torch.Tensor      # (m,) values in expand-space order (0 pads)
    route2: PermutePlan       # expand-space slots -> row-binned slots
    rowplan: PermutePlan      # sorted-row order -> original row order
    # hub split (None when the pattern has no heavy hubs)
    hub_cols: Optional[torch.Tensor]     # (n_hub_c,) int32 column ids
    hub_dense_c: Optional[torch.Tensor]  # (n_rows, n_hub_c) A[:, hub_cols]
    hub_rows: Optional[torch.Tensor]     # (n_hub_r,) int32 row ids
    hub_dense_r: Optional[torch.Tensor]  # (n_hub_r, n_cols) minus hub cols
    # each (n_cols_in_class, width L, expand offset, compact-x offset)
    col_classes: Tuple[Tuple[int, int, int, int], ...]
    slices: Tuple[Tuple[int, int, int], ...]  # (rows, w, off)
    n_rows: int
    n_cols: int
    m: int        # padded stream length (route2 space)
    nc_pad: int   # xplan length (n_cols padded)
    nr_pad: int   # rowplan length (n_rows padded)


def _identity_fill(sigma: np.ndarray, used_src: np.ndarray) -> np.ndarray:
    """Complete a partial permutation: dests marked -1 receive the unused
    sources in order (these slots carry pads)."""
    free_dst = np.nonzero(sigma < 0)[0]
    sigma[free_dst] = np.nonzero(~used_src)[0][: free_dst.size]
    return sigma


def _extract_hubs(sp_a, n_rows, n_cols):
    """Pull heavy hub columns/rows out of the matrix for the dense path.
    Returns (remainder_csr, hub_cols, Dc, hub_rows, Dr), hubs None when no
    degree exceeds 8x the mean (or 256). Dense blocks are capped at 64 MB
    each (at most 512 hubs per side)."""
    import scipy.sparse as sps
    coo = sp_a.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data
    nnz = r.size
    hub_cols = Dc = hub_rows = Dr = None
    if nnz == 0:
        return sp_a, hub_cols, Dc, hub_rows, Dr
    keep = np.ones(nnz, bool)
    esize = max(int(np.dtype(v.dtype).itemsize), 4)
    col_deg = np.bincount(c, minlength=n_cols)
    thr_c = max(256, (8 * nnz) // max(n_cols, 1))
    cap_c = min(512, max(1, (64 << 20) // (esize * max(n_rows, 1))))
    cand = np.nonzero(col_deg >= thr_c)[0]
    if cand.size:
        cand = cand[np.argsort(-col_deg[cand], kind="stable")][:cap_c]
        hub_cols = np.sort(cand)
        in_hc = np.zeros(n_cols, bool)
        in_hc[hub_cols] = True
        sel = in_hc[c]
        pos = np.zeros(n_cols, np.int64)
        pos[hub_cols] = np.arange(hub_cols.size)
        Dc = np.bincount(r[sel] * hub_cols.size + pos[c[sel]],
                         weights=v[sel],
                         minlength=n_rows * hub_cols.size) \
            .reshape(n_rows, hub_cols.size).astype(v.dtype)
        keep &= ~sel
    row_deg = np.bincount(r[keep], minlength=n_rows)
    thr_r = max(256, (8 * nnz) // max(n_rows, 1))
    cap_r = min(512, max(1, (64 << 20) // (esize * max(n_cols, 1))))
    cand = np.nonzero(row_deg >= thr_r)[0]
    if cand.size:
        cand = cand[np.argsort(-row_deg[cand], kind="stable")][:cap_r]
        hub_rows = np.sort(cand)
        in_hr = np.zeros(n_rows, bool)
        in_hr[hub_rows] = True
        sel = in_hr[r] & keep
        pos = np.zeros(n_rows, np.int64)
        pos[hub_rows] = np.arange(hub_rows.size)
        Dr = np.bincount(pos[r[sel]] * n_cols + c[sel], weights=v[sel],
                         minlength=hub_rows.size * n_cols) \
            .reshape(hub_rows.size, n_cols).astype(v.dtype)
        keep &= ~sel
    if hub_cols is None and hub_rows is None:
        return sp_a, None, None, None, None
    rem = sps.csr_matrix((v[keep], (r[keep], c[keep])),
                         shape=(n_rows, n_cols))
    return rem, hub_cols, Dc, hub_rows, Dr


def build_stream_plan(a, *, device="cuda",
                      hub_split: bool = True) -> StreamPlan:
    """Compile the streaming schedule for a CSR container or scipy matrix
    (host-side, once per pattern) and stage it on `device`."""
    device = resolve_device(device)
    sp_a = a.to_scipy().tocsr() if hasattr(a, "to_scipy") else a.tocsr()
    n_rows, n_cols = sp_a.shape
    hub_cols = Dc = hub_rows = Dr = None
    if hub_split:
        sp_a, hub_cols, Dc, hub_rows, Dr = _extract_hubs(
            sp_a, n_rows, n_cols)
    csc = sp_a.tocsc()
    csc.sort_indices()
    nnz = csc.nnz
    col_deg = np.diff(csc.indptr).astype(np.int64)

    # ---- expand side: columns grouped by ladder width class ----------
    live = np.nonzero(col_deg > 0)[0]
    Lc = _ladder_up(col_deg[live])
    order_c = np.argsort(Lc, kind="stable")          # class-major columns
    cols_sorted = live[order_c]
    L_sorted = Lc[order_c]

    # per column: its expand-block start and its class's column count.
    # Class blocks are column-major (L, c): entry rank j of the class's
    # i-th column sits at eoff + j*c + i.
    col_classes = []
    col_eoff = np.zeros(n_cols, np.int64)
    col_cls_c = np.ones(n_cols, np.int64)
    pos_e = 0
    pos_x = 0
    i = 0
    while i < cols_sorted.size:
        L = int(L_sorted[i])
        j = i
        while j < cols_sorted.size and L_sorted[j] == L:
            j += 1
        c = j - i
        col_classes.append((c, L, pos_e, pos_x))
        col_eoff[cols_sorted[i:j]] = pos_e + np.arange(c)
        col_cls_c[cols_sorted[i:j]] = c
        pos_e += c * L
        pos_x += c
        i = j
    m_e = pos_e
    n_live = pos_x

    # ---- row-binned destination layout -------------------------------
    row_deg = np.diff(sp_a.indptr).astype(np.int64)
    row_sort = np.argsort(-row_deg, kind="stable")
    widths = _ladder_up(row_deg[row_sort])
    # column-major slice layout (w, nr): rank j of slice-row i sits at
    # pos + j*nr + i, so the reduce is a sum over contiguous rows
    slices = []
    slot_of_row = np.empty(n_rows, np.int64)
    row_slice_nr = np.ones(n_rows, np.int64)
    pos = 0
    i = 0
    while i < n_rows:
        w = int(widths[i])
        j = i
        while j < n_rows and widths[j] == w:
            j += 1
        slices.append((j - i, w, pos))
        slot_of_row[row_sort[i:j]] = pos + np.arange(j - i)
        row_slice_nr[row_sort[i:j]] = j - i
        pos += (j - i) * w
        i = j
    m_r = pos

    m = -(-max(m_e, m_r, 1) // TILE) * TILE
    if m > MAX_M:
        raise NotImplementedError(
            f"padded stream {m} exceeds the routing-plan limit {MAX_M}")

    # ---- expand-space values + entry positions -----------------------
    rank_c = (np.arange(nnz, dtype=np.int64)
              - np.repeat(csc.indptr[:-1].astype(np.int64), col_deg))
    cols_of = np.repeat(np.arange(n_cols, dtype=np.int64), col_deg)
    epos = col_eoff[cols_of] + rank_c * col_cls_c[cols_of]
    vals_e = np.zeros(m, sp_a.dtype)
    vals_e[epos] = csc.data

    # ---- xplan: original x -> class-compact order ---------------------
    nc_pad = -(-max(n_cols, 1) // TILE) * TILE
    sigma_x = np.full(nc_pad, -1, np.int64)
    sigma_x[:n_live] = cols_sorted           # compact slot i <- column
    used = np.zeros(nc_pad, bool)
    used[cols_sorted] = True
    sigma_x = _identity_fill(sigma_x, used)

    # ---- route2: expand-space slot -> row-binned slot ------------------
    rows_cs = csc.indices.astype(np.int64)   # row of each col-sorted entry
    order_r = np.argsort(rows_cs, kind="stable")
    rank_r = np.empty(nnz, np.int64)
    rank_r[order_r] = (np.arange(nnz, dtype=np.int64)
                       - np.repeat(sp_a.indptr[:-1].astype(np.int64),
                                   row_deg))
    dest = slot_of_row[rows_cs] + rank_r * row_slice_nr[rows_cs]
    sigma2 = np.full(m, -1, np.int64)
    sigma2[dest] = epos
    used2 = np.zeros(m, bool)
    used2[epos] = True
    sigma2 = _identity_fill(sigma2, used2)

    # ---- rowplan: sorted-row y -> original row order -------------------
    nr_pad = -(-max(n_rows, 1) // TILE) * TILE
    inv_sort = np.empty(n_rows, np.int64)
    inv_sort[row_sort] = np.arange(n_rows, dtype=np.int64)
    sigma_r = np.concatenate(
        [inv_sort, np.arange(n_rows, nr_pad, dtype=np.int64)])

    def dev(arr, dtype=None):
        if arr is None:
            return None
        return as_tensor(arr, dtype).to(device)

    return StreamPlan(
        build_permute_plan(sigma_x, device=device), dev(vals_e),
        build_permute_plan(sigma2, device=device),
        build_permute_plan(sigma_r, device=device),
        dev(hub_cols, np.int32), dev(Dc), dev(hub_rows, np.int32), dev(Dr),
        tuple(col_classes), tuple(slices), n_rows, n_cols, m, nc_pad, nr_pad)


def _expand(plan: StreamPlan, xc: torch.Tensor) -> torch.Tensor:
    """Products in expand-space order: per class, broadcast the compact x
    values over the class's (L, c) value block; zeros up to plan.m."""
    parts = []
    for c, L, eoff, xoff in plan.col_classes:
        seg = xc[xoff: xoff + c]
        blk = plan.vals_e[eoff: eoff + c * L].view(L, c)
        parts.append((seg[None, :] * blk).reshape(-1))
    dtype = torch.promote_types(plan.vals_e.dtype, xc.dtype)
    m_e = sum(c * L for c, L, _, _ in plan.col_classes)
    parts.append(torch.zeros((plan.m - m_e,), dtype=dtype, device=xc.device))
    return torch.cat(parts)


def spmv_stream(plan: StreamPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the streaming schedule."""
    if tuple(x.shape) != (plan.n_cols,):
        raise ValueError(f"spmv_stream: x has shape {tuple(x.shape)}, the "
                         f"plan expects ({plan.n_cols},)")
    # x and y_sorted go to their gathers unpadded: plan slots past their
    # length read 0, as the reference's zero-padded copies give
    xc = permute_gather(x.contiguous(), plan.xplan.sigma)
    t = apply_permute(plan.route2, _expand(plan, xc))
    y_sorted = torch.cat([t[o: o + nr * w].view(w, nr).sum(dim=0)
                          for nr, w, o in plan.slices])
    y = permute_gather(y_sorted, plan.rowplan.sigma[: plan.n_rows])
    if plan.hub_cols is not None:
        y = y + plan.hub_dense_c.to(y.dtype) \
            @ x[plan.hub_cols.long()].to(y.dtype)
    if plan.hub_rows is not None:
        y = y.index_add(0, plan.hub_rows.long(),
                        plan.hub_dense_r.to(y.dtype) @ x.to(y.dtype))
    return y
