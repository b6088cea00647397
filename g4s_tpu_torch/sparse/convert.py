"""Host-side layout conversions between sparse containers.

Counterpart of g4s_tpu/sparse/convert.py, with the same numpy algorithms
(so both packages produce identical arrays). Inputs may hold tensors on any
device or numpy arrays; outputs hold CPU tensors — move them with
`.to(device)`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from g4s_tpu_torch.sparse.containers import (COO, CSC, CSR, DIA, ELL, SELL,
                                             as_numpy, as_tensor)

_as_np = as_numpy
_t = as_tensor


def coo_to_csr(m: COO, *, sort: bool = True,
               sum_duplicates: bool = False) -> CSR:
    row, col, val = _as_np(m.row), _as_np(m.col), _as_np(m.val)
    n_rows, n_cols = m.shape
    if sort:
        # row-major (row, col) order
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
    if sum_duplicates and row.size:
        key = row.astype(np.int64) * n_cols + col.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        val = np.bincount(inv, weights=val,
                          minlength=uniq.size).astype(val.dtype)
        row = (uniq // n_cols).astype(row.dtype)
        col = (uniq % n_cols).astype(col.dtype)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(indptr, row + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(_t(indptr), _t(col.astype(np.int32)), _t(val),
               (n_rows, n_cols))


def coo_to_csc(m: COO, *, sort: bool = True,
               sum_duplicates: bool = False) -> CSC:
    t = COO(m.col, m.row, m.val, (m.shape[1], m.shape[0]))
    c = coo_to_csr(t, sort=sort, sum_duplicates=sum_duplicates)
    return CSC(c.indptr, c.indices, c.data, m.shape)


def csr_to_coo(m: CSR) -> COO:
    indptr = _as_np(m.indptr)
    row = np.repeat(np.arange(m.n_rows, dtype=np.int32), np.diff(indptr))
    return COO(_t(row), _t(_as_np(m.indices)), _t(_as_np(m.data)), m.shape)


def csr_to_csc(m: CSR) -> CSC:
    return coo_to_csc(csr_to_coo(m))


def csc_to_csr(m: CSC) -> CSR:
    indptr = _as_np(m.indptr)
    col = np.repeat(np.arange(m.n_cols, dtype=np.int32), np.diff(indptr))
    return coo_to_csr(COO(_as_np(m.indices), col, _as_np(m.data), m.shape))


def merge_duplicates(m: CSR) -> CSR:
    """Sum duplicate (row, col) entries."""
    return coo_to_csr(csr_to_coo(m), sort=True, sum_duplicates=True)


def crop(m: CSR, n_rows: int, n_cols: int) -> CSR:
    """Take the leading (n_rows, n_cols) submatrix."""
    indptr = _as_np(m.indptr)[: n_rows + 1]
    indices = _as_np(m.indices)[: indptr[-1]]
    data = _as_np(m.data)[: indptr[-1]]
    keep = indices < n_cols
    if not keep.all():
        # cumsum at row boundaries handles trailing empty rows
        cum = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
        kept_counts = cum[indptr[1:]] - cum[indptr[:-1]]
        new_indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(kept_counts, out=new_indptr[1:])
        indices, data, indptr = indices[keep], data[keep], new_indptr
    return CSR(_t(indptr), _t(indices), _t(data), (n_rows, n_cols))


def csr_to_dense(m: CSR) -> np.ndarray:
    out = np.zeros(m.shape, dtype=_as_np(m.data).dtype)
    coo = csr_to_coo(m)
    np.add.at(out, (_as_np(coo.row), _as_np(coo.col)), _as_np(coo.val))
    return out


def dense_to_csr(a) -> CSR:
    a = _as_np(a)
    row, col = np.nonzero(a)
    return coo_to_csr(COO(row.astype(np.int32), col.astype(np.int32),
                          a[row, col], a.shape), sort=True)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ell_arrays(m: CSR, *, width: Optional[int] = None, pad_to: int = 1):
    """(cols, vals) numpy grids of csr_to_ell, for host packers."""
    indptr = _as_np(m.indptr).astype(np.int64)
    deg = np.diff(indptr)
    w = int(deg.max()) if deg.size and width is None else int(width or 0)
    w = max(_round_up(max(w, 1), pad_to), pad_to)
    n = m.n_rows
    data = _as_np(m.data)
    cols = np.zeros((n, w), dtype=np.int32)
    vals = np.zeros((n, w), dtype=data.dtype)
    if m.nnz:
        # scatter each nnz to (its row, its within-row slot)
        rows = np.repeat(np.arange(n), deg)
        slot = np.arange(indptr[-1]) - np.repeat(indptr[:-1], deg)
        keep = slot < w  # truncate rows wider than w (explicit width only)
        cols[rows[keep], slot[keep]] = _as_np(m.indices)[keep]
        vals[rows[keep], slot[keep]] = data[keep]
    return cols, vals


def csr_to_ell(m: CSR, *, width: Optional[int] = None,
               pad_to: int = 1) -> ELL:
    """Pack CSR rows into a fixed-width padded grid; padding slots get
    (col=0, val=0) so `vals * x[cols]` contributes zero."""
    cols, vals = ell_arrays(m, width=width, pad_to=pad_to)
    return ELL(_t(cols), _t(vals), m.shape)


def csr_to_sell(m: CSR, *, slice_height: int | None = None, pad_to: int = 8,
                max_waste: float = 1.0) -> SELL:
    """Degree-sorted sliced-ELL with geometric (waste-bounded) binning.

    Rows are permuted by descending degree; a new slice starts whenever the
    next row's degree drops below `1/(1+max_waste)` of the slice's width,
    so each slice's padding waste stays below `max_waste`. Passing
    `slice_height` instead gives the classic fixed-height SELL-C-sigma cut.
    """
    deg = np.diff(_as_np(m.indptr))
    perm = np.argsort(-deg, kind="stable").astype(np.int32)
    n = m.n_rows
    indptr = _as_np(m.indptr).astype(np.int64)
    indices = _as_np(m.indices)
    data = _as_np(m.data)

    bounds = [0]
    if slice_height is not None:
        bounds.extend(range(slice_height, n, slice_height))
    elif n:
        sdeg = deg[perm].astype(np.float64)
        thresh = 1.0 / (1.0 + max_waste)
        s0 = 0
        while s0 < n:
            w_here = max(float(sdeg[s0]), float(pad_to))
            if pad_to >= w_here * thresh:
                # every remaining row pads to >= pad_to anyway: one slice
                nxt = n
            else:
                # first position whose padded degree < thresh * slice width
                nxt = int(np.searchsorted(-sdeg, -w_here * thresh,
                                          side="left"))
                nxt = min(max(nxt, s0 + 1), n)
            if nxt < n:
                bounds.append(nxt)
            s0 = nxt
    bounds.append(n)

    slices = []
    slice_rows = []
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        rows = perm[s0:s1]
        w = int(deg[rows].max()) if rows.size else 1
        w = max(_round_up(max(w, 1), pad_to), pad_to)
        cols = np.zeros((rows.size, w), dtype=np.int32)
        vals = np.zeros((rows.size, w), dtype=data.dtype)
        if rows.size:
            rdeg = deg[rows].astype(np.int64)
            rr = np.repeat(np.arange(rows.size), rdeg)
            slot = np.arange(rdeg.sum()) - np.repeat(
                np.cumsum(rdeg) - rdeg, rdeg)
            src = _row_entry_indices(indptr, rows)
            cols[rr, slot] = indices[src]
            vals[rr, slot] = data[src]
        slices.append(ELL(_t(cols), _t(vals), (rows.size, m.n_cols)))
        slice_rows.append(int(rows.size))
    if not slices:
        slices = [ELL(_t(np.zeros((0, 1), np.int32)),
                      _t(np.zeros((0, 1), data.dtype)), (0, m.n_cols))]
        slice_rows = [0]
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n, dtype=np.int32)
    return SELL(tuple(slices), _t(perm), _t(iperm), tuple(slice_rows),
                m.shape)


def _row_entry_indices(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Flat nnz indices of `rows`' entries, vectorized."""
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    out = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                    counts)
    return out + np.arange(counts.sum())


def csr_to_dia(m: CSR, *, max_diags: Optional[int] = None) -> DIA:
    """Row-aligned diagonal storage. Raises ValueError when the matrix has
    more distinct diagonals than `max_diags`."""
    coo = csr_to_coo(m)
    row = _as_np(coo.row).astype(np.int64)
    col = _as_np(coo.col).astype(np.int64)
    val = _as_np(coo.val)
    offs = np.unique(col - row)
    if max_diags is not None and offs.size > max_diags:
        raise ValueError(f"{offs.size} diagonals exceeds max_diags "
                         f"{max_diags}")
    vals = np.zeros((offs.size, m.n_rows), val.dtype)
    idx = np.searchsorted(offs, col - row)
    # np.add.at accumulates duplicate (row, col) entries
    np.add.at(vals, (idx, row), val)
    return DIA(_t(vals), tuple(int(o) for o in offs), m.shape)
