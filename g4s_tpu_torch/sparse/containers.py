"""Sparse matrix containers holding torch tensors.

Counterpart of g4s_tpu/sparse/containers.py. The reference registers its
containers as JAX pytrees; here they are frozen dataclasses whose tensor
fields may live on any device (`.to(device)` moves them) and whose shape
and width metadata are plain Python values.

Layouts:
  COO  — triple list, the construction/interchange format.
  CSR  — row-compressed, the mxv workhorse.
  CSC  — column-compressed mirror.
  ELL  — fixed-width padded rows; padding slots hold (col=0, val=0).
  SELL — degree-sorted slices of ELL, each padded to its own width.
  DIA  — row-aligned diagonals: vals[i, r] = A[r, r + offsets[i]].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def as_tensor(a, dtype=None) -> torch.Tensor:
    """numpy/array-like -> CPU tensor, sharing memory with a writable
    contiguous array and copying any other."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a, dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def as_numpy(a) -> np.ndarray:
    """tensor/array-like -> host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def resolve_device(device) -> torch.device:
    """The torch.device of an entry point's `device` argument. Entry points
    default to "cuda"; asking for CUDA where there is no card raises here
    rather than letting the work drift to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for, but torch sees no CUDA card; pass "
            "device='cpu' to run on the CPU")
    return device


def _to(obj, device):
    """Copy of a container dataclass with every tensor field on `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, tuple) and v and hasattr(v[0], "to"):
            v = tuple(s.to(device) for s in v)
        kw[f.name] = v
    return type(obj)(**kw)


def _coo_scipy(row, col, val, shape):
    import scipy.sparse as sp
    return sp.coo_matrix((as_numpy(val), (as_numpy(row), as_numpy(col))),
                         shape=shape)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix (row, col, val triples)."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def dtype(self):
        return self.val.dtype

    def to(self, device) -> "COO":
        return _to(self, device)

    def to_scipy(self):
        return _coo_scipy(self.row, self.col, self.val, self.shape)

    @staticmethod
    def from_scipy(m) -> "COO":
        m = m.tocoo()
        return COO(as_tensor(m.row), as_tensor(m.col), as_tensor(m.data),
                   tuple(m.shape))


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix."""

    indptr: torch.Tensor   # (n_rows + 1,)
    indices: torch.Tensor  # (nnz,) column ids
    data: torch.Tensor     # (nnz,)
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def row_degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device) -> "CSR":
        return _to(self, device)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((as_numpy(self.data), as_numpy(self.indices),
                              as_numpy(self.indptr)), shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        return CSR(as_tensor(m.indptr), as_tensor(m.indices),
                   as_tensor(m.data), tuple(m.shape))


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix."""

    indptr: torch.Tensor   # (n_cols + 1,)
    indices: torch.Tensor  # (nnz,) row ids
    data: torch.Tensor     # (nnz,)
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device) -> "CSC":
        return _to(self, device)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csc_matrix((as_numpy(self.data), as_numpy(self.indices),
                              as_numpy(self.indptr)), shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSC":
        m = m.tocsc()
        return CSC(as_tensor(m.indptr), as_tensor(m.indices),
                   as_tensor(m.data), tuple(m.shape))


def _ell_scipy(cols, vals, shape):
    """scipy CSR of an (rows, width) padded grid; padding slots carry value 0
    and are dropped together with any stored zero."""
    c, v = as_numpy(cols), as_numpy(vals)
    r = np.repeat(np.arange(c.shape[0]), c.shape[1])
    m = _coo_scipy(r, c.reshape(-1), v.reshape(-1), shape).tocsr()
    m.eliminate_zeros()
    return m


@dataclasses.dataclass(frozen=True)
class ELL:
    """Fixed-width padded-row layout.

    cols[i, k] is the column of the k-th stored entry of row i; vals[i, k]
    its value. Short rows are padded with (col=0, val=0): padded products
    contribute exactly zero, so kernels need no masks.
    """

    cols: torch.Tensor  # (n_rows, width) int32
    vals: torch.Tensor  # (n_rows, width)
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype

    def to(self, device) -> "ELL":
        return _to(self, device)

    def to_scipy(self):
        """CSR of the stored entries (explicit zeros are dropped)."""
        return _ell_scipy(self.cols, self.vals, self.shape)

    @staticmethod
    def from_scipy(m, **kw) -> "ELL":
        from g4s_tpu_torch.sparse.convert import csr_to_ell
        return csr_to_ell(CSR.from_scipy(m), **kw)


@dataclasses.dataclass(frozen=True)
class SELL:
    """Sliced-ELL: rows permuted into degree-sorted slices, each slice padded
    to its own width. `perm` maps slice-local row order back to original
    rows; `iperm` (argsort of perm) restores the original order with a
    gather, `y = packed[iperm]`."""

    slices: Tuple[ELL, ...]
    perm: torch.Tensor     # (n_rows,) original row index per packed row
    iperm: torch.Tensor    # (n_rows,) packed position of each row
    slice_rows: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def to(self, device) -> "SELL":
        return _to(self, device)

    def to_scipy(self):
        """CSR of the stored entries (explicit zeros are dropped)."""
        import scipy.sparse as sp
        packed = sp.vstack([_ell_scipy(s.cols, s.vals, s.shape)
                            for s in self.slices]).tocsr()
        return packed[as_numpy(self.iperm)].tocsr()

    @staticmethod
    def from_scipy(m, **kw) -> "SELL":
        from g4s_tpu_torch.sparse.convert import csr_to_sell
        return csr_to_sell(CSR.from_scipy(m), **kw)


@dataclasses.dataclass(frozen=True)
class DIA:
    """Row-aligned diagonal storage: vals[i, r] = A[r, r + offsets[i]].
    SpMV is a sum of shifted elementwise multiplies, with no gather."""

    vals: torch.Tensor          # (ndiag, n_rows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    def to(self, device) -> "DIA":
        return _to(self, device)

    def to_scipy(self):
        """CSR of the stored entries (explicit zeros are dropped)."""
        v = as_numpy(self.vals)
        n = self.shape[0]
        r = np.tile(np.arange(n), len(self.offsets))
        c = r + np.repeat(np.asarray(self.offsets, np.int64), n)
        ok = (c >= 0) & (c < self.shape[1])
        m = _coo_scipy(r[ok], c[ok], v.reshape(-1)[ok], self.shape).tocsr()
        m.eliminate_zeros()
        return m

    @staticmethod
    def from_scipy(m, **kw) -> "DIA":
        from g4s_tpu_torch.sparse.convert import csr_to_dia
        return csr_to_dia(CSR.from_scipy(m), **kw)
