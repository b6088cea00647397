"""Dense BLAS2 products (counterpart of g4s_tpu/ops/blas2.py): the
reference's mv/ suite wraps MKL's dgemv, dsymv, dtrmv and dspmv. Each is
one matrix-vector product; the variants differ only in how the operand
matrix is materialized (full, symmetric from one triangle, triangular,
packed). The reference leaves the product to XLA outside any Pallas
kernel, so here it is `torch.matmul`.
"""

from __future__ import annotations

import numpy as np
import torch


def gemv(a: torch.Tensor, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """y = A @ x in `dtype` (default: the promoted input type), the dgemv
    role."""
    dt = dtype or torch.promote_types(a.dtype, x.dtype)
    return torch.matmul(a.to(dt), x.to(dt))


def symv(a: torch.Tensor, x: torch.Tensor, *, uplo: str = "U"):
    """y = sym(A) @ x using only the `uplo` triangle of A (dsymv)."""
    if uplo == "U":
        full = torch.triu(a) + torch.triu(a, 1).T
    else:
        full = torch.tril(a) + torch.tril(a, -1).T
    return gemv(full, x)


def trmv(a: torch.Tensor, x: torch.Tensor, *, uplo: str = "U",
         unit_diag: bool = False):
    """y = tri(A) @ x (dtrmv)."""
    tri = torch.triu(a) if uplo == "U" else torch.tril(a)
    if unit_diag:
        tri = tri.clone()
        tri.diagonal().fill_(1)
    return gemv(tri, x)


def _packed_index(n: int, uplo: str, device) -> torch.Tensor:
    """(n, n) position of A[i, j] in LAPACK packed storage: the `uplo`
    triangle stored column by column, mirrored to the other triangle.
    Computed on `device`: a host-built index would be copied over on every
    call, and that copy waits for the device."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    if uplo == "U":            # column hi holds rows 0..hi
        return hi * (hi + 1) // 2 + lo
    # column lo holds rows lo..n-1
    return lo * n - lo * (lo - 1) // 2 + (hi - lo)


def pack_symmetric(a, *, uplo: str = "U") -> np.ndarray:
    """Host-side: pack the `uplo` triangle of a matrix column by column,
    the LAPACK 'packed' storage that dspmv consumes."""
    a = np.asarray(a)
    # (j, i) pairs in row-major order are (column, row) in packed order
    j, i = (np.tril_indices if uplo == "U" else np.triu_indices)(a.shape[0])
    return a[i, j]


def unpack_symmetric(ap: torch.Tensor, n: int, *, uplo: str = "U"):
    """Full symmetric matrix from packed storage, one gather on ap's
    device."""
    return ap[_packed_index(n, uplo, ap.device)]


def spmv_packed(ap: torch.Tensor, x: torch.Tensor, *, uplo: str = "U"):
    """y = sym(A) @ x from packed storage (dspmv)."""
    return gemv(unpack_symmetric(ap, x.shape[0], uplo=uplo), x)
