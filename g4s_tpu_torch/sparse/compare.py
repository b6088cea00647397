"""Error-tolerant sparse comparisons (counterpart of
g4s_tpu/sparse/compare.py): values are equal when exactly equal, OR
|a-b| < eps, OR |a-b| / max(|a|,|b|) < eps."""

from __future__ import annotations

import numpy as np

from g4s_tpu_torch.sparse.containers import CSR, as_numpy
from g4s_tpu_torch.sparse.convert import merge_duplicates

EPSILON = 1e-8


def error_tolerant_equal(a, b, eps: float = EPSILON):
    """Elementwise ErrorTolerantEqual over arrays or tensors."""
    a = as_numpy(a).astype(np.float64)
    b = as_numpy(b).astype(np.float64)
    diff = np.abs(a - b)
    denom = np.maximum(np.abs(a), np.abs(b))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(denom > 0, diff / denom, 0.0)
    return (a == b) | (diff < eps) | (rel < eps)


def csr_allclose(a: CSR, b: CSR, eps: float = EPSILON,
                 *, canonicalize: bool = True) -> bool:
    """Structural + epsilon-value equality of two CSR matrices. With
    canonicalize=True duplicates are merged and rows sorted first."""
    if a.shape != b.shape:
        return False
    if canonicalize:
        a, b = merge_duplicates(a), merge_duplicates(b)
    if not np.array_equal(as_numpy(a.indptr), as_numpy(b.indptr)):
        return False
    if not np.array_equal(as_numpy(a.indices), as_numpy(b.indices)):
        return False
    return bool(np.all(error_tolerant_equal(a.data, b.data, eps)))
