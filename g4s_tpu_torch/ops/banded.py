"""Banded linear algebra for stiff implicit integrators (counterpart of
g4s_tpu/ops/banded.py).

Cantera's CVODES/IDA use LAPACK's banded factorization for method-of-lines
problems (``CVBand``; `cantera/src/numerics/BandMatrix.cpp` wraps
dgbtrf/dgbtrs): a 1-D grid couples only nearest neighbours, so the Jacobian
build and the Newton solve drop from O(n^2)/O(n^3) to O(n*w)/O(n*w^2).
`ops/odeint.bdf_solve(bandwidth=...)` runs on these:

- ``banded_jac``: the banded Jacobian by Curtis-Powell-Reid striding —
  w = ml+mu+1 jvps with comb seed vectors (columns j = c mod w share a
  seed; their row supports within the band are disjoint), batched by
  torch.func.vmap so the RHS is traced once for all seeds.
- ``band_factor`` / ``band_solve``: LU of a row-banded matrix WITHOUT
  partial pivoting, the reference's elimination order. Newton matrices
  M = I - c*J are the intended inputs: the unit diagonal keeps elimination
  well scaled for moderate c*J, and the BDF driver's own safeguards
  (convergence test, Jacobian refresh, step shrink) catch the rare
  breakdowns. scipy.linalg's pivoted `solve_banded` is the oracle in tests.

The elimination is sequential in the pivot, as the reference's lax.scan
is: plain torch on the tensors' device, two torch calls per pivot in the
factor and three per row in a solve, every operand a strided view of the
band (chip_smoke.py's phase 20 counts a factor's and a solve's device
kernels with the profiler). No Pallas kernel lies behind this
module in the reference, so no hand kernel does here.

Row-band layout: ``R[i, q] = M[i, i - ml + q]`` for q in [0, ml+mu],
zero where the column index falls outside [0, n).
"""

from __future__ import annotations

import torch

def dense_to_band(M: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """Row-band layout of a dense (n, n) matrix."""
    n = M.shape[0]
    R = M.new_zeros((n, ml + mu + 1))
    for q in range(ml + mu + 1):
        d = q - ml                          # diagonal offset
        diag = torch.diagonal(M, offset=d)
        i0 = max(-d, 0)
        R[i0:i0 + diag.shape[0], q] = diag
    return R


def band_to_dense(R: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    n = R.shape[0]
    M = R.new_zeros((n, n))
    for q in range(ml + mu + 1):
        d = q - ml
        i = torch.arange(max(-d, 0), min(n, n - d), device=R.device)
        M[i, i + d] = R[i, q]
    return M


def banded_jac(f, t, y: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """Banded Jacobian of f(t, y) in row-band layout, from w comb seeds.

    Columns with the same residue mod w = ml+mu+1 cannot touch the same row
    inside the band, so one jvp per residue class recovers every band
    entry exactly (Curtis-Powell-Reid, the colouring CVODES's
    difference-quotient banded Jacobian uses)."""
    n = y.shape[0]
    w = ml + mu + 1
    idx = torch.arange(n, device=y.device)
    cls = torch.arange(w, device=y.device)
    seeds = (idx[None, :] % w == cls[:, None]).to(y.dtype)     # (w, n)

    def col_class(seed):
        return torch.func.jvp(lambda yy: f(t, yy), (y,), (seed,))[1]

    cols = torch.func.vmap(col_class)(seeds)        # (w, n): rows = class
    # R[i, q] = dF_i/dy_j at j = i - ml + q = cols[j % w, i]
    j = idx[:, None] - ml + cls[None, :]            # (n, w) column index
    valid = (j >= 0) & (j < n)
    R = cols[j % w, idx[:, None].expand(n, w)]
    return torch.where(valid, R, torch.zeros((), dtype=R.dtype,
                                             device=R.device))


def band_factor(R: torch.Tensor, *, ml: int, mu: int):
    """No-pivot LU of a row-banded matrix: returns (U_band, L_factors).

    U_band keeps the layout of R (subdiagonal slots become junk);
    L_factors is (n, ml) with L_factors[k, r-1] = multiplier of row k+r
    against pivot row k. Pivot k's multipliers are the anti-diagonal of
    the ml rows below it and its shifted row is a strided view of the
    pivot row, padded with ml identity rows below and ml zero columns on
    the right, so each pivot costs one division and one fused update."""
    n, w = R.shape
    if w != ml + mu + 1:
        raise ValueError(f"band width {w} != ml+mu+1 = {ml + mu + 1}")
    if ml == 0:                              # upper triangular already
        return R, R.new_zeros((n, 0))
    ws = w + ml                              # row stride of the padded band
    Rp = R.new_zeros((n + ml, ws))
    Rp[:n, :w] = R
    Rp[n:, ml] = 1.0                         # identity rows: zero multipliers
    L = R.new_zeros((n, ml))
    base = Rp.storage_offset()
    for k in range(n):
        # l[r-1] = Rp[k+r, ml-r] / Rp[k, ml]
        anti = Rp.as_strided((ml,), (ws - 1,), base + (k + 1) * ws + ml - 1)
        torch.div(anti, Rp[k, ml], out=L[k])
        # rows k+1..k+ml: RB -= l[:, None] * S, S[r-1, q] = pivot row[q+r]
        shifted = Rp.as_strided((ml, w), (1, 1), base + k * ws + 1)
        Rp[k + 1:k + 1 + ml, :w].addcmul_(L[k][:, None], shifted, value=-1)
    return Rp[:n, :w].clone(), L


def band_solve(fac, b: torch.Tensor, *, ml: int, mu: int) -> torch.Tensor:
    """Solve M x = b given ``fac = band_factor(R)``; b is (n,) or (n, k)."""
    U, L = fac
    n, w = U.shape
    vec = b.dim() == 1
    bp = b.new_zeros((n + ml, 1 if vec else b.shape[1]))
    bp[:n] = b[:, None] if vec else b
    for k in range(n if ml > 0 else 0):      # forward elimination
        bp[k + 1:k + 1 + ml].addcmul_(L[k][:, None], bp[k][None, :],
                                      value=-1)
    # back substitution: x[k] = (b[k] - U[k, ml+1:] . x[k+1:k+mu+1]) / U[k, ml]
    xp = bp.new_zeros((n + mu, bp.shape[1]))
    t = bp.new_empty((1, bp.shape[1]))
    for k in range(n - 1, -1, -1):
        torch.addmm(bp[k:k + 1], U[k:k + 1, ml + 1:], xp[k + 1:k + 1 + mu],
                    alpha=-1, out=t)
        torch.div(t, U[k, ml], out=xp[k:k + 1])
    x = xp[:n]
    return x[:, 0] if vec else x


def newton_band_factor(J_band: torch.Tensor, c, *, ml: int, mu: int):
    """Factor M = I - c*J from J in row-band layout."""
    R = -float(c) * J_band
    R[:, ml] += 1.0
    return band_factor(R, ml=ml, mu=mu)
