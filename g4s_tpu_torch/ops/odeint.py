"""Stiff ODE integration: variable-order BDF (counterpart of
g4s_tpu/ops/odeint.py's `bdf_solve`).

The replacement for Cantera's SUNDIALS CVODES backend
(cantera/src/numerics/CVodesIntegrator.cpp: BDF with Newton iteration and
dense Jacobians). The algorithm is the reference's, step for step: the
classic variable-order (1-5) quasi-constant-step BDF in backward-difference
form (Shampine & Reichelt, "The MATLAB ODE Suite" / ode15s family):

  - backward differences D[0..k+2] carry the history; prediction is the
    sum of differences; step-size changes rescale D with the R matrix;
  - modified Newton on (I - h/alpha J); the Jacobian (torch.func.jacfwd of
    f — exact, not CVODES's finite differences) is FROZEN across steps and
    only refreshed on Newton failure; the LU refactorizes when c = h/alpha
    changes (the standard CVODES reuse policy);
  - local error control with RMS norms over atol + rtol*|y|; order
    selection from error estimates at orders k-1, k, k+1 after k+1 equal
    steps.

The reference runs the whole integration as one lax.while_loop. Here the
loop runs on the host over device tensors: the state vector, D, the
Jacobian and its LU stay on y0's device, while t, h, the order and the
counters are host scalars in y0's precision, computed with the reference's
arithmetic in its order. The host reads the device once per Newton
iteration (the update's norm), once per step (the error norm), once per
order adaptation (the two neighbouring orders' norms), and once at the
start (the first step's norms); BDFResult.host_reads counts them. The LU
is torch.linalg.lu_factor_ex / lu_solve (cuSOLVER/cuBLAS on the card; the
reference's is XLA's): no hand kernel lies on this path.

Not ported yet (ROADMAP.md, queue 1, "The Cantera integrator tail"):
the banded Newton path (`bandwidth=`, the reference's ops/banded.py),
`bdf_solve_with_sensitivities` and `dae_solve`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

MAX_ORDER = 5
NEWTON_MAXITER = 4
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0

_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_GAMMA = np.hstack([0.0, np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = (1.0 - _KAPPA) * _GAMMA
_ERROR_CONST = _KAPPA * _GAMMA + 1.0 / np.arange(1, MAX_ORDER + 2)

_NP_FLOAT = {torch.float64: np.float64, torch.float32: np.float32}


def _rescale_matrix(order: int, factor, dtype) -> np.ndarray:
    """(R(factor) R(1))^T for the first `order` + 1 differences, identity
    past them: the reference's _rescale_D matrix, built on the host."""
    m = MAX_ORDER + 1
    I = np.arange(1, m, dtype=dtype)[:, None]
    J = np.arange(1, m, dtype=dtype)[None, :]
    idx = np.arange(m)
    keep = (idx[:, None] <= order) & (idx[None, :] <= order)
    eye = np.eye(m, dtype=dtype)

    def mat(fac):
        M = np.zeros((m, m), dtype)
        M[1:, 1:] = (I - 1 - fac * J) / I
        M[0] = 1.0
        return np.where(keep, np.cumprod(M, axis=0), eye)

    return (mat(dtype(factor)) @ mat(dtype(1.0))).T


def _rescale_D(D: torch.Tensor, order: int, factor) -> torch.Tensor:
    """D[:order+1] <- (R(factor) R(1))^T D[:order+1], in place. On CUDA
    the matrix goes up from pinned memory without waiting on the device (a
    copy from pageable memory would)."""
    m = MAX_ORDER + 1
    RT = torch.from_numpy(_rescale_matrix(order, factor, _NP_FLOAT[D.dtype]))
    if D.is_cuda:
        RT = RT.pin_memory().to(D.device, non_blocking=True)
    D[:m] = RT @ D[:m]
    return D


class BDFResult(NamedTuple):
    y: torch.Tensor
    t: float
    steps: int
    n_fev: int
    n_jev: int
    success: bool
    record: Optional[torch.Tensor] = None    # (record_size, m) per step
    record_t: Optional[torch.Tensor] = None  # (record_size,) times
    host_reads: int = 0                       # device-to-host reads


def bdf_solve(f: Callable, y0, t0, t1, *, rtol=1e-6, atol=1e-9,
              first_step=None, max_steps=100000, jac=None,
              record_fn: Callable | None = None,
              record_size: int = 0,
              bandwidth: tuple | None = None) -> BDFResult:
    """Integrate dy/dt = f(t, y) from t0 to t1; returns the state at t1.

    f(t, y) gets t as a host scalar and y as a tensor on y0's device, in
    y0's dtype. `jac(t, y)` defaults to torch.func.jacfwd of f over y.

    With record_fn, every accepted internal step writes
    (t, record_fn(y)) to the next slot of a fixed-size buffer (a full
    buffer keeps overwriting its last slot; slot 0 holds (t0,
    record_fn(y0)) and unwritten slots keep t0) — the analog of driving
    CVODES in one-step mode (`ReactorNet.step`, zeroD/ReactorNet.cpp:210)
    and capturing a SolutionArray row per step.
    """
    if bandwidth is not None:
        raise NotImplementedError(
            "bdf_solve(bandwidth=...): the banded Newton path (the "
            "reference's ops/banded.py) is not ported yet; ROADMAP.md, "
            "queue 1, \"The Cantera integrator tail\"")
    y0 = torch.as_tensor(y0)
    n = y0.shape[0]
    dtype, dev = y0.dtype, y0.device
    S = _NP_FLOAT[dtype]
    t0, t1 = S(t0), S(t1)
    if jac is None:
        jac = torch.func.jacfwd(f, argnums=1)
    gamma = torch.as_tensor(_GAMMA, dtype=dtype, device=dev)
    alpha = _ALPHA.astype(S)
    error_const = _ERROR_CONST.astype(S)
    eye = torch.eye(n, dtype=dtype, device=dev)
    reads = 0

    def read(x) -> np.ndarray:
        nonlocal reads
        reads += 1
        return x.cpu().numpy().astype(S)

    def rms(v):
        return torch.sqrt(torch.mean(v * v))

    def factor(J, c):
        LU, piv, _ = torch.linalg.lu_factor_ex(eye - float(c) * J)
        return LU, piv

    def lsolve(lu, rhs):
        return torch.linalg.lu_solve(lu[0], lu[1], rhs[:, None])[:, 0]

    f0 = f(float(t0), y0)
    if first_step is None:
        scale0 = atol + rtol * torch.abs(y0)
        d0, d1 = read(torch.stack([rms(y0 / scale0), rms(f0 / scale0)]))
        h0 = S(1e-6) if (d0 < 1e-5) | (d1 < 1e-5) else S(0.01) * d0 / d1
        h0 = np.minimum(h0, np.abs(t1 - t0))
    else:
        h0 = S(first_step)

    D = torch.zeros((MAX_ORDER + 3, n), dtype=dtype, device=dev)
    D[0] = y0
    D[1] = f0 * float(h0)

    if record_fn is not None:
        def rec_fn(y):
            return torch.atleast_1d(torch.as_tensor(record_fn(y),
                                                    dtype=dtype))
        rec_size = max(record_size, 1)
        r0 = rec_fn(y0)
        buf = torch.zeros((rec_size, r0.shape[0]), dtype=dtype, device=dev)
        buf[0] = r0
        buf_t = np.full((rec_size,), t0, S)
        rec = 1

    J = jac(float(t0), y0)
    c_lu = h0 / alpha[1]
    lu = factor(J, c_lu)

    def newton(t_new, y_pred, c, psi, scale, lu):
        d = torch.zeros_like(y_pred)
        y = y_pred
        dwn_old = S(0.0)
        it, nf = 0, 0
        conv = div = False
        while it < NEWTON_MAXITER and not conv and not div:
            rhs = float(c) * f(float(t_new), y) - psi - d
            dw = lsolve(lu, rhs)
            dwn = read(rms(dw / scale))[()]
            rate = dwn / np.maximum(dwn_old, S(1e-300))
            safe_rate = np.minimum(rate, S(0.999))
            diverged = it > 0 and rate >= 1.0
            d = d + dw
            y = y_pred + d
            conv_now = (safe_rate / (1.0 - safe_rate) * dwn < 1e-3
                        if it > 0 else dwn < 1e-12)
            dwn_old = dwn
            it += 1
            nf += 1
            conv = conv or bool(conv_now)
            div = div or bool(diverged)
        return d, conv and not div, nf

    t, h, order, n_eq = t0, h0, 1, 0
    steps, n_fev, n_jev, fail = 0, 1, 1, False
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        while t < t1 and not fail:
            # clip final step
            hs = np.minimum(h, t1 - t)
            if hs < h:
                _rescale_D(D, order, hs / h)
            c = hs / alpha[order]
            if c != c_lu:
                lu = factor(J, c)
            t_new = t + hs

            y_pred = D[:order + 1].sum(dim=0)
            scale = atol + rtol * torch.abs(y_pred)
            psi = (D[1:order + 1] * gamma[1:order + 1, None]).sum(dim=0) \
                / float(alpha[order])

            d, conv, nf1 = newton(t_new, y_pred, c, psi, scale, lu)
            nf2 = jev = 0
            if not conv:
                # refresh the Jacobian at the prediction and retry once
                J = jac(float(t_new), y_pred)
                lu = factor(J, c)
                d, conv, nf2 = newton(t_new, y_pred, c, psi, scale, lu)
                jev = 1

            err_norm = read(rms(float(error_const[order]) * d / scale))[()]
            accept = conv and err_norm <= 1.0
            if accept:
                D[order + 2] = d - D[order + 1]
                D[order + 1] = d
                for k in range(order, -1, -1):
                    D[k] += D[k + 1]
                n_eq += 1
                fac = S(1.0)
                if n_eq >= order + 1:
                    norms = read(torch.stack([rms(D[order] / scale),
                                              rms(D[order + 2] / scale)]))
                    em = (error_const[order - 1] * norms[0] if order > 1
                          else S(np.inf))
                    ep = (error_const[min(order + 1, MAX_ORDER + 1)]
                          * norms[1] if order < MAX_ORDER else S(np.inf))
                    errs = np.array([em, np.maximum(err_norm, S(1e-300)),
                                     ep], S)
                    powers = S(1.0) / (order + np.arange(3, dtype=S))
                    factors = np.power(np.maximum(errs, S(1e-300)), -powers)
                    best = int(np.argmax(factors))
                    new_order = int(np.clip(order + best - 1, 1, MAX_ORDER))
                    fac = np.clip(S(0.9) * factors[best], S(MIN_FACTOR),
                                  S(MAX_FACTOR))
                    _rescale_D(D, new_order, fac)
                    order, n_eq = new_order, 0
                t, h = t_new, hs * fac
                if record_fn is not None:
                    slot = min(rec, rec_size - 1)
                    buf[slot] = rec_fn(y_pred + d)
                    buf_t[slot] = t_new
                    rec += 1
            else:
                factor_rej = (np.clip(S(0.9) * err_norm
                                      ** (S(-1.0) / S(order + 1)),
                                      S(MIN_FACTOR), S(0.9))
                              if conv else S(0.5))
                _rescale_D(D, order, factor_rej)
                h = hs * factor_rej
                n_eq = 0
            c_lu = c
            fail = bool(h <= np.abs(t1 - t0) * S(1e-14)) \
                or steps + 1 >= max_steps
            steps += 1
            n_fev += nf1 + nf2 + 1
            n_jev += jev

    return BDFResult(
        D[0].clone(), float(t), steps, n_fev, n_jev,
        (not fail) or bool(t >= t1),
        buf if record_fn is not None else None,
        torch.as_tensor(buf_t, device=dev) if record_fn is not None
        else None,
        reads)
