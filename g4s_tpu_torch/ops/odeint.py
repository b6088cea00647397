"""Stiff ODE and DAE integration: variable-order BDF (counterpart of
g4s_tpu/ops/odeint.py: `bdf_solve`, `bdf_solve_with_sensitivities` and
`dae_solve`).

The replacement for Cantera's SUNDIALS CVODES and IDA backends
(cantera/src/numerics/CVodesIntegrator.cpp, IDA_Solver.cpp: BDF with Newton
iteration and dense or banded Jacobians). The algorithm is the reference's,
step for step: the classic variable-order (1-5) quasi-constant-step BDF in
backward-difference form (Shampine & Reichelt, "The MATLAB ODE Suite" /
ode15s family):

  - backward differences D[0..k+2] carry the history; prediction is the
    sum of differences; step-size changes rescale D with the R matrix;
  - modified Newton on (I - h/alpha J); the Jacobian (torch.func.jacfwd of
    f — exact, not CVODES's finite differences — or the banded
    comb-seeded one of ops/banded.py) is FROZEN across steps and only
    refreshed on Newton failure; the LU refactorizes when c = h/alpha
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
start (the first step's norms); BDFResult.host_reads counts them. The dense
LU is torch.linalg.lu_factor_ex / lu_solve (cuSOLVER/cuBLAS on the card;
the reference's is XLA's); the banded one is ops/banded.py's plain torch:
no hand kernel lies on these paths.

`_bdf_solve_batched` is the lockstep form the reference gets from
jax.vmap(bdf_solve) (its only caller is ShockTubeBenchmark.
run_ntc_sweep_batched): every lane keeps its own t, h, order, D, Jacobian
and LU in device tensors, and the host reads one flag per step and one
per Newton iteration.
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
    copy from pageable memory would). D may carry trailing tangent
    columns: (MAX_ORDER+3, n, n_p) rescales like (MAX_ORDER+3, n)."""
    m = MAX_ORDER + 1
    RT = torch.from_numpy(_rescale_matrix(order, factor, _NP_FLOAT[D.dtype]))
    if D.is_cuda:
        RT = RT.pin_memory().to(D.device, non_blocking=True)
    D[:m] = (RT @ D[:m].reshape(m, -1)).reshape(D[:m].shape)
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


class _ODENewton:
    """The ODE corrector's linear algebra: M = I - c J, J frozen across
    steps, dense (lu_factor_ex) or banded (ops/banded.py)."""

    def __init__(self, f, jac, J, c, *, dense: bool, ml=0, mu=0):
        self.f, self.jac, self.J = f, jac, J
        if dense:
            eye = torch.eye(J.shape[0], dtype=J.dtype, device=J.device)

            def factor(J, c):
                LU, piv, _ = torch.linalg.lu_factor_ex(eye - float(c) * J)
                return LU, piv

            def lsolve(lu, rhs):
                col = rhs.dim() == 1
                x = torch.linalg.lu_solve(lu[0], lu[1],
                                          rhs[:, None] if col else rhs)
                return x[:, 0] if col else x
        else:
            from g4s_tpu_torch.ops.banded import (band_solve,
                                                  newton_band_factor)

            def factor(J, c):
                return newton_band_factor(J, c, ml=ml, mu=mu)

            def lsolve(lu, rhs):
                return band_solve(lu, rhs, ml=ml, mu=mu)
        self.factor, self.lsolve = factor, lsolve
        self.lu = factor(J, c)

    def update(self, c, t_new, y_pred, psi):
        """c changed: refactor the frozen Jacobian's Newton matrix."""
        self.lu = self.factor(self.J, c)

    def refresh(self, c, t_new, y_pred, psi):
        """Newton failed: a fresh Jacobian at the prediction."""
        self.J = self.jac(float(t_new), y_pred)
        self.lu = self.factor(self.J, c)

    def dw(self, c, t_new, y, d, psi):
        return self.lsolve(self.lu, float(c) * self.f(float(t_new), y)
                           - psi - d)


class _DAENewton:
    """The DAE corrector's linear algebra: the iteration matrix
    dF/dy + dF/dy' / c (IDA's cj = 1/c), rebuilt at the prediction when c
    changes (cj enters it structurally) and on Newton failure."""

    def __init__(self, F, t0, y0, yp0, c):
        self.F = F
        self.jacs = torch.func.jacfwd(F, argnums=(1, 2))
        self.lu = self._build(t0, y0, yp0, c)

    def _build(self, t, y, yp, c):
        Jy, Jyp = self.jacs(float(t), y, yp)
        LU, piv, _ = torch.linalg.lu_factor_ex(Jy + Jyp / float(c))
        return LU, piv

    def update(self, c, t_new, y_pred, psi):
        self.lu = self._build(t_new, y_pred, psi / float(c), c)

    refresh = update

    def dw(self, c, t_new, y, d, psi):
        res = self.F(float(t_new), y, (psi + d) / float(c))
        return -torch.linalg.lu_solve(self.lu[0], self.lu[1],
                                      res[:, None])[:, 0]


class _Tangents:
    """Forward sensitivities advanced beside the primal (CVODES's staggered
    scheme): dD, the tangents of the differences, (MAX_ORDER+3, n, n_p),
    move with every linear operation on D, and each Newton iteration's
    tangent update solves through the primal's frozen LU with the exact
    Jacobian-vector products of f at that iterate (one vmapped jvp over the
    n_p parameter directions)."""

    def __init__(self, f_params, p, t0, y0, h0):
        self.f_params, self.p = f_params, p
        n_p = p.shape[0]
        self.basis = torch.eye(n_p, dtype=p.dtype, device=p.device)
        self.dD = p.new_zeros((MAX_ORDER + 3, y0.shape[0], n_p))
        # y0 does not depend on p: D[1] = h0 f(t0, y0; p) moves by h0 df/dp
        self.dD[1] = self.jvp(t0, y0, self.dD[0]) * float(h0)

    def jvp(self, t, y, dy):
        """(n, n_p): df/dy dy[:, j] + df/dp e_j for every direction j."""
        def one(tp, ty):
            return torch.func.jvp(
                lambda p, yy: self.f_params(p, t, yy), (self.p, y),
                (tp, ty))[1]
        return torch.func.vmap(one)(self.basis, dy.T).T


def _integrate(newton_lin, y0, D1, t0, t1, h0, S, *, rtol, atol, max_steps,
               reject_max, read, record_fn=None, record_size=0,
               tangents: _Tangents | None = None):
    """The BDF step loop shared by bdf_solve, dae_solve and the
    sensitivities. newton_lin holds the corrector's matrix (update on a new
    c, refresh on failure) and its Newton update dw; reject_max caps the
    step factor after an error-test failure (0.9 for the ODE, 1.0 for the
    DAE, as in the reference). Returns (D, t, steps, n_fev, n_jev, fail,
    record, record_t)."""
    n = y0.shape[0]
    dtype, dev = y0.dtype, y0.device
    gamma = torch.as_tensor(_GAMMA, dtype=dtype, device=dev)
    alpha = _ALPHA.astype(S)
    error_const = _ERROR_CONST.astype(S)

    def rms(v):
        return torch.sqrt(torch.mean(v * v))

    D = torch.zeros((MAX_ORDER + 3, n), dtype=dtype, device=dev)
    D[0] = y0
    D[1] = D1

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

    def newton(t_new, y_pred, c, psi, scale, dY=None, dpsi=None):
        d = torch.zeros_like(y_pred)
        y = y_pred
        dd = None if dY is None else torch.zeros_like(dY)
        dwn_old = S(0.0)
        it, nf = 0, 0
        conv = div = False
        while it < NEWTON_MAXITER and not conv and not div:
            dw = newton_lin.dw(c, t_new, y, d, psi)
            if dd is not None:
                jv = tangents.jvp(float(t_new), y, dY + dd)
                dd = dd + newton_lin.lsolve(newton_lin.lu,
                                            float(c) * jv - dpsi - dd)
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
        return d, dd, conv and not div, nf

    c_lu = h0 / alpha[1]
    t, h, order, n_eq = t0, h0, 1, 0
    steps, n_fev, n_jev, fail = 0, 1, 1, False
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        while t < t1 and not fail:
            # clip final step
            hs = np.minimum(h, t1 - t)
            if hs < h:
                _rescale_D(D, order, hs / h)
                if tangents is not None:
                    _rescale_D(tangents.dD, order, hs / h)
            c = hs / alpha[order]
            t_new = t + hs

            y_pred = D[:order + 1].sum(dim=0)
            scale = atol + rtol * torch.abs(y_pred)
            psi = (D[1:order + 1] * gamma[1:order + 1, None]).sum(dim=0) \
                / float(alpha[order])
            dY = dpsi = None
            if tangents is not None:
                dD = tangents.dD
                dY = dD[:order + 1].sum(dim=0)
                dpsi = (dD[1:order + 1] * gamma[1:order + 1, None, None]) \
                    .sum(dim=0) / float(alpha[order])
            if c != c_lu:
                newton_lin.update(c, t_new, y_pred, psi)

            d, dd, conv, nf1 = newton(t_new, y_pred, c, psi, scale, dY, dpsi)
            nf2 = jev = 0
            if not conv:
                # refresh the matrix at the prediction and retry once
                newton_lin.refresh(c, t_new, y_pred, psi)
                d, dd, conv, nf2 = newton(t_new, y_pred, c, psi, scale, dY,
                                          dpsi)
                jev = 1

            err_norm = read(rms(float(error_const[order]) * d / scale))[()]
            accept = conv and err_norm <= 1.0
            if accept:
                for X, x in ((D, d),) if tangents is None else \
                        ((D, d), (tangents.dD, dd)):
                    X[order + 2] = x - X[order + 1]
                    X[order + 1] = x
                    for k in range(order, -1, -1):
                        X[k] += X[k + 1]
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
                    if tangents is not None:
                        _rescale_D(tangents.dD, new_order, fac)
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
                                      S(MIN_FACTOR), S(reject_max))
                              if conv else S(0.5))
                _rescale_D(D, order, factor_rej)
                if tangents is not None:
                    _rescale_D(tangents.dD, order, factor_rej)
                h = hs * factor_rej
                n_eq = 0
            c_lu = c
            fail = bool(h <= np.abs(t1 - t0) * S(1e-14)) \
                or steps + 1 >= max_steps
            steps += 1
            n_fev += nf1 + nf2 + 1
            n_jev += jev
    return (D, t, steps, n_fev, n_jev, fail,
            buf if record_fn is not None else None,
            torch.as_tensor(buf_t, device=dev) if record_fn is not None
            else None)


def _first_step(y0, ydot0, t0, t1, rtol, atol, first_step, S, read):
    if first_step is not None:
        return S(first_step)

    def rms(v):
        return torch.sqrt(torch.mean(v * v))
    scale0 = atol + rtol * torch.abs(y0)
    d0, d1 = read(torch.stack([rms(y0 / scale0), rms(ydot0 / scale0)]))
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        h0 = S(1e-6) if (d0 < 1e-5) | (d1 < 1e-5) else S(0.01) * d0 / d1
    return np.minimum(h0, np.abs(t1 - t0))


def _reader(S):
    count = [0]

    def read(x) -> np.ndarray:
        count[0] += 1
        return x.cpu().numpy().astype(S)
    return read, count


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

    bandwidth=(ml, mu) switches the Newton linear algebra to the banded
    path (the CVBand role, `numerics/BandMatrix.cpp` dgbtrf/dgbtrs): the
    Jacobian is built with ml+mu+1 comb-seeded jvps instead of n forward
    columns and factored/solved in O(n*w^2)/O(n*w) (ops/banded.py). The
    RHS must have the claimed band structure — out-of-band couplings alias
    into band slots, as with CVODES's difference-quotient banded
    Jacobian. A user `jac` must return the row-band layout (n, ml+mu+1)
    in this mode.
    """
    return _bdf(f, y0, t0, t1, rtol=rtol, atol=atol, first_step=first_step,
                max_steps=max_steps, jac=jac, record_fn=record_fn,
                record_size=record_size, bandwidth=bandwidth)[0]


def _bdf(f, y0, t0, t1, *, rtol=1e-6, atol=1e-9, first_step=None,
         max_steps=100000, jac=None, record_fn=None, record_size=0,
         bandwidth=None, sens=None):
    """bdf_solve, optionally advancing the sensitivities `sens` =
    (f_params, p) beside it; returns (BDFResult, dD or None)."""
    y0 = torch.as_tensor(y0)
    dtype = y0.dtype
    S = _NP_FLOAT[dtype]
    t0, t1 = S(t0), S(t1)
    if bandwidth is None:
        if jac is None:
            jac = torch.func.jacfwd(f, argnums=1)
    else:
        from g4s_tpu_torch.ops.banded import banded_jac
        ml_, mu_ = int(bandwidth[0]), int(bandwidth[1])
        if jac is None:
            jac = lambda t, y: banded_jac(f, t, y, ml_, mu_)  # noqa: E731
    read, reads = _reader(S)

    f0 = f(float(t0), y0)
    h0 = _first_step(y0, f0, t0, t1, rtol, atol, first_step, S, read)
    tangents = None
    if sens is not None:
        tangents = _Tangents(sens[0], sens[1], float(t0), y0, h0)
    lin = _ODENewton(f, jac, jac(float(t0), y0), h0 / _ALPHA.astype(S)[1],
                     dense=bandwidth is None,
                     **({} if bandwidth is None else dict(ml=ml_, mu=mu_)))
    D, t, steps, n_fev, n_jev, fail, buf, buf_t = _integrate(
        lin, y0, f0 * float(h0), t0, t1, h0, S, rtol=rtol, atol=atol,
        max_steps=max_steps, reject_max=0.9, read=read,
        record_fn=record_fn, record_size=record_size, tangents=tangents)
    res = BDFResult(D[0].clone(), float(t), steps, n_fev, n_jev,
                    (not fail) or bool(t >= t1), buf, buf_t, reads[0])
    return res, None if tangents is None else tangents.dD


def bdf_solve_with_sensitivities(f_params, params, y0, t0, t1, *,
                                 rtol=1e-6, atol=1e-9, **kw):
    """Staggered forward sensitivity analysis (CVodeSensInit,
    cantera/src/numerics/CVodesIntegrator.cpp's sensitivity interface).

    f_params(params, t, y) -> dy/dt; params is a tensor or a pytree of
    tensors (flattened in torch.utils._pytree order). Returns
    (BDFResult, dy1/dparams) with the sensitivities (n_states, n_params).

    One primal integration advances all n_p tangents against the same
    steps, orders and factored Newton matrices, as the reference's
    jax.vmap over jax.jvp of the whole loop does: each Newton iteration
    also solves the n_p tangent systems through the primal's frozen LU,
    with the exact Jacobian-vector products of f at that iterate. The
    step sizes and times carry no tangents here: they come from host reads
    of norms. The reference's jvp also differentiates h and t through the
    error norms; that term is of the size of the local error control: on
    Robertson to t = 10 the two agree to 6.1e-7 of each column's largest
    entry at rtol 1e-8 (1.8e-5 at rtol 1e-6, 1.7e-8 at rtol 1e-10, with
    equal step counts), and tests/test_torch_odeint_tail.py holds them to
    2e-6 at rtol 1e-8.
    """
    from torch.utils import _pytree
    leaves, spec = _pytree.tree_flatten(params)
    leaves = [torch.as_tensor(x) for x in leaves]
    y0 = torch.as_tensor(y0)
    flat = torch.cat([x.reshape(-1) for x in leaves]).to(y0.device,
                                                         y0.dtype)
    sizes = [x.numel() for x in leaves]

    def unravel(v):
        parts = torch.split(v, sizes)
        return _pytree.tree_unflatten(
            [p.reshape(x.shape) for p, x in zip(parts, leaves)], spec)

    def f_flat(pf, t, y):
        return f_params(unravel(pf), t, y)

    res, dD = _bdf(lambda t, y: f_flat(flat, t, y), y0, t0, t1, rtol=rtol,
                   atol=atol, sens=(f_flat, flat), **kw)
    return res, dD[0].clone()


def dae_solve(F, y0, ydot0, t0, t1, *, rtol=1e-6, atol=1e-9,
              first_step=None, max_steps=100000) -> BDFResult:
    """Implicit DAE integration: variable-order BDF on F(t, y, y') = 0.

    The IDA_Solver role (cantera/src/numerics/IDA_Solver.cpp — SUNDIALS
    IDA is BDF applied to the implicit residual), the reference's
    dae_solve step for step on bdf_solve's loop: the corrector solves
        F(t_new, y_pred + d, (psi + d) / c) = 0
    by modified Newton with the iteration matrix M = dF/dy + (1/c) dF/dy'
    (IDA's cj = 1/c) and its LU on y0's device, frozen across steps,
    rebuilt at the prediction when c changes and once more when Newton
    fails. For F = y' - f(t, y) this is bdf_solve's corrector. `ydot0`
    must be consistent: F(t0, y0, ydot0) = 0 (as IDA requires; no
    initial-condition pass). Index-1 DAEs with nonsingular M; the local
    error test covers all components (IDA's default, suppressalg off).
    """
    y0 = torch.as_tensor(y0)
    ydot0 = torch.as_tensor(ydot0, dtype=y0.dtype, device=y0.device)
    S = _NP_FLOAT[y0.dtype]
    t0, t1 = S(t0), S(t1)
    read, reads = _reader(S)
    h0 = _first_step(y0, ydot0, t0, t1, rtol, atol, first_step, S, read)
    lin = _DAENewton(F, t0, y0, ydot0, h0 / _ALPHA.astype(S)[1])
    D, t, steps, n_fev, n_jev, fail, _, _ = _integrate(
        lin, y0, ydot0 * float(h0), t0, t1, h0, S, rtol=rtol, atol=atol,
        max_steps=max_steps, reject_max=1.0, read=read)
    return BDFResult(D[0].clone(), float(t), steps, n_fev, n_jev,
                     (not fail) or bool(t >= t1), None, None, reads[0])


def _rescale_batched(D: torch.Tensor, order: torch.Tensor,
                     factor: torch.Tensor) -> torch.Tensor:
    """_rescale_D per lane: D (B, MAX_ORDER+3, n), order (B,) and factor
    (B,) on the device; returns the rescaled D."""
    m = MAX_ORDER + 1
    dtype, dev = D.dtype, D.device
    I = torch.arange(1, m, dtype=dtype, device=dev)[:, None]
    J = torch.arange(1, m, dtype=dtype, device=dev)[None, :]
    idx = torch.arange(m, device=dev)
    o = order[:, None, None]
    keep = (idx[None, :, None] <= o) & (idx[None, None, :] <= o)
    eye = torch.eye(m, dtype=dtype, device=dev)

    def mat(fac):
        M = torch.zeros((D.shape[0], m, m), dtype=dtype, device=dev)
        M[:, 1:, 1:] = (I - 1 - fac[:, None, None] * J) / I
        M[:, 0] = 1.0
        return torch.where(keep, torch.cumprod(M, dim=1), eye)

    RT = (mat(factor) @ mat(torch.ones_like(factor))).transpose(1, 2)
    out = D.clone()
    out[:, :m] = RT @ D[:, :m]
    return out


def _bdf_solve_batched(f: Callable, y0: torch.Tensor, t0, t1, *, rtol=1e-6,
                       atol=1e-9, max_steps=100000,
                       record_fn: Callable | None = None,
                       record_size: int = 0) -> BDFResult:
    """bdf_solve over a batch of initial states y0 (B, n), in lockstep: the
    reference's jax.vmap(bdf_solve). f(t, y) is one lane's RHS and runs
    under torch.func.vmap (its Jacobian under vmap of jacfwd).

    Every lane keeps its own t, h, order, n_eq, counters, D (B, 8, n),
    Jacobian and LU (a batched lu_factor_ex) in device tensors, and takes
    the single-lane algorithm's decisions from its own numbers: the
    refactor when its c changed, the Jacobian refresh when its Newton
    failed, its order and step factor. A step computes every lane and
    keeps the result where the lane's decision says so (what vmap makes
    of the reference's lax.cond); a lane that is done stays frozen. The
    host reads one flag per step (whether any lane still runs), one per
    Newton iteration (whether any lane still iterates) and one per step
    for the Jacobian refresh (whether any lane needs one, which computes
    every lane's Jacobian). Lanes differ from single-lane runs by the
    rounding of the batched products and factors.

    Returns a BDFResult whose fields are per lane: y (B, n); t, steps,
    n_fev, n_jev, success numpy arrays (B,); record (B, record_size, m)
    and record_t (B, record_size). The lockstep iterations are
    max(steps)."""
    B, n = y0.shape
    dtype, dev = y0.dtype, y0.device
    t1f = float(t1)
    span = abs(t1f - float(t0))
    gamma = torch.as_tensor(_GAMMA, dtype=dtype, device=dev)
    alpha = torch.as_tensor(_ALPHA, dtype=dtype, device=dev)
    error_const = torch.as_tensor(_ERROR_CONST, dtype=dtype, device=dev)
    kk = torch.arange(MAX_ORDER + 3, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    fb = torch.func.vmap(f)
    jb = torch.func.vmap(torch.func.jacfwd(f, argnums=1))
    reads = 0

    def any_(x) -> bool:
        nonlocal reads
        reads += 1
        return bool(x.any())

    def rms(v):
        return torch.sqrt(torch.mean(v * v, dim=-1))

    def col(x):
        return x[:, None]

    def factor(J, c):
        LU, piv, _ = torch.linalg.lu_factor_ex(eye - c[:, None, None] * J)
        return LU, piv

    t = torch.full((B,), float(t0), dtype=dtype, device=dev)
    f0 = fb(t, y0)
    scale0 = atol + rtol * torch.abs(y0)
    d0, d1 = rms(y0 / scale0), rms(f0 / scale0)
    h = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                    torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    h = torch.minimum(h, torch.full_like(h, span))
    D = torch.zeros((B, MAX_ORDER + 3, n), dtype=dtype, device=dev)
    D[:, 0] = y0
    D[:, 1] = f0 * col(h)

    if record_fn is not None:
        rec_b = torch.func.vmap(lambda y: torch.atleast_1d(
            torch.as_tensor(record_fn(y), dtype=dtype)))
        rec_size = max(record_size, 1)
        r0 = rec_b(y0)
        buf = torch.zeros((B, rec_size, r0.shape[1]), dtype=dtype,
                          device=dev)
        buf[:, 0] = r0
        buf_t = torch.full((B, rec_size), float(t0), dtype=dtype, device=dev)
        rec = torch.ones((B,), dtype=torch.long, device=dev)
        lanes = torch.arange(B, device=dev)

    J = jb(t, y0)
    c_lu = h / alpha[1]
    LU, piv = factor(J, c_lu)
    order = torch.ones((B,), dtype=torch.long, device=dev)
    n_eq = torch.zeros_like(order)
    steps = torch.zeros_like(order)
    n_fev = torch.ones_like(order)
    n_jev = torch.ones_like(order)
    fail = torch.zeros((B,), dtype=torch.bool, device=dev)

    def newton(run, t_new, y_pred, c, psi, scale, LU, piv, known=False):
        """Modified Newton in the lanes `run`; `known`: some lane of
        `run` is known to iterate, so the first check reads nothing."""
        d = torch.zeros_like(y_pred)
        y = y_pred
        dwn_old = torch.zeros_like(c)
        conv = torch.zeros_like(run)
        div = torch.zeros_like(run)
        nf = torch.zeros_like(order)
        going = run
        for it in range(NEWTON_MAXITER):
            if not (known and it == 0) and not any_(going):
                break
            rhs = col(c) * fb(t_new, y) - psi - d
            dw = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
            dwn = rms(dw / scale)
            rate = dwn / torch.clamp_min(dwn_old, 1e-300)
            safe_rate = torch.clamp_max(rate, 0.999)
            conv_now = (safe_rate / (1.0 - safe_rate) * dwn < 1e-3
                        if it > 0 else dwn < 1e-12)
            g = col(going)
            d = torch.where(g, d + dw, d)
            y = torch.where(g, y_pred + d, y)
            dwn_old = torch.where(going, dwn, dwn_old)
            nf = nf + going.long()
            conv = conv | (going & conv_now)
            if it > 0:
                div = div | (going & (rate >= 1.0))
            going = going & ~conv & ~div
        return d, conv & ~div, nf

    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        while True:
            active = (t < t1f) & ~fail
            if not any_(active):
                break
            # clip final step
            hs = torch.minimum(h, t1f - t)
            clip = active & (hs < h)
            D = torch.where(clip[:, None, None],
                            _rescale_batched(D, order, hs / h), D)
            c = hs / alpha[order]
            refac = active & (c != c_lu)
            LU_n, piv_n = factor(J, c)
            LU = torch.where(refac[:, None, None], LU_n, LU)
            piv = torch.where(col(refac), piv_n, piv)
            t_new = t + hs

            upto = (kk[None, :] <= col(order))[..., None]          # (B,8,1)
            y_pred = torch.where(upto, D, 0.0).sum(dim=1)
            scale = atol + rtol * torch.abs(y_pred)
            mid = upto & (kk >= 1)[None, :, None]
            g = gamma[torch.clamp(kk, max=MAX_ORDER)][None, :, None]
            psi = torch.where(mid, D * g, 0.0).sum(dim=1) \
                / col(alpha[order])

            d, ok, nf1 = newton(active, t_new, y_pred, c, psi, scale, LU,
                                piv)
            need = active & ~ok
            nf2 = torch.zeros_like(nf1)
            if any_(need):
                # refresh the Jacobian at the prediction and retry once, in
                # the lanes whose Newton failed
                J = torch.where(need[:, None, None], jb(t_new, y_pred), J)
                LU_n, piv_n = factor(J, c)
                LU = torch.where(need[:, None, None], LU_n, LU)
                piv = torch.where(col(need), piv_n, piv)
                d2, ok2, nf2 = newton(need, t_new, y_pred, c, psi, scale,
                                      LU, piv, known=True)
                d = torch.where(col(need), d2, d)
                ok = torch.where(need, ok2, ok)

            err_norm = rms(col(error_const[order]) * d / scale)
            accept = active & ok & (err_norm <= 1.0)
            reject = active & ~accept

            # accepted: update the difference array
            o1 = (order + 1)[:, None, None].expand(B, 1, n)
            Da = D.clone()
            Da.scatter_(1, o1 + 1, d[:, None] - D.gather(1, o1))
            Da.scatter_(1, o1, d[:, None])
            for k in range(MAX_ORDER, -1, -1):
                Da[:, k] = torch.where(col(k <= order),
                                       Da[:, k] + Da[:, k + 1], Da[:, k])
            n_eq_a = n_eq + 1
            adapt = accept & (n_eq_a >= order + 1)
            em = torch.where(
                order > 1,
                error_const[order - 1]
                * rms(Da.gather(1, o1 - 1)[:, 0] / scale),
                torch.full_like(err_norm, np.inf))
            ep = torch.where(
                order < MAX_ORDER,
                error_const[torch.clamp(order + 1, max=MAX_ORDER)]
                * rms(Da.gather(1, o1 + 1)[:, 0] / scale),
                torch.full_like(err_norm, np.inf))
            errs = torch.stack([em, torch.clamp_min(err_norm, 1e-300), ep],
                               dim=1)
            powers = 1.0 / (col(order).to(dtype)
                            + torch.arange(3, dtype=dtype, device=dev))
            factors = torch.pow(torch.clamp_min(errs, 1e-300), -powers)
            best = torch.argmax(factors, dim=1)
            new_order = torch.clamp(order + best - 1, 1, MAX_ORDER)
            fac = torch.clamp(0.9 * factors.gather(1, col(best))[:, 0],
                              MIN_FACTOR, MAX_FACTOR)
            Da = torch.where(adapt[:, None, None],
                             _rescale_batched(Da, new_order, fac), Da)
            fac = torch.where(adapt, fac, torch.ones_like(fac))

            # rejected: shrink the step
            factor_rej = torch.where(
                ok, torch.clamp(0.9 * err_norm
                                ** (-1.0 / (order + 1).to(dtype)),
                                MIN_FACTOR, 0.9),
                torch.full_like(err_norm, 0.5))
            Dr = _rescale_batched(D, order, factor_rej)

            if record_fn is not None:
                slot = torch.clamp_max(rec, rec_size - 1)
                row = torch.where(col(accept), rec_b(y_pred + d),
                                  buf[lanes, slot])
                buf[lanes, slot] = row
                buf_t[lanes, slot] = torch.where(accept, t_new,
                                                 buf_t[lanes, slot])
                rec = rec + accept.long()

            D = torch.where(accept[:, None, None], Da,
                            torch.where(reject[:, None, None], Dr, D))
            h_new = torch.where(accept, hs * fac, hs * factor_rej)
            t = torch.where(accept, t_new, t)
            order = torch.where(adapt, new_order, order)
            n_eq = torch.where(adapt | reject, torch.zeros_like(n_eq),
                               torch.where(accept, n_eq_a, n_eq))
            h = torch.where(active, h_new, h)
            c_lu = torch.where(active, c, c_lu)
            fail = fail | (active & ((h_new <= span * 1e-14)
                                     | (steps + 1 >= max_steps)))
            steps = steps + active.long()
            n_fev = n_fev + torch.where(active, nf1 + nf2 + 1, 0)
            n_jev = n_jev + need.long()

    t_h = t.cpu().numpy()
    return BDFResult(
        D[:, 0].clone(), t_h, steps.cpu().numpy(), n_fev.cpu().numpy(),
        n_jev.cpu().numpy(), (~fail.cpu().numpy()) | (t_h >= t1f),
        buf if record_fn is not None else None,
        buf_t if record_fn is not None else None, reads)
