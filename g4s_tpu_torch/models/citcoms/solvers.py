"""Stokes solvers (counterpart of g4s_tpu/models/citcoms/solvers.py):
Jacobi-preconditioned CG (inner velocity solve) and the Uzawa
pressure-correction CG (outer saddle-point loop).

Algorithms follow the reference exactly:
  - conj_grad:      citcoms/lib/General_matrix_functions.c:307-433
  - Uzawa CG:       citcoms/lib/Stokes_flow_Incomp.c:188-451
  - initial_vel_residual: Stokes_flow_Incomp.c:53-143 (F - grad P - K V)
Convergence monitors (volume-weighted norms) follow
Global_operations.c:496-607 (global_v_norm2 / p_norm2 / div_norm2).

Each loop runs on the host: its condition is evaluated before every body
exactly as the reference's, and whatever part of it lives on the device is
read back once per test (`host_true`, counted in HOST_SYNCS). Iteration
counts are host integers; every other scalar stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from g4s_tpu_torch.models.citcoms.assembly import (
    StokesOperators, assemble_del2_u, assemble_div_u, assemble_grad_p,
    strip_bcs,
)

# device-to-host reads of loop conditions since the last reset
HOST_SYNCS = 0


def host_true(flag: torch.Tensor) -> bool:
    """Read a device boolean on the host (one synchronisation)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(flag)


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nonzero(x):
    """x where it is nonzero, else 1 (the guarded divisors below)."""
    return torch.where(x == 0, 1.0, x)


class StokesProblem(NamedTuple):
    """Operator closures for one Stokes solve."""

    A: Callable            # u (nno,3) -> K u, stripped
    grad_p: Callable       # p (nel,)  -> G p, stripped
    div: Callable          # u -> G^T u (nel,)
    dot_v: Callable        # <a, b> over velocity dofs
    dot_p: Callable        # <a, b> over pressure dofs
    BI: torch.Tensor       # (nno, 3) 1/diag(K)
    BPI: torch.Tensor      # (nel,)
    strip: Callable        # u -> u with prescribed dofs zeroed
    v_norm2: Callable      # volume-weighted mean-square of velocity
    p_norm2: Callable
    div_norm2: Callable


def local_problem(ops: StokesOperators, nmass, e_area,
                  total_volume) -> StokesProblem:
    """Single-device problem from assembled operators."""
    return StokesProblem(
        A=lambda u: assemble_del2_u(ops, u, strip=True),
        grad_p=lambda p: assemble_grad_p(ops, p, strip=True),
        div=lambda u: assemble_div_u(ops, u),
        dot_v=_vdot,
        dot_p=_vdot,
        BI=ops.BI, BPI=ops.BPI,
        strip=lambda u: strip_bcs(u, ops.vbc_mask),
        v_norm2=lambda v: torch.sum(v * v * nmass[:, None]) / total_volume,
        p_norm2=lambda p: torch.sum(p * p * e_area) / total_volume,
        div_norm2=lambda p: torch.sum(p * p / e_area) / total_volume,
    )


class CGResult(NamedTuple):
    x: torch.Tensor
    residual: torch.Tensor
    iterations: int


def conj_grad(prob: StokesProblem, F, acc, max_iter: int) -> CGResult:
    """Solve K d = F with diag-preconditioned CG (conj_grad:307-433)."""
    d = torch.zeros_like(F)
    r = F
    p1 = torch.zeros_like(F)
    dotr0z0 = res = None
    count = 0       # the first pass runs whatever the residual
    while count == 0 or (count < max_iter and host_true(res > acc)):
        z1 = prob.BI * r
        dotr1z1 = prob.dot_v(r, z1)
        if count == 0:
            p2 = z1
        else:
            p2 = torch.addcmul(z1, dotr1z1 / _nonzero(dotr0z0), p1)
        Ap = prob.A(p2)
        dotprod = prob.dot_v(p2, Ap)
        alpha = torch.where(dotprod == 0.0, 1.0e-3,
                            dotr1z1 / _nonzero(dotprod))
        d = torch.addcmul(d, alpha, p2)
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        res = torch.sqrt(prob.dot_v(r, r))
        p1, dotr0z0 = p2, dotr1z1
        count += 1
    return CGResult(prob.strip(d), res, count)


@dataclasses.dataclass(frozen=True)
class UzawaMonitor:
    v_norm: torch.Tensor
    p_norm: torch.Tensor
    dvelocity: torch.Tensor
    dpressure: torch.Tensor
    incompressibility: torch.Tensor
    outer_iterations: int
    inner_iterations: int      # total inner CG iterations


class UzawaParams(NamedTuple):
    accuracy: float
    inner_accuracy_scale: float
    max_outer: int            # p_iterations (Instructions.c:676 default 100)
    max_inner: int            # vlowstep (default 250)
    check_pressure_convergence: bool


def uzawa_cg(prob: StokesProblem, V, P, F, fdotf, params: UzawaParams,
             inner_solve=None):
    """Uzawa pressure CG (solve_Ahat_p_fhat_CG).

    V: (nno,3) initial velocity (BC values imposed); P: (nel,) pressure;
    F: (nno,3) momentum RHS (stripped); fdotf: ||F||.
    `inner_solve(F, acc) -> CGResult` overrides the inner velocity solver
    (the solve_del2_u dispatch, General_matrix_functions.c:91-120).
    Returns (V, P, UzawaMonitor).
    """
    imp = params.accuracy
    inner_acc = imp * params.inner_accuracy_scale * fdotf
    if inner_solve is None:
        inner_solve = lambda F_, acc_: conj_grad(prob, F_, acc_,
                                                 params.max_inner)

    # --- initial velocity residual: solve K u1 = F - G P - K V ---
    F1 = prob.strip(F - prob.grad_p(P) - prob.A(V))
    cg0 = inner_solve(F1, inner_acc)
    V = V + cg0.x

    r1 = prob.div(V)
    vdotv = prob.v_norm2(V)
    inc = torch.sqrt(prob.div_norm2(r1) / (1e-32 + vdotv))
    one = torch.ones((), dtype=F.dtype, device=F.device)
    s1, r0dotz0, dv, dp = torch.zeros_like(r1), None, one, one
    count, converging, inner_total = 0, 0, cg0.iterations
    while count < params.max_outer and converging < 2:
        z1 = prob.BPI * r1
        r1dotz1 = prob.dot_p(r1, z1)
        if count == 0:
            s2 = z1
        else:
            s2 = torch.addcmul(z1, r1dotz1 / _nonzero(r0dotz0), s1)
        cg = inner_solve(prob.grad_p(s2), inner_acc)
        u1 = cg.x
        F3 = prob.div(u1)
        alpha = r1dotz1 / prob.dot_p(s2, F3)
        r1 = torch.addcmul(r1, alpha, F3, value=-1.0)
        P = torch.addcmul(P, alpha, s2)
        V = torch.addcmul(V, alpha, u1, value=-1.0)

        vdotv = prob.v_norm2(V)
        pdotp = prob.p_norm2(P)
        dv = alpha * torch.sqrt(prob.v_norm2(u1) / (1e-32 + vdotv))
        dp = alpha * torch.sqrt(prob.p_norm2(s2) / (1e-32 + pdotp))
        inc = torch.sqrt(prob.div_norm2(prob.div(V)) / (1e-32 + vdotv))

        if params.check_pressure_convergence:
            conv_now = torch.logical_and(dv < imp, dp < imp)
        else:
            conv_now = dv < imp
        converging = converging + 1 if host_true(conv_now) else 0
        s1, r0dotz0 = s2, r1dotz1
        count += 1
        inner_total += cg.iterations

    mon = UzawaMonitor(torch.sqrt(prob.v_norm2(V)), torch.sqrt(prob.p_norm2(P)),
                       dv, dp, inc, count, inner_total)
    return V, P, mon


def uzawa_bicgstab(prob: StokesProblem, V, P, F, fdotf,
                   params: UzawaParams):
    """BiCGstab pressure solver (the reference's compressible-capable
    variant, solve_Ahat_p_fhat_BiCG, Stokes_flow_Incomp.c:453+).

    Solves the pressure Schur system S p = div(K^-1 F) with
    S p = div(K^-1 G p); every operator application is one inner CG
    velocity solve. Preconditioner: BPI (same as the CG path).
    Returns (V, P, UzawaMonitor).
    """
    imp = params.accuracy
    inner_acc = imp * params.inner_accuracy_scale * fdotf

    def schur(p):
        cg = conj_grad(prob, prob.grad_p(p), inner_acc, params.max_inner)
        return prob.div(cg.x), cg.x, cg.iterations

    # initial velocity: K u = F - G P - K V
    F1 = prob.strip(F - prob.grad_p(P) - prob.A(V))
    cg0 = conj_grad(prob, F1, inner_acc, params.max_inner)
    V = V + cg0.x
    r = prob.div(V)
    rhat = r

    one = torch.ones((), dtype=F.dtype, device=F.device)
    p_dir = v_dir = torch.zeros_like(r)
    rho = alpha = omega = dvel = dpre = one
    it, inner, done = 0, cg0.iterations, False
    while it < params.max_outer and not done:
        rho_new = prob.dot_p(rhat, r)
        if it == 0:
            p_dir = r
        else:
            beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
            p_dir = r + beta * (p_dir - omega * v_dir)
        z = prob.BPI * p_dir
        v_new, u_v, n_v = schur(z)
        alpha = rho_new / _nonzero(prob.dot_p(rhat, v_new))
        s = r - alpha * v_new
        zs = prob.BPI * s
        t, u_t, n_t = schur(zs)
        tt = prob.dot_p(t, t)
        omega = torch.where(tt == 0, 0.0, prob.dot_p(t, s) / tt)
        dP = alpha * z + omega * zs
        dV = alpha * u_v + omega * u_t
        P = P + dP
        V = V - dV
        r = s - omega * t
        # convergence monitors (the reference's dvelocity/dpressure,
        # Stokes_flow_Incomp.c:497-520)
        dvel = torch.sqrt(prob.v_norm2(dV) / (1e-32 + prob.v_norm2(V)))
        dpre = torch.sqrt(prob.p_norm2(dP) / (1e-32 + prob.p_norm2(P)))
        res = torch.sqrt(prob.div_norm2(r) / (1e-32 + prob.v_norm2(V)))
        done = host_true(res < imp)
        v_dir, rho = v_new, rho_new
        it += 1
        inner += n_v + n_t
    inc = torch.sqrt(prob.div_norm2(prob.div(V))
                     / (1e-32 + prob.v_norm2(V)))
    mon = UzawaMonitor(torch.sqrt(prob.v_norm2(V)), torch.sqrt(prob.p_norm2(P)),
                       dvel, dpre, inc, it, inner)
    return V, P, mon
