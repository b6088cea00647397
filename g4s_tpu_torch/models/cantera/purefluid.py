"""Pure-fluid phases: real-fluid equations of state, the tpx library
(counterpart of g4s_tpu/models/cantera/purefluid.py).

Reference: cantera/src/thermo/PureFluidPhase.cpp + src/tpx/: Reynolds
(1979) "Thermodynamic Properties in SI" substance fits, a modified-BWR
pressure equation P = rho R T + sum_i C_i(T) H_i(rho), with internal
energy and entropy from the exact integrals

    u = sum_i (C_i - T C_i') I_i(rho) + u_ideal(T) + u0
    s = -sum_i C_i' I_i(rho) - R ln rho + s_ideal(T) + s0

plus saturation-pressure and saturated-liquid-density correlations per
substance (Nitrogen.cpp, CarbonDioxide.cpp).

The C_i(T) coefficient vector is one torch function per substance and
C_i' comes from torch.func.jacfwd. `rho_tp` runs the reference's damped
Newton with C(T) evaluated once per solve (T is fixed there, so the
iterates are the reference's), replayed from a CUDA graph on the card;
the saturation state is the Maxwell
equal-Gibbs construction (Sub.cpp:update_sat), a host loop over device
solves as in the reference. Numbers become f64 tensors on `device`
("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp

from g4s_tpu_torch.models.cantera.thermo import (as_tensors, const_tensor,
                                                 graphable, replay)

GAS_CONSTANT = 8314.462618153324     # J/kmol/K


class Substance(NamedTuple):
    name: str
    M: float          # kg/kmol
    Tmin: float
    Tmax: float
    Tc: float
    Pc: float
    Roc: float        # critical density kg/m^3
    R: float          # specific gas constant J/kg/K
    C: Callable       # T -> coefficient vector
    H: Callable       # rho -> density basis for P
    I: Callable       # rho -> density basis for u, s
    ideal_u: Callable
    ideal_s: Callable
    psat: Callable
    ldens: Callable
    u0: float
    s0: float


def _const(T, v):
    return torch.full_like(T, v)


_POW_CACHE: dict = {}


def _powers(rho, exponents, n_plain, egrho):
    """The density basis rho^e_i, times exp(-gamma rho^2) past the first
    n_plain terms, along a last axis (one pow over all exponents)."""
    e = const_tensor(_POW_CACHE, tuple(exponents), exponents, rho)
    w = torch.where(torch.arange(len(exponents), device=rho.device)
                    < n_plain, torch.ones_like(egrho)[..., None],
                    egrho[..., None])
    return rho[..., None] ** e * w


# ---------------------------------------------------------------------------
# nitrogen (tpx/Nitrogen.cpp; Reynolds' 32-coefficient fit)
# ---------------------------------------------------------------------------

_N2_A = (
    1.75889959256970e-1, 1.38197604384933e1, -3.14918412133921e2,
    4.40300150239380e3, -5.45358971644916e5, 4.84413320182919e-4,
    -5.18964416491365e-2, 6.57265859197103e-4, 8.51299771713314e4,
    1.33459405162578e-8, 3.83381319826746e-4, -8.35421151028455e-2,
    2.84874912286101e-7,
    -2.38296116270360e-7, -1.48321912935764e-4, 5.62605853190540e-10,
    -2.98201050924595e-13, 9.85319087685241e-11, -1.92002176056468e-14,
    -7.82250103373122e4, -5.51801778744598e5, -5.72781957607352e-1,
    3.25760529488327e2, -1.34659309828737e-6, -1.92036423064911e-5,
    -3.94564337674524e-12, -2.44388245328965e-9, -1.50970602460077e-18,
    1.25854885346038e-16, -8.34271144923969e-24, -1.17299202018417e-22,
    9.06544823455730e-22)
_N2_F = (8.3944094440e3, -1.8785191705e3, -7.2822291650,
         1.0228509660e-2, 5.5560638250e-4, -5.9445446620e-6,
         2.7154339320e-8, -4.8795359040e-11, 5.0953608240e2)
_N2_D = (3.1402991e2, 4.4111015e2, 9.4622994e2, -2.9067111e3,
         4.4785979e3, -2.2746914e3)
_N2_G = (-2.18203473713518e5, 1.01573580096247e4,
         -1.65504721657240e2, 7.43175999190430e2,
         -5.14605623546025e-3, 5.18347156760489e-6,
         -1.05922170493616e-9, 2.98389393363817e2)
_N2_GAMMA = 7.13602531283233e-6
_N2_ALPHA = 1.95
_N2_BETA = 3353.40610


def _n2_C(T):
    A = _N2_A
    rt = 1.0 / T
    rt2 = rt * rt
    return torch.stack([
        A[0] * T + A[1] * torch.sqrt(T) + A[2] + (A[3] + A[4] * rt) * rt,
        A[5] * T + A[6] + rt * (A[7] + A[8] * rt),
        A[9] * T + A[10] + A[11] * rt,
        _const(T, A[12]),
        rt * (A[13] + A[14] * rt),
        A[15] * rt,
        rt * (A[16] + A[17] * rt),
        A[18] * rt2,
        rt2 * (A[19] + A[20] * rt),
        rt2 * (A[21] + A[22] * rt2),
        rt2 * (A[23] + A[24] * rt),
        rt2 * (A[25] + A[26] * rt2),
        rt2 * (A[27] + A[28] * rt),
        rt2 * (A[29] + A[30] * rt + A[31] * rt2)])


_N2_H_POW = [float(i + 2) for i in range(8)] \
    + [float(2 * i - 13) for i in range(8, 14)]


def _n2_H(rho):
    egrho = torch.exp(-_N2_GAMMA * rho * rho)
    return _powers(rho, _N2_H_POW, 8, egrho)


def _n2_I(rho):
    egrho = torch.exp(-_N2_GAMMA * rho * rho)
    out = [rho ** (i + 1) / (i + 1) for i in range(8)]
    w = (1.0 - egrho) / (2.0 * _N2_GAMMA)
    ws = [w]
    for n in range(1, 6):
        w = (n * ws[-1] - 0.5 * rho ** (2 * n) * egrho) / _N2_GAMMA
        ws.append(w)
    return torch.stack(out + ws, dim=-1)


def _n2_ideal_u(T):
    G = _N2_G
    rt = 1.0 / T
    return (((0.25 * G[6] * T + G[5] / 3.0) * T + 0.5 * G[4]) * T
            + G[3]) * T + G[2] * torch.log(T) \
        - (G[1] + 0.5 * G[0] * rt) * rt \
        + G[7] * _N2_BETA / (torch.exp(_N2_BETA * rt) - 1.0)


def _n2_ideal_s(T):
    G = _N2_G
    rt = 1.0 / T
    return ((G[6] / 3.0 * T + 0.5 * G[5]) * T + G[4]) * T \
        + G[3] * torch.log(T) \
        - ((G[0] * rt / 3.0 + 0.5 * G[1]) * rt + G[2]) * rt \
        + G[7] * (_N2_BETA * rt + _N2_BETA * rt
                  / (torch.exp(_N2_BETA * rt) - 1.0)
                  - torch.log(torch.exp(_N2_BETA * rt) - 1.0))


def _n2_psat(T):
    F = _N2_F
    Tc = 126.2
    lnp = sum(F[i] * T ** (i - 1) for i in range(8) if i != 3)
    lnp = lnp + F[3] * torch.clamp_min(Tc - T, 0.0) ** _N2_ALPHA
    return torch.exp(lnp + F[8] * torch.log(T))


def _n2_ldens(T):
    xx = torch.clamp_min(1.0 - T / 126.2, 0.0)
    return sum(_N2_D[i] * xx ** (i / 3.0) for i in range(6))


NITROGEN = Substance(
    "nitrogen", 28.01348, 63.15, 2000.0, 126.200, 3.4e6, 314.03,
    2.96790515164171e2, _n2_C, _n2_H, _n2_I, _n2_ideal_u, _n2_ideal_s,
    _n2_psat, _n2_ldens, 150877.551, 214.9352518)


# ---------------------------------------------------------------------------
# carbon dioxide (tpx/CarbonDioxide.cpp; Reynolds' fit)
# ---------------------------------------------------------------------------

_CO2_A = (
    2.2488558e-1, -1.3717965e2, -1.4430214e4, -2.9630491e6,
    -2.0606039e8, 4.5554393e-5, 7.7042840e-2, 4.0602371e1,
    4.0029509e-7, -3.9436077e-4, 1.2115286e-10, 1.0783386e-7,
    4.3962336e-11, -3.6505545e4, 1.9490511e7, -2.9186718e9,
    2.4358627e-2, -3.7546530e1, 1.1898141e4)
_CO2_F = (-6.5412610, -2.7914636e-1, -3.4716202, -3.4989637,
          -1.9770948e1, 1.3922839e2, -2.7670389e2, -7.0510251e3)
_CO2_D = (4.6400009e2, 6.7938129e2, 1.4776836e3, -3.1267676e3,
          3.6397656e3, -1.3437098e3)
_CO2_G = (8.726361e3, 1.840040e2, 1.914025, -1.667825e-3,
          7.305950e-7, -1.255290e-10)
_CO2_GAMMA = 5.0e-6
_CO2_TO = 216.54
_CO2_TP = 250.0
_CO2_TC = 304.21
_CO2_PC = 7.38350e6


def _co2_C(T):
    A = _CO2_A
    t1 = 1.0 / T
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t3 * t1
    return torch.stack([
        A[0] * T + A[1] + A[2] * t1 + A[3] * t2 + A[4] * t3,
        A[5] * T + A[6] + A[7] * t1,
        A[8] * T + A[9],
        A[10] * T + A[11],
        _const(T, A[12]),
        A[13] * t2 + A[14] * t3 + A[15] * t4,
        A[16] * t2 + A[17] * t3 + A[18] * t4])


_CO2_H_POW = [2.0, 3.0, 4.0, 5.0, 6.0, 3.0, 5.0]


def _co2_H(rho):
    egrho = torch.exp(-_CO2_GAMMA * rho * rho)
    return _powers(rho, _CO2_H_POW, 5, egrho)


def _co2_I(rho):
    g = _CO2_GAMMA
    egrho = torch.exp(-g * rho * rho)
    return torch.stack(
        [rho ** (i + 1) / (i + 1) for i in range(5)]
        + [(1.0 - egrho) / (2.0 * g),
           (1.0 - egrho * (g * rho ** 2 + 1.0)) / (2.0 * g * g)], dim=-1)


def _co2_ideal_u(T):
    G = _CO2_G
    s = G[0] * torch.log(T / _CO2_TO)
    for i in range(1, 6):
        s = s + G[i] * (T ** i - _CO2_TO ** i) / i
    return s


def _co2_ideal_s(T):
    G = _CO2_G
    s = G[1] * torch.log(T / _CO2_TO) - G[0] * (1.0 / T - 1.0 / _CO2_TO)
    for i in range(2, 6):
        s = s + G[i] * (T ** (i - 1) - _CO2_TO ** (i - 1)) / (i - 1)
    return s


def _co2_psat(T):
    s = sum(_CO2_F[i] * (T / _CO2_TP - 1.0) ** i for i in range(8))
    return torch.exp((_CO2_TC / T - 1.0) * s) * _CO2_PC


def _co2_ldens(T):
    xx = torch.clamp_min(1.0 - T / _CO2_TC, 0.0)
    return sum(_CO2_D[i] * xx ** (i / 3.0) for i in range(6))


CARBON_DIOXIDE = Substance(
    "carbondioxide", 44.01, 216.54, 1500.0, _CO2_TC, _CO2_PC, 464.00,
    188.918, _co2_C, _co2_H, _co2_I, _co2_ideal_u, _co2_ideal_s,
    _co2_psat, _co2_ldens, 3.2174105e5, 2.1396056e3)

SUBSTANCES = {"nitrogen": NITROGEN, "carbondioxide": CARBON_DIOXIDE,
              "carbon-dioxide": CARBON_DIOXIDE, "CO2": CARBON_DIOXIDE,
              "N2": NITROGEN}


# ---------------------------------------------------------------------------
# generic property evaluation (Sub.cpp roles, torch.func for Cprime)
# ---------------------------------------------------------------------------


def pressure(sub: Substance, rho, T, *, device="cuda"):
    """P(rho, T) [Pa]: the modified-BWR Pp()."""
    rho, T = as_tensors(rho, T, device=device)
    return rho * sub.R * T + sub.H(rho) @ sub.C(T)


def u_mass(sub: Substance, rho, T, *, device="cuda"):
    """u [J/kg] on the tpx scale (up() with C' = jacfwd(C))."""
    rho, T = as_tensors(rho, T, device=device)
    C = sub.C(T)
    Cp = jacfwd(sub.C)(T)
    return sub.I(rho) @ (C - T * Cp) + sub.ideal_u(T) + sub.u0


def s_mass(sub: Substance, rho, T, *, device="cuda"):
    """s [J/kg/K] on the tpx scale (sp())."""
    rho, T = as_tensors(rho, T, device=device)
    Cp = jacfwd(sub.C)(T)
    return -(sub.I(rho) @ Cp) + sub.ideal_s(T) + sub.s0 \
        - sub.R * torch.log(rho)


def h_mass(sub: Substance, rho, T, *, device="cuda"):
    rho, T = as_tensors(rho, T, device=device)
    return u_mass(sub, rho, T) + pressure(sub, rho, T) / rho


def g_mass(sub: Substance, rho, T, *, device="cuda"):
    rho, T = as_tensors(rho, T, device=device)
    return h_mass(sub, rho, T) - T * s_mass(sub, rho, T)


def _newton(sub: Substance, T, P, rho, iters: int):
    C = sub.C(T)

    def p_of(r):
        return r * sub.R * T + sub.H(r) @ C
    one = torch.ones_like(rho)
    for _ in range(iters):
        p, dp = jvp(p_of, (rho,), (one,))
        step = (p - P) / dp
        step = torch.minimum(torch.maximum(step, -0.2 * rho), 0.2 * rho)
        rho = rho - step
    return rho


# CUDA graphs of rho_tp, one per (substance, iterations, shapes, device)
_GRAPHS: dict = {}


def rho_tp(sub: Substance, T, P, rho0, iters: int = 80, *, device="cuda"):
    """Solve P(rho, T) = P by damped Newton from rho0 (set_TPp role):
    `iters` steps, each clamped to +-0.2 rho. rho0 may hold several
    starting densities (a 1-d tensor or a list), each solved on its own
    in one batched Newton; dP/drho is a forward-mode derivative, and C(T)
    is evaluated once. On plain CUDA tensors outside torch.func transforms
    the solve is replayed from a CUDA graph (the same kernels and
    values)."""
    if isinstance(rho0, (list, tuple)):
        T, P = as_tensors(T, P, device=device)
        rho0 = torch.stack(as_tensors(*rho0, device=T.device))
    T, P, rho = as_tensors(T, P, rho0, device=device)
    if graphable(T, P, rho):
        key = (sub.name, iters, T.shape, P.shape, rho.shape, rho.dtype,
               rho.device)
        return replay(_GRAPHS, key, lambda T, P, rho: _newton(
            sub, T, P, rho, iters), T, P, rho)
    return _newton(sub, T, P, rho, iters)


def update_sat(sub: Substance, T, iters: int = 30, *, device="cuda"):
    """Saturation state at T: (psat, rho_liquid, rho_vapor) by the
    Maxwell equal-Gibbs construction (Sub.cpp:update_sat); numbers."""
    Tt, = as_tensors(T, device=device)
    T = float(T)
    pp = float(sub.psat(Tt))
    rho_f = float(sub.ldens(Tt))
    rho_v = pp * sub.M / (GAS_CONSTANT * T)
    for _ in range(iters):
        # the liquid and vapour densities in one batched solve, read
        # with their Gibbs energies in one host transfer
        rho = rho_tp(sub, Tt, pp, [rho_f, rho_v])
        rho_f, rho_v, gf, gv = torch.cat(
            [rho, g_mass(sub, rho, Tt)]).tolist()
        dg = gv - gf
        if rho_v > rho_f:
            rho_f, rho_v = rho_v, rho_f
            dg = -dg
        if abs(dg) < 1e-4:
            break
        dp = dg / (1.0 / rho_v - 1.0 / rho_f)
        if abs(dp) > pp:
            pp = pp * np.exp(-dg / (pp * (1.0 / rho_v - 1.0 / rho_f)))
        else:
            pp = pp - dp
        pp = min(max(pp, 1e-8), sub.Pc * 0.999999)
    return pp, rho_f, rho_v


class PureFluid:
    """PureFluidPhase: one species on a tpx real-fluid EoS, with h/s
    offsets anchored to the species' NASA7 ideal-gas reference
    (PureFluidPhase::initThermo). Its solves run on `device`."""

    def __init__(self, sub: Substance, nasa7_coeffs=None,
                 p_ref: float = 101325.0, *, device="cuda"):
        self.sub = sub
        self.mw = sub.M
        self.device = as_tensors(0.0, device=device)[0].device
        self.h_off = 0.0
        self.s_off = 0.0
        if nasa7_coeffs is not None:
            a = np.asarray(nasa7_coeffs, np.float64)
            T0 = 298.15
            if T0 < sub.Tc:
                psat, _, _ = update_sat(sub, T0, device=self.device)
                p = 0.01 * psat
            else:
                p = 0.001 * sub.Pc
            p = 0.001 * p
            rho = float(rho_tp(sub, T0, p, p * sub.M / (GAS_CONSTANT * T0),
                               device=self.device))
            h0_RT = (a[0] + a[1] / 2 * T0 + a[2] / 3 * T0 ** 2
                     + a[3] / 4 * T0 ** 3 + a[4] / 5 * T0 ** 4
                     + a[5] / T0)
            s0_R = (a[0] * np.log(T0) + a[1] * T0 + a[2] / 2 * T0 ** 2
                    + a[3] / 3 * T0 ** 3 + a[4] / 4 * T0 ** 4 + a[6])
            s_R = s0_R - np.log(p / p_ref)
            h_target = h0_RT * GAS_CONSTANT * T0 / self.mw
            s_target = s_R * GAS_CONSTANT / self.mw
            self.h_off = h_target - float(h_mass(sub, rho, T0,
                                                 device=self.device))
            self.s_off = s_target - float(s_mass(sub, rho, T0,
                                                 device=self.device))

    def set_TP(self, T: float, P: float):
        """-> (rho, quality in [0,1] or None) like Substance::Set(TP)."""
        sub = self.sub
        if T < sub.Tc:
            psat, rho_f, rho_v = update_sat(sub, T, device=self.device)
            if abs(P - psat) / P < 1e-8:
                raise ValueError("saturated state: use set_TX")
            rho0 = rho_f if P > psat else \
                min(P * sub.M / (GAS_CONSTANT * T), 0.999 * rho_v)
        else:
            rho0 = P * sub.M / (GAS_CONSTANT * T)
        return float(rho_tp(sub, T, P, rho0, device=self.device)), None

    def set_TX(self, T: float, x: float):
        """Two-phase state: -> (rho, psat)."""
        psat, rho_f, rho_v = update_sat(self.sub, T, device=self.device)
        rho = 1.0 / ((1.0 - x) / rho_f + x / rho_v)
        return rho, psat

    def props(self, T: float, rho: float, quality=None):
        """Molar properties [Cantera SI] at a single-phase state."""
        sub = self.sub
        h = (float(h_mass(sub, rho, T, device=self.device))
             + self.h_off) * self.mw
        s = (float(s_mass(sub, rho, T, device=self.device))
             + self.s_off) * self.mw
        return {"h_mole": h, "s_mole": s, "g_mole": h - T * s,
                "density": rho}
