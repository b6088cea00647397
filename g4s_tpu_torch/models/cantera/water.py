"""IAPWS-95 real-water equation of state (counterpart of
g4s_tpu/models/cantera/water.py; Cantera's WaterPropsIAPWS role).

The dimensionless Helmholtz energy phi(tau, delta) = phi0 + phir is
written once and torch.func.grad produces every property derivative.
Coefficients are the published IAPWS-95 release constants (Wagner &
Pruss 2002), with the two triple-point anchoring corrections Cantera
applies to n0_1, n0_2 (u = s = 0 for liquid water at the triple point).

Every function takes tensors or numbers and composes with torch.func
(grad, jacfwd, vmap): `density` runs the reference's 60 damped Newton
steps as a plain loop, so its derivatives go through the iterates as the
reference's do, and `torch.func.vmap(density)` solves a grid of states at
once. Numbers become f64 tensors on `device` ("cuda" unless the caller
asks for the CPU) or on the device of a tensor argument.

Units follow the reference: Rgas = 8.314371e3 J/kmol/K (the value in
the IAPWS release), M = 18.015268 kg/kmol, T_c = 647.096 K,
rho_c = 322 kg/m^3.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, grad_and_value

from g4s_tpu_torch.models.cantera.thermo import (as_tensors, const_tensor,
                                                 graphable, replay)

T_C = 647.096
RHO_C = 322.0
RGAS = 8.314371e3          # J / kmol / K (IAPWS release value)
M_WATER = 18.015268        # kg / kmol
ONE_ATM = 101325.0

_NI0 = np.array([
    0.0, -8.320446483749715, 6.683210527593232,
    3.00632, 0.012436, 0.97315,
    1.2795, 0.96956, 0.24873,
])

_GAMMA0 = np.array([
    0.0, 0.0, 0.0,
    0.0, 1.28728967, 3.53734222,
    7.74073708, 9.24437796, 27.5075105,
])

_NI = np.array([
    0.0, 0.012533547935523, 7.8957634722828,
    -8.7803203303561, 0.31802509345418, -0.26145533859358,
    -0.0078199751687981, 0.0088089493102134, -0.66856572307965,
    0.20433810950965, -6.6212605039687e-05, -0.19232721156002,
    -0.25709043003438, 0.16074868486251, -0.040092828925807,
    3.9343422603254e-07, -7.5941377088144e-06, 0.00056250979351888,
    -1.5608652257135e-05, 1.1537996422951e-09, 3.6582165144204e-07,
    -1.3251180074668e-12, -6.2639586912454e-10, -0.10793600908932,
    0.017611491008752, 0.22132295167546, -0.40247669763528,
    0.58083399985759, 0.0049969146990806, -0.031358700712549,
    -0.74315929710341, 0.4780732991548, 0.020527940895948,
    -0.13636435110343, 0.014180634400617, 0.0083326504880713,
    -0.029052336009585, 0.038615085574206, -0.020393486513704,
    -0.0016554050063734, 0.0019955571979541, 0.00015870308324157,
    -1.638856834253e-05, 0.043613615723811, 0.034994005463765,
    -0.076788197844621, 0.022446277332006, -6.2689710414685e-05,
    -5.5711118565645e-10, -0.19905718354408, 0.31777497330738,
    -0.11841182425981, -31.306260323435, 31.546140237781,
    -2521.3154341695, -0.14874640856724, 0.31806110878444,
])

_DI = np.array([
    0, 1, 1, 1, 2, 2, 3, 4, 1, 1,
    1, 2, 2, 3, 4, 4, 5, 7, 9, 10,
    11, 13, 15, 1, 2, 2, 2, 3, 4, 4,
    4, 5, 6, 6, 7, 9, 9, 9, 9, 9,
    10, 10, 12, 3, 4, 4, 5, 14, 3, 6,
    6, 6, 3, 3, 3,
], np.float64)

_TI_1_7 = np.array([
    0.0, -0.5, 0.875, 1.0,
    0.5, 0.75, 0.375, 1.0,
])

_TIR = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 4, 6,
    12, 1, 5, 4, 2, 13, 9, 3, 4, 11,
    4, 13, 1, 7, 1, 9, 10, 10, 3, 7,
    10, 10, 6, 10, 10, 1, 2, 3, 4, 8,
    6, 9, 8, 16, 22, 23, 23, 10, 50, 44,
    46, 50, 0, 1, 4,
], np.float64)

_CIR = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 3, 3, 3, 3, 4, 6, 6,
    6, 6, 0, 0, 0, 0,
], np.float64)

# the coefficient groups of phi0 and phir, by term range
_ARRAYS = {
    "n0": _NI0[4:9], "g0": -_GAMMA0[4:9],
    "n1": _NI[1:8], "d1": _DI[1:8], "t1": _TI_1_7[1:8],
    "n8": _NI[8:52], "d8": _DI[8:52], "t8": _TIR[8:52], "c8": _CIR[8:52],
    "n52": _NI[52:55], "d52": _DI[52:55], "t52": _TIR[52:55],
    "alpha": [20.0, 20.0, 20.0], "beta": [150.0, 150.0, 250.0],
    "gamma": [1.21, 1.21, 1.25], "eps": [1.0, 1.0, 1.0],
    "a56": [3.5, 3.5], "b56": [0.85, 0.95], "bb": [0.2, 0.2],
    "cc": [28.0, 32.0], "dd": [700.0, 800.0], "aa": [0.32, 0.32],
    "half_over_bbeta": [0.5 / 0.3, 0.5 / 0.3], "n55": _NI[55:57],
}
_CACHE: dict = {}


def _c(name, like):
    return const_tensor(_CACHE, name, _ARRAYS[name], like)


def _phi0(tau, delta):
    v = (torch.log(delta) + float(_NI0[1]) + float(_NI0[2]) * tau
         + float(_NI0[3]) * torch.log(tau))
    return v + torch.sum(_c("n0", tau)
                         * torch.log(1.0 - torch.exp(_c("g0", tau) * tau)))


def _phir(tau, delta):
    # terms 1-7 (pure polynomial; fractional tau exponents)
    v = torch.sum(_c("n1", tau) * delta ** _c("d1", tau)
                  * tau ** _c("t1", tau))
    # terms 8-51 (polynomial * exp(-delta^c))
    v = v + torch.sum(_c("n8", tau) * delta ** _c("d8", tau)
                      * tau ** _c("t8", tau)
                      * torch.exp(-delta ** _c("c8", tau)))
    # terms 52-54 (Gaussian)
    v = v + torch.sum(_c("n52", tau) * delta ** _c("d52", tau)
                      * tau ** _c("t52", tau)
                      * torch.exp(-_c("alpha", tau)
                                  * (delta - _c("eps", tau)) ** 2
                                  - _c("beta", tau)
                                  * (tau - _c("gamma", tau)) ** 2))
    # terms 55-56 (critical region)
    dm1sq = (delta - 1.0) ** 2 + 1e-300
    theta = (1.0 - tau) + _c("aa", tau) * dm1sq ** _c("half_over_bbeta", tau)
    Delta = theta ** 2 + _c("bb", tau) * dm1sq ** _c("a56", tau)
    psi = torch.exp(-_c("cc", tau) * dm1sq - _c("dd", tau) * (tau - 1.0) ** 2)
    return v + torch.sum(_c("n55", tau) * Delta ** _c("b56", tau) * delta
                         * psi)


def _phi(tau, delta):
    return _phi0(tau, delta) + _phir(tau, delta)


_phir_d = grad(_phir, argnums=1)
_phi_t = grad(_phi, argnums=0)


def pressure(T, rho, *, device="cuda"):
    """p(T, rho) [Pa]: p = rho R T (1 + delta phir_d) / M."""
    T, rho = as_tensors(T, rho, device=device)
    tau = T_C / T
    delta = rho / RHO_C
    return rho * RGAS * T / M_WATER * (1.0 + delta * _phir_d(tau, delta))


def _dp_drho(T, rho):
    return grad(lambda r: pressure(T, r))(rho)


WATER_GAS = 0
WATER_LIQUID = 1


def _newton(T, P, rho):
    """The reference's 60 Newton steps from rho, each clamped to +-0.2
    rho."""
    for _ in range(60):
        # p and dp/drho from one pass (the reference evaluates p twice)
        df, p = grad_and_value(lambda r: pressure(T, r))(rho)
        step = (p - P) / df
        # damped to stay on the branch
        step = torch.minimum(torch.maximum(step, -0.2 * rho), 0.2 * rho)
        rho = rho - step
    return rho


def _start(T, P, phase):
    return (torch.full_like(T, 1000.0) if phase == WATER_LIQUID
            else P * M_WATER / (RGAS * T))


# CUDA graphs of the density solve, one per (phase, shape, dtype, device)
_GRAPHS: dict = {}


def density(T, P, phase=WATER_LIQUID, rho_guess=None, *, device="cuda"):
    """Invert p(T, rho) = P by 60 Newton steps, each clamped to +-0.2 rho
    (the m_sub.density role). phase picks the starting branch: liquid
    starts at 1000 kg/m^3, gas from the ideal-gas estimate. On plain CUDA
    tensors outside torch.func transforms, with no rho_guess, the solve is
    replayed from a CUDA graph (the same kernels and values)."""
    T, P = as_tensors(T, P, device=device)
    if rho_guess is None:
        if graphable(T, P):
            key = (phase, T.shape, P.shape, T.dtype, T.device)
            return replay(_GRAPHS, key, lambda T, P: _newton(T, P, _start(
                T, P, phase)), T, P)
        return _newton(T, P, _start(T, P, phase))
    if not isinstance(rho_guess, torch.Tensor):
        rho_guess = torch.full_like(T, float(rho_guess))
    return _newton(T, P, rho_guess)


def density_at(T, P, rho):
    """The density `rho` already solved at (T, P), as a function of T and
    P for torch.func: its value is rho exactly, and its first derivatives
    are those of the Newton fixed point, from one Newton step taken at rho
    held constant whose value is left out (straight through). At a
    converged rho they are the derivatives of density(T, P), which the
    60 differentiated steps give at 60 times the cost; second derivatives
    are not those of density."""
    T, P = as_tensors(T, P, device=rho.device)
    step = (pressure(T, rho) - P) / _dp_drho(T, rho)
    return rho - (step - step.detach())


def helmholtz_mole(T, rho, *, device="cuda"):
    """A [J/kmol]."""
    T, rho = as_tensors(T, rho, device=device)
    tau = T_C / T
    return RGAS * T * _phi(tau, rho / RHO_C)


def entropy_mole(T, rho, *, device="cuda"):
    """s [J/kmol/K]: s/R = tau phi_tau - phi."""
    T, rho = as_tensors(T, rho, device=device)
    tau = T_C / T
    delta = rho / RHO_C
    return RGAS * (tau * _phi_t(tau, delta) - _phi(tau, delta))


def enthalpy_mole(T, rho, *, device="cuda"):
    """h [J/kmol]: h/RT = 1 + tau phi_tau|0+r + delta phir_d."""
    T, rho = as_tensors(T, rho, device=device)
    tau = T_C / T
    delta = rho / RHO_C
    return RGAS * T * (1.0 + tau * _phi_t(tau, delta)
                       + delta * _phir_d(tau, delta))


def gibbs_mole(T, rho, *, device="cuda"):
    T, rho = as_tensors(T, rho, device=device)
    return helmholtz_mole(T, rho) + pressure(T, rho) * M_WATER / rho


def isothermal_compressibility(T, rho, *, device="cuda"):
    T, rho = as_tensors(T, rho, device=device)
    return 1.0 / (rho * _dp_drho(T, rho))


def thermal_expansion_coeff(T, rho, *, device="cuda"):
    """alpha = -(1/rho)(drho/dT)_P."""
    T, rho = as_tensors(T, rho, device=device)
    dpdT = grad(lambda Tv: pressure(Tv, rho))(T)
    return dpdT / (rho * _dp_drho(T, rho))


class WaterStandardState:
    """PDSS_Water-equivalent: liquid-water-IAPWS95 standard state.

    Anchors the ideal-gas reference as the reference does
    (PDSS_Water.cpp:28-50): at 298.15 K the gas branch at 0.01 Pa is
    offset so s(1 bar basis) = 188.835e3 J/kmol/K and
    h = -241.826e6 J/kmol. The offsets are the reference's constants;
    `_compute_offsets` reproduces them."""

    EW_OFFSET = -287728568.2492926      # J/kmol
    SW_OFFSET = 63307.076228570104      # J/kmol/K

    def __init__(self, *, device="cuda"):
        self.device = device
        self.EW_Offset = self.EW_OFFSET
        self.SW_Offset = self.SW_OFFSET

    def _compute_offsets(self):
        T0 = 298.15
        presLow = 1e-2
        rho_gas = float(density(T0, presLow, WATER_GAS, rho_guess=1e-9,
                                device=self.device))
        s = float(entropy_mole(T0, rho_gas, device=self.device)) \
            - 8.31446261815324e3 * np.log(1e5 / presLow)
        h = float(enthalpy_mole(T0, rho_gas, device=self.device))
        return -241.826e6 - h, 188.835e3 - s

    def mu0(self, T, P=ONE_ATM):
        """Standard chemical potential of liquid water [J/kmol]."""
        T, P = as_tensors(T, P, device=self.device)
        rho = density(T, P, WATER_LIQUID)
        h = enthalpy_mole(T, rho) + self.EW_Offset
        s = entropy_mole(T, rho) + self.SW_Offset
        return h - T * s

    def density(self, T, P=ONE_ATM):
        return density(T, P, WATER_LIQUID, device=self.device)
