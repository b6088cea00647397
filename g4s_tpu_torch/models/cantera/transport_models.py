"""Specialty transport models: UnityLewis, DustyGas, IonGas and the
high-pressure corrections (counterpart of
g4s_tpu/models/cantera/transport_models.py).

Reference capability: cantera/src/transport/{UnityLewisTransport.h,
DustyGasTransport.cpp, IonGasTransport.cpp,
HighPressureGasTransport.cpp} — the remaining transport surface beyond
mixture-averaged (transport.py) and full multicomponent
(multi_transport.py).

  UnityLewis   D_km = lambda / (rho cp) for every species
               (UnityLewisTransport.h: unity Lewis number closure).
  DustyGas     porous-medium transport: H-matrix from porosity/
               tortuosity-scaled binary diffusion + Knudsen terms,
               inverted for the multicomponent D; molar fluxes add the
               Darcy pressure-driven term (DustyGasTransport.cpp:82-175).
  IonGas       ion-neutral collisions through the Stockmayer-(n,6,4)
               polarization model (Han et al. 2015), the O2/O2-
               resonant-charge-transfer table, electron defaults, and
               neutral-only mixture rules (IonGasTransport.cpp).

UnityLewis and DustyGas are torch on the state's device (DustyGas builds
its tensors on `device`, default "cuda"); IonGas and the high-pressure
model are host numpy loops, as in the reference, over the Chapman-Enskog
matrices, which they evaluate on `device` and read back once per call.
The H-matrix inverse is `torch.linalg.inv_ex` (no host read per call).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.kinetics import _floor
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.thermo import as_scalar, mech_tensor
from g4s_tpu_torch.models.cantera.transport import (AVOGADRO, KB,
                                                    TransportData, _offdiag,
                                                    binary_diffusion,
                                                    mixture_viscosity,
                                                    species_viscosities,
                                                    thermal_conductivity)
from g4s_tpu_torch.sparse.containers import resolve_device

E_CHARGE = 1.602176634e-19
EPS0 = 8.8541878128e-12


# ---------------------------------------------------------------------------
# UnityLewis
# ---------------------------------------------------------------------------

def unity_lewis_diffusion(mech: Mechanism, tr: TransportData, T, P, x,
                          cp_R):
    """All-species D_km = lambda/(rho cp) (UnityLewisTransport.h:
    getMixDiffCoeffs): Lewis number Le = 1 closure."""
    T = as_scalar(T, x)
    lam = thermal_conductivity(mech, tr, T, x, cp_R)
    W = mech_tensor(mech, "mol_weights", x)
    Wmix = torch.sum(x * W)
    rho = P * Wmix / (R_GAS * T)
    cp_mass = torch.sum(x * cp_R) * R_GAS / Wmix
    return torch.full_like(x, 1.0) * (lam / (rho * cp_mass))


# ---------------------------------------------------------------------------
# DustyGas
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DustyGas:
    """Porous-medium multicomponent transport
    (DustyGasTransport.cpp). Inputs given as arrays are made tensors on
    `device` in `dtype`."""

    mech: Mechanism
    tr: TransportData
    porosity: float = 0.5
    tortuosity: float = 1.0
    pore_radius: float = 1e-7       # m
    particle_diameter: float = 1e-6  # m
    permeability: Optional[float] = None
    device: object = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _t(self, v):
        return torch.as_tensor(np.asarray(v, np.float64) if not
                               torch.is_tensor(v) else v,
                               dtype=self.dtype, device=self.device)

    def knudsen_diff(self, T):
        """D_k = 2/3 (r phi/tau) sqrt(8RT/(pi W))
        (updateKnudsenDiffCoeffs:82-93)."""
        T = self._t(T)
        Kg = self.pore_radius * self.porosity / self.tortuosity
        W = mech_tensor(self.mech, "mol_weights", T)
        return (2.0 / 3.0) * Kg * torch.sqrt(8.0 * R_GAS * T / (np.pi * W))

    def multi_diff_coeffs(self, T, P, x):
        """H^-1 with H from porosity-scaled binary + Knudsen terms
        (eval_H_matrix:95-114)."""
        T, x = self._t(T), self._t(x)
        n = self.mech.nspec
        d = binary_diffusion(self.mech, self.tr, T, P) \
            * (self.porosity / self.tortuosity)
        dk = self.knudsen_diff(T)
        x = _floor(x, 0.0)
        H = -x[:, None] / d
        off = torch.sum(torch.where(_offdiag(n, x), x[None, :] / d, 0.0),
                        dim=1)
        eye = ~_offdiag(n, x)
        H = torch.where(eye, torch.diag(1.0 / dk + off), H)
        return torch.linalg.inv_ex(H)[0]

    def molar_fluxes(self, T1, T2, rho1, rho2, Y1, Y2, delta):
        """Fluxes across a slab of thickness delta
        (getMolarFluxes:116-175): multicomponent diffusion of the
        concentration gradient + Darcy pressure-driven flow."""
        Y1, Y2 = self._t(Y1), self._t(Y2)
        W = mech_tensor(self.mech, "mol_weights", Y1)
        c1 = rho1 * Y1 / W
        c2 = rho2 * Y2 / W
        cbar = 0.5 * (c1 + c2)
        gradc = (c2 - c1) / delta
        p1 = torch.sum(c1) * R_GAS * T1
        p2 = torch.sum(c2) * R_GAS * T2
        pbar = 0.5 * (p1 + p2)
        gradp = (p2 - p1) / delta
        tbar = 0.5 * (T1 + T2)
        xbar = cbar / torch.sum(cbar)
        Dm = self.multi_diff_coeffs(tbar, pbar, xbar)
        fluxes = Dm @ gradc
        if self.permeability is None:
            p_, d_, t_ = self.porosity, self.particle_diameter, \
                self.tortuosity
            b = p_ ** 3 * d_ * d_ / (72.0 * t_ * (1.0 - p_) ** 2)
        else:
            b = self.permeability
        tbar_t = self._t(tbar)
        mu = mixture_viscosity(self.mech, self.tr, tbar_t, xbar)
        dk = self.knudsen_diff(tbar_t)
        fluxes = fluxes + Dm @ (cbar / dk * (b * gradp / mu))
        return -fluxes

    def thermal_conductivity(self, T, x, cp_R):
        """Delegated to the gas-phase model
        (DustyGasTransport inherits the gas lambda)."""
        return thermal_conductivity(self.mech, self.tr, self._t(T),
                                    self._t(x), self._t(cp_R))


def _host_binary(mech, tr, T, P, device):
    """binary_diffusion at a host (T, P), evaluated on `device` in f64
    and read back."""
    t = torch.as_tensor(float(T), dtype=torch.float64, device=device)
    return binary_diffusion(mech, tr, t, float(P)).cpu().numpy()


# ---------------------------------------------------------------------------
# IonGas
# ---------------------------------------------------------------------------

# O2/O2- resonant-charge-transfer collision integral [A^2] vs T,
# Prager (2005) table (IonGasTransport.cpp:62-71), degree-5 polyfit
_O2_TEMPS = np.array([300.0, 400.0, 500.0, 600.0, 800.0, 1000.0,
                      1200.0, 1500.0, 2000.0, 2500.0, 3000.0, 4000.0])
_O2_OM11 = np.array([120.0, 107.0, 98.1, 92.1, 83.0, 77.0,
                     72.6, 67.9, 62.7, 59.3, 56.7, 53.8])


def _omega11_n64(tstar, gamma):
    """Piecewise fit of the (n,6,4) reduced collision integral
    (IonGasTransport::omega11_n64:319-350)."""
    lt = np.log(tstar)
    if tstar < 0.01:
        raise ValueError(f"tstar {tstar} < 0.01")
    if tstar <= 0.04:
        return (2.97 - 12.0 * gamma - 0.887 * lt + 3.86 * gamma * gamma
                - 6.45 * gamma * lt - 0.275 * lt * lt
                + 1.20 * gamma * gamma * lt - 1.24 * gamma * lt * lt
                - 0.164 * lt ** 3)
    if tstar <= 1000:
        return (1.22 - 0.0343 * gamma
                + (-0.769 + 0.232 * gamma) * lt
                + (0.306 - 0.165 * gamma) * lt * lt
                + (-0.0465 + 0.0388 * gamma) * lt ** 3
                + (0.000614 - 0.00285 * gamma) * lt ** 4
                + 0.000238 * lt ** 5)
    raise ValueError(f"tstar {tstar} > 1000")


class IonGasTransport:
    """Ion/electron-aware gas transport (IonGasTransport.cpp).

    Neutral pairs keep the Chapman-Enskog LJ model; ion-neutral pairs
    use the Stockmayer-(n,6,4) polarization model with Han et al.'s
    K2=1.44 refit; O2/O2- uses the experimental table (resonant charge
    transfer); the electron gets the 0.4 m^2/V/s mobility default.
    Mixture rules sum over NEUTRAL species only."""

    def __init__(self, mech: Mechanism, tr: TransportData, charges=None,
                 *, device="cuda"):
        self.mech = mech
        self.tr = tr
        self.device = resolve_device(device)
        n = mech.nspec
        if charges is None:
            charges = np.array([-c.get("E", 0.0)
                                for c in mech.compositions])
        self.charge = np.asarray(charges, np.float64)
        self.k_e = None
        for k in range(n):
            if self.charge[k] == -1 and mech.mol_weights[k] < 1e-5:
                self.k_e = k
        self.ions = [k for k in range(n)
                     if self.charge[k] != 0 and k != self.k_e]
        self.neutrals = [k for k in range(n) if self.charge[k] == 0]
        self._setup_n64()
        self._om11_o2_poly = np.polyfit(_O2_TEMPS, _O2_OM11, 5)
        try:
            self.k_o2 = mech.species_names.index("O2")
            self.k_o2m = mech.species_names.index("O2-")
        except ValueError:
            self.k_o2 = self.k_o2m = None

    def _setup_n64(self):
        """diam/epsilon/gamma for ion-neutral pairs
        (setupN64:252-317). alpha in the yaml is in Angstrom^3; SI m^3
        = 1e-30 * A^3."""
        n = self.mech.nspec
        alpha = np.asarray(self.tr.polarizability) * 1e-30
        self.diam = np.zeros((n, n))
        self.epsn = np.zeros((n, n))
        self.gamma = np.zeros((n, n))
        disp = np.zeros(n)
        quad = np.zeros(n)
        for i in self.ions:
            for j in self.neutrals:
                if alpha[i] == 0.0 or alpha[j] == 0.0:
                    continue
                r_alpha = alpha[i] / alpha[j]
                aAi, aAj = alpha[i] * 1e30, alpha[j] * 1e30
                z2 = self.charge[i] ** 2
                xi = aAi / (z2 * (1.0 + (2 * r_alpha) ** (2.0 / 3.0))
                            * np.sqrt(aAj))
                K1, kappa = 1.767, 0.095
                dij = K1 * (alpha[i] ** (1 / 3) + alpha[j] ** (1 / 3)) \
                    / (aAi * aAj * (1.0 + 1.0 / xi)) ** kappa
                self.diam[i, j] = dij
                eps = (1.44 * E_CHARGE ** 2 * z2 * alpha[j] * (1.0 + xi)
                       / (8 * np.pi * EPS0 * dij ** 4))
                self.epsn[i, j] = eps
                if disp[j] == 0.0:
                    disp[j] = np.exp(1.8846 * np.log(aAj) - 0.4737) * 1e-50
                if quad[j] == 0.0:
                    quad[j] = 2.0 * disp[j]
                if disp[i] == 0.0:
                    if self.charge[i] > 0:
                        disp[i] = np.exp(1.8853 * np.log(aAi)
                                         + 0.2682) * 1e-50
                    else:
                        disp[i] = np.exp(3.2246 * np.log(aAi)
                                         - 3.2397) * 1e-50
                C6 = 2.0 * disp[i] * disp[j] / (disp[i] / r_alpha
                                                + disp[j] * r_alpha)
                self.gamma[i, j] = (2.0 / z2 * C6 + quad[j]) \
                    / (alpha[j] * dij * dij)
                self.diam[j, i] = dij
                self.epsn[j, i] = eps
                self.gamma[j, i] = self.gamma[i, j]

    def binary_diff(self, T, P):
        """(n, n) binary diffusion at (T, P): LJ for neutral pairs,
        (n,6,4) for ion-neutral, O2/O2- table
        (fitDiffCoeffs:160-246, evaluated directly — no polyfit)."""
        n = self.mech.nspec
        D = _host_binary(self.mech, self.tr, T, P, self.device)
        m = np.asarray(self.mech.mol_weights) / AVOGADRO
        for i in self.ions:
            for j in self.neutrals:
                if self.diam[i, j] == 0.0:
                    continue
                tstar = KB * T / self.epsn[i, j]
                om11 = _omega11_n64(tstar, self.gamma[i, j]) \
                    * np.pi * self.diam[i, j] ** 2
                if self.k_o2 is not None and \
                        {i, j} == {self.k_o2, self.k_o2m}:
                    om11 = np.polyval(self._om11_o2_poly, T) / 1e20
                mu = m[i] * m[j] / (m[i] + m[j])
                d = (3.0 / 16.0 * np.sqrt(2.0 * np.pi / mu)
                     * (KB * T) ** 1.5 / om11) / P
                D[i, j] = D[j, i] = d
        return D

    def mix_diff_coeffs(self, T, P, x):
        """getMixDiffCoeffs:352-386: ions/neutrals sum over neutral
        partners only; electron D = 0.4 kT/e."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        D = self.binary_diff(T, P)
        W = np.asarray(self.mech.mol_weights)
        mmw = float(x @ W)
        out = np.zeros(self.mech.nspec)
        for k in range(self.mech.nspec):
            if k == self.k_e:
                out[k] = 0.4 * KB * T / E_CHARGE
                continue
            s = sum(x[j] / D[j, k] for j in self.neutrals if j != k)
            out[k] = D[k, k] if s <= 0.0 \
                else (mmw - x[k] * W[k]) / (mmw * s)
        return out

    def mobilities(self, T, P, x):
        """getMobilities:388-412: mobility of ion k from the
        neutral-partner harmonic sum of e D_kj / kT."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        D = self.binary_diff(T, P)
        kbt = KB * T
        out = np.zeros(self.mech.nspec)
        if self.k_e is not None:
            out[self.k_e] = 0.4
        for k in self.ions:
            s = sum(x[j] / (D[k, j] * E_CHARGE / kbt)
                    for j in self.neutrals)
            out[k] = 1.0 / s
        return out

    def viscosity(self, T, x):
        """Wilke over neutral species only (viscosity:102-124)."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        mu = species_viscosities(self.mech, self.tr, torch.as_tensor(
            float(T), dtype=torch.float64, device=self.device)).cpu().numpy()
        W = np.asarray(self.mech.mol_weights)
        phi = (1.0 + np.sqrt(mu[:, None] / mu[None, :])
               * (W[None, :] / W[:, None]) ** 0.25) ** 2 \
            / np.sqrt(8.0 * (1.0 + W[:, None] / W[None, :]))
        denom = phi @ x
        return float(sum(x[k] * mu[k] / denom[k] for k in self.neutrals))

    def electrical_conductivity(self, T, P, x):
        """electricalConductivity:143-158."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        mobi = self.mobilities(T, P, x)
        kbt = KB * T
        s = sum(x[k] * P / kbt * abs(self.charge[k]) * E_CHARGE * mobi[k]
                for k in self.ions)
        if self.k_e is not None:
            s += x[self.k_e] * P / kbt * E_CHARGE * mobi[self.k_e]
        return s


# ---------------------------------------------------------------------------
# HighPressureGasTransport (Lucas viscosity, Takahashi diffusion
# corrections, Ely-Hanley conductivity) — HighPressureGasTransport.cpp
# ---------------------------------------------------------------------------

_TAK_PR = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.4,
                    1.6, 1.8, 2.0, 2.5, 3.0, 4.0, 5.0])
_TAK_DP = np.array([1.01, 1.01, 1.01, 1.01, 1.01, 1.01, 1.01, 1.02, 1.02,
                    1.02, 1.02, 1.03, 1.03, 1.04, 1.05, 1.06, 1.07])
_TAK_A = np.array([0.038042, 0.067433, 0.098317, 0.137610, 0.175081,
                   0.216376, 0.314051, 0.385736, 0.514553, 0.599184,
                   0.557725, 0.593007, 0.696001, 0.790770, 0.502100,
                   0.837452, 0.890390])
_TAK_B = np.array([1.52267, 2.16794, 2.42910, 2.77605, 2.98256, 3.11384,
                   3.50264, 3.07773, 3.54744, 3.61216, 3.41882, 3.18415,
                   3.37660, 3.27984, 3.39031, 3.23513, 3.13001])
_TAK_C = np.array([0., 0., 0., 0., 0., 0., 0., 0.141211, 0.278407,
                   0.372683, 0.504894, 0.678469, 0.665702, 0., 0.602907,
                   0., 0.])
_TAK_E = np.array([1., 1., 1., 1., 1., 1., 1., 13.45454, 14., 10.00900,
                   8.57519, 10.37483, 11.21674, 1., 6.19043, 1., 1.])


def takahashi_correction(Pr: float, Tr: float) -> float:
    """Takahashi high-pressure binary-diffusion correction
    (HighPressureGasTransport::setPcorr:458-503), linear interpolation
    on the published table."""
    i = 0
    if Pr < _TAK_PR[0]:
        frac = (Pr - _TAK_PR[0]) / (_TAK_PR[1] - _TAK_PR[0])
    else:
        frac = 1.0
        for j in range(1, 17):
            if _TAK_PR[j] > Pr:
                frac = (Pr - _TAK_PR[j - 1]) / (_TAK_PR[j] - _TAK_PR[j - 1])
                break
            i += 1
    if i >= 16:
        i, frac = 15, 1.0

    def pc(k):
        return (_TAK_DP[k] * (1.0 - _TAK_A[k] * Tr ** -_TAK_B[k])
                * (1.0 - _TAK_C[k] * Tr ** -_TAK_E[k]))

    return pc(i) * (1.0 - frac) + pc(i + 1) * frac


class HighPressureGasTransport:
    """Dense-gas transport corrections (HighPressureGasTransport.cpp):
    Lucas mixture viscosity, Takahashi-corrected binary diffusion,
    Ely-Hanley thermal conductivity. Critical constants recovered from
    the mechanism's cubic-EoS coefficients (Redlich-Kwong:
    a=0.42748 R^2 Tc^2.5/Pc, b=0.08664 R Tc/Pc; Peng-Robinson
    coefficients carry Tc directly)."""

    def __init__(self, mech: Mechanism, tr: TransportData, *,
                 device="cuda"):
        self.mech = mech
        self.tr = tr
        self.device = resolve_device(device)
        n = mech.nspec
        self.Tc = np.zeros(n)
        self.Pc = np.zeros(n)
        self.Zc = np.full(n, 0.288)
        self.w_ac = np.zeros(n)
        rk_a = np.asarray(mech.rk_a)
        rk_b = np.asarray(mech.rk_b)
        for k in range(n):
            if mech.eos_model.startswith("redlich") and rk_b[k] > 0:
                a0 = rk_a[k][0] if rk_a.ndim == 2 else rk_a[k]
                self.Tc[k] = (0.08664 * a0
                              / (0.42748 * R_GAS * rk_b[k])) ** (2.0 / 3.0)
                self.Pc[k] = 0.08664 * R_GAS * self.Tc[k] / rk_b[k]
                self.Zc[k] = 1.0 / 3.0
            elif mech.pr_Tc is not None and mech.pr_Tc[k] > 0:
                self.Tc[k] = mech.pr_Tc[k]
                self.Pc[k] = 0.07780 * R_GAS * self.Tc[k] / mech.pr_b[k]
                self.Zc[k] = 0.307
                kap = mech.pr_kappa[k]
                # invert kappa = 0.37464 + 1.54226 w - 0.26992 w^2
                disc = 1.54226 ** 2 - 4 * 0.26992 * (0.37464 - kap)
                self.w_ac[k] = (1.54226 - np.sqrt(max(disc, 0.0))) \
                    / (2 * 0.26992)
            else:
                # Joback-free fallback: LJ correspondence Tc ~ 1.316 eps/k,
                # Pc from Zc=0.288 and Vc ~ 3.16 b0 (Poling Table 4-1 role)
                eps = self.tr.well_depth[k]
                sig = self.tr.diameter[k]
                self.Tc[k] = 1.316 * eps
                vc = 3.16 * (2.0 / 3.0 * np.pi * AVOGADRO * sig ** 3)
                self.Pc[k] = self.Zc[k] * R_GAS * self.Tc[k] / vc
        self.Vc = self.Zc * R_GAS * self.Tc / self.Pc

    def binary_diff_coeffs(self, T, P, x):
        """Low-pressure Chapman-Enskog scaled by the Takahashi factor
        per pair (getBinaryDiffCoeffs:135-190)."""
        n = self.mech.nspec
        D = _host_binary(self.mech, self.tr, T, P, self.device)
        x = np.maximum(np.asarray(x, np.float64), 1e-30)
        for i in range(n):
            for j in range(n):
                xi = x[i] / (x[i] + x[j])
                xj = x[j] / (x[i] + x[j])
                Tr = T / (xi * self.Tc[i] + xj * self.Tc[j])
                Pr = P / (xi * self.Pc[i] + xj * self.Pc[j])
                if Pr >= 0.1:
                    D[i, j] *= max(takahashi_correction(Pr, Tr), 1e-30)
        return D

    def viscosity(self, T, P, x):
        """Lucas method mixture viscosity (viscosity:276-372)."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        W = np.asarray(self.mech.mol_weights) * 1e3     # g/mol (Lucas)
        names = self.mech.species_names
        Tc_m = float(x @ self.Tc)
        Pc_m = R_GAS * Tc_m * float(x @ self.Zc) / float(x @ self.Vc)
        MW_m = float(x @ W)
        iH = int(np.argmax(W * (x > 0)))
        iL = int(np.argmin(np.where(x > 0, W, np.inf)))
        FP = FQ = 0.0
        dip = np.asarray(self.tr.dipole)
        for i in range(self.mech.nspec):
            Tr = T / self.Tc[i]
            mu_ri = 52.46 * 1e5 * dip[i] ** 2 * self.Pc[i] \
                / (self.Tc[i] ** 2)
            if mu_ri < 0.022:
                FP += x[i]
            elif mu_ri < 0.075:
                FP += x[i] * (1 + 30.55 * (0.292 - self.Zc[i]) ** 1.72)
            else:
                FP += x[i] * (1 + 30.55 * (0.292 - self.Zc[i]) ** 1.72
                              * abs(0.96 + 0.1 * (Tr - 0.7)))
            Q = {"He": 1.38, "H2": 0.76, "D2": 0.52}.get(names[i])
            if Q is not None:
                # FQ_i (HighPressureGasTransport.cpp:443-447)
                FQ += x[i] * 1.22 * Q ** 0.15 * (
                    1 + 0.00385 * ((Tr - 12.0) ** 2) ** (1.0 / W[i])
                    * np.sign(Tr - 12.0))
            else:
                FQ += x[i]
        Tr_m = T / Tc_m
        Pr_m = P / Pc_m
        ratio = W[iH] / W[iL]
        # the 3.6277e53 constant is tuned for R in J/kmol/K and MW in
        # g/mol (Cantera's GasConstant convention)
        ksi = (R_GAS * 1e3 * Tc_m * 3.6277e53
               / (MW_m ** 3 * Pc_m ** 4)) ** (1.0 / 6.0)
        if ratio > 9 and 0.05 < x[iH] < 0.7:
            FQ *= 1 - 0.01 * ratio ** 0.87
        Z1 = (0.807 * Tr_m ** 0.618 - 0.357 * np.exp(-0.449 * Tr_m)
              + 0.340 * np.exp(-4.058 * Tr_m) + 0.018) * FP * FQ
        if Tr_m <= 1.0:
            raise ValueError("Lucas model limit: Tr_mix <= 1")
        if not (0.0 < Pr_m <= 100.0):
            raise ValueError("Lucas model limit: Pr_mix outside (0, 100]")
        a_f = 0.001245 * np.exp(5.1726 * Tr_m ** -0.3286) / Tr_m
        b_f = a_f * (1.6553 * Tr_m - 1.2723)
        c_f = 0.4489 * np.exp(3.0578 * Tr_m ** -37.7332) / Tr_m
        d_f = 1.7368 * np.exp(2.2310 * Tr_m ** -7.6351) / Tr_m
        f_f = 0.9425 * np.exp(-0.1853 * Tr_m ** 0.4489)
        Z2 = Z1 * (1 + a_f * Pr_m ** 1.3088
                   / (b_f * Pr_m ** f_f
                      + 1.0 / (1 + c_f * Pr_m ** d_f)))
        Y = Z2 / Z1
        FP_c = (1 + (FP - 1) * Y ** -3) / FP
        FQ_c = (1 + (FQ - 1) * (1.0 / Y - 0.007 * np.log(Y) ** 4)) / FQ
        return Z2 * FP_c * FQ_c / ksi

    def thermal_conductivity(self, T, P, x, cp0_R, V_k=None):
        """Ely-Hanley method (thermalConductivity:33-121)."""
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        x = x / x.sum()
        n = self.mech.nspec
        W = np.asarray(self.mech.mol_weights)
        if V_k is None:
            V_k = np.full(n, R_GAS * T / P)
        c1 = 1.0 / 16.04
        L_i = np.zeros(n)
        f_i = np.zeros(n)
        h_i = np.zeros(n)

        def mu0_ref(T0):
            p = [2.90774e6, -3.31287e6, 1.60810e6, -4.33190e5, 7.06248e4,
                 -7.11662e3, 4.32517e2, -1.44591e1, 2.03712e-1]
            return 1e-7 * sum(p[k] * T0 ** ((k - 3) / 3.0)
                              for k in range(9))

        for i in range(n):
            Tr = T / self.Tc[i]
            Vr = V_k[i] / self.Vc[i]
            Tp = min(Tr, 2.0)
            Vp = max(0.5, min(Vr, 2.0))
            th_p = 1.0 + (self.w_ac[i] - 0.011) \
                * (0.56553 - 0.86276 * np.log(Tp) - 0.69852 / Tp)
            ph_p = (1.0 + (self.w_ac[i] - 0.011)
                    * (0.38560 - 1.1617 * np.log(Tp))) * 0.288 / self.Zc[i]
            f_fac = self.Tc[i] * th_p / 190.4
            # Vc enters in m^3/kmol (Cantera SI): self.Vc is m^3/mol
            h_fac = 1000 * (self.Vc[i] * 1e3) * ph_p / 99.2
            mu0 = mu0_ref(T / f_fac)
            H = np.sqrt(f_fac * 16.04 / (W[i] * 1e3)) * h_fac ** (-2. / 3.)
            mu_i = mu0 * H * W[i] * 1e3 * c1
            L_i[i] = mu_i * 1.32 * R_GAS * (cp0_R[i] - 2.5) / W[i]
            th_s = 1 + (self.w_ac[i] - 0.011) \
                * (0.09057 - 0.86276 * np.log(Tp)
                   + (0.31664 - 0.46568 / Tp) * (Vp - 0.5))
            ph_s = (1 + (self.w_ac[i] - 0.011)
                    * (0.39490 * (Vp - 1.02355)
                       - 0.93281 * (Vp - 0.75464) * np.log(Tp))) \
                * 0.288 / self.Zc[i]
            f_i[i] = self.Tc[i] * th_s / 190.4
            h_i[i] = 1000 * (self.Vc[i] * 1e3) * ph_s / 99.2

        Lp = 0.0
        f_m = h_m = mw_m = 0.0
        for i in range(n):
            for j in range(n):
                L_ij = 2 * L_i[i] * L_i[j] / (L_i[i] + L_i[j] + 1e-300)
                Lp += x[i] * x[j] * L_ij
                f_ij = np.sqrt(f_i[i] * f_i[j])
                h_ij = 0.125 * (h_i[i] ** (1. / 3.)
                                + h_i[j] ** (1. / 3.)) ** 3
                mw_inv = (W[i] + W[j]) * 1e3 / (2 * W[i] * W[j] * 1e6)
                f_m += x[i] * x[j] * f_ij * h_ij
                h_m += x[i] * x[j] * h_ij
                mw_m += x[i] * x[j] * np.sqrt(mw_inv * f_ij) \
                    * h_ij ** (-4. / 3.)
        f_m /= h_m
        mw_m = mw_m ** -2.0 * f_m * h_m ** (-8. / 3.)
        Vm = float(x @ V_k) * 1e3          # m^3/kmol
        rho0 = 16.04 * h_m / (1000 * Vm)
        T0 = T / f_m
        mu0 = mu0_ref(T0)
        L1 = 1944 * mu0
        L2 = (-2.5276e-4 + 3.3433e-4 * (1.12 - np.log(T0 / 168.0)) ** 2) \
            * rho0
        L3 = np.exp(-7.19771 + 85.67822 / T0) \
            * (np.exp((12.47183 - 984.6252 * T0 ** -1.5) * rho0 ** 0.1
                      + (rho0 / 0.1617 - 1) * np.sqrt(rho0)
                      * (0.3594685 + 69.79841 / T0
                         - 872.8833 * T0 ** -2)) - 1.0) * 1e-3
        Hm = np.sqrt(f_m * 16.04 / mw_m) * h_m ** (-2. / 3.)
        return Lp + Hm * (L1 + L2 + L3)
