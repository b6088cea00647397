"""Gas-phase kinetics: rates of progress and net production rates
(counterpart of g4s_tpu/models/cantera/kinetics.py).

Reference semantics (cantera/src/kinetics/GasKinetics.cpp:227 updateROP +
Kinetics.cpp:484 getNetProductionRates):
  kf = A T^b exp(-Ea/RT)                       (Arrhenius)
  three-body: rate *= M = sum_k eff_k c_k
  falloff:    Pr = k0 M / kinf; kf = kinf Pr/(1+Pr) * F  (Lindemann/Troe)
  kr = kf / Kc for reversible reactions, Kc from NASA equilibrium
  rop = kf prod c^nu_r - kr prod c^nu_p
  wdot = (nu_p - nu_r)^T rop                   (the StoichManager mxv)

Every reaction class is evaluated for all reactions with masks, the
concentration products go through the engine's mxv in log space, and the
stoichiometric contraction is the engine's vxm: at mechanism size the
dispatcher stages the three operators as dense ("dense" layout, one
torch.matmul each), as the reference's does. No hand kernel lies on this
path; the reference reaches no Pallas kernel here either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.engine import build_graph, mxv, vxm
from g4s_tpu_torch.models.cantera.mech import Mechanism, P_REF, R_GAS
from g4s_tpu_torch.models.cantera.thermo import as_scalar, h0_RT, s0_R
from g4s_tpu_torch.sparse import dense_to_csr
from g4s_tpu_torch.sparse.containers import resolve_device

_LOG_FLOOR = 1e-300


class KineticsArrays(NamedTuple):
    """Device-resident mechanism arrays (built once).

    The three stoichiometric operators are staged through the graph
    engine (engine.build_graph) so the StoichManager contraction
    (StoichManager.h:63-121) executes whatever layout the dispatcher
    chose — dense at mechanism sizes.
    """
    nu_reac: torch.Tensor
    nu_prod: torch.Tensor
    nu_net: torch.Tensor
    dnu: torch.Tensor
    arr_A: torch.Tensor
    arr_b: torch.Tensor
    arr_Ea: torch.Tensor
    reversible: torch.Tensor
    is_three_body: torch.Tensor
    is_falloff: torch.Tensor
    efficiencies: torch.Tensor
    low_A: torch.Tensor
    low_b: torch.Tensor
    low_Ea: torch.Tensor
    troe: torch.Tensor
    has_troe: torch.Tensor
    is_plog: torch.Tensor
    plog_logP: torch.Tensor
    plog_arr: torch.Tensor
    is_cheb: torch.Tensor
    cheb_coeffs: torch.Tensor
    cheb_Tlim: torch.Tensor
    cheb_Plim: torch.Tensor
    g_reac: object = None       # engine Graph of nu_reac
    g_prod: object = None       # engine Graph of nu_prod
    g_net: object = None        # engine Graph of nu_net


def build_kinetics(mech: Mechanism, dtype=torch.float64, *,
                   device="cuda") -> KineticsArrays:
    device = resolve_device(device)

    def to(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def mask(x):
        return torch.as_tensor(np.asarray(x, bool), device=device)

    def mk(m):
        return build_graph(dense_to_csr(np.asarray(m, np.float64)),
                           device=device, dtype=dtype)

    nu_net = mech.nu_prod - mech.nu_reac
    return KineticsArrays(
        to(mech.nu_reac), to(mech.nu_prod), to(nu_net),
        to(nu_net.sum(axis=1)),
        to(mech.arr_A), to(mech.arr_b), to(mech.arr_Ea),
        mask(mech.reversible), mask(mech.is_three_body),
        mask(mech.is_falloff), to(mech.efficiencies),
        to(mech.low_A), to(mech.low_b), to(mech.low_Ea),
        to(mech.troe), mask(mech.has_troe),
        mask(mech.is_plog), to(mech.plog_logP), to(mech.plog_arr),
        mask(mech.is_cheb), to(mech.cheb_coeffs),
        to(mech.cheb_Tlim), to(mech.cheb_Plim),
        mk(mech.nu_reac), mk(mech.nu_prod), mk(nu_net))


def _arrhenius(A, b, Ea, T, logT):
    return A * torch.exp(b * logT - Ea / (R_GAS * T))


def _clip(x, lo, hi):
    # jnp.clip's form: min(max(x, lo), hi), derivative split at ties
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _floor(x, lo):
    return torch.maximum(x, torch.full_like(x, lo))


def _take(a, idx):
    """a[r, idx[r]] for each row r (take_along_axis on axis 1)."""
    return torch.gather(a, 1, idx)[:, 0]


def forward_rate_constants(kin: KineticsArrays, mech: Mechanism, T, conc):
    """kf for every reaction, including third-body / falloff factors that
    multiply into the effective forward rate."""
    T = as_scalar(T, conc)
    logT = torch.log(T)
    kf = _arrhenius(kin.arr_A, kin.arr_b, kin.arr_Ea, T, logT)

    M = kin.efficiencies @ conc                      # (nrxn,)

    # pure three-body: multiply by M
    kf = torch.where(kin.is_three_body, kf * M, kf)

    # falloff: blend low/high-pressure limits
    k0 = _arrhenius(kin.low_A, kin.low_b, kin.low_Ea, T, logT)
    pr = k0 * M / _floor(kf, 1e-300)
    pr = _floor(pr, 1e-300)
    # Troe broadening
    a, t3, t1, t2 = (kin.troe[:, 0], kin.troe[:, 1], kin.troe[:, 2],
                     kin.troe[:, 3])
    fcent = ((1.0 - a) * torch.exp(-T / _floor(t3, 1e-30))
             + a * torch.exp(-T / _floor(t1, 1e-30))
             + torch.where(t2 > 0.0, torch.exp(-t2 / T),
                           torch.zeros_like(t2)))
    fcent = _clip(fcent, 1e-300, 1.0)
    log_fc = torch.log10(fcent)
    c_t = -0.4 - 0.67 * log_fc
    n_t = 0.75 - 1.27 * log_fc
    lpr = torch.log10(pr)
    f1 = (lpr + c_t) / (n_t - 0.14 * (lpr + c_t))
    log_F = log_fc / (1.0 + f1 * f1)
    F = torch.where(kin.has_troe, torch.pow(10.0, log_F),
                    torch.ones_like(log_F))
    kf_falloff = kf * (pr / (1.0 + pr)) * F
    kf = torch.where(kin.is_falloff, kf_falloff, kf)

    # pressure-dependent classes (present only when the mechanism has
    # them). Pressure from the ideal-gas state the kinetics sees
    # (GasKinetics::update_rates_C).
    if np.any(np.asarray(mech.is_plog)):
        P = torch.sum(conc) * R_GAS * T
        lnP = torch.log(_floor(P, 1e-300))
        # PlogRate.cpp: ln k linear in ln P between bracketing pressures;
        # clamped to the boundary rates outside the table
        lk = (torch.log(kin.plog_arr[:, :, 0])
              + kin.plog_arr[:, :, 1] * logT
              - kin.plog_arr[:, :, 2] / (R_GAS * T))
        maxp = kin.plog_logP.shape[1]
        cnt = torch.sum(kin.plog_logP <= lnP, dim=1)
        ilo = torch.clamp(cnt - 1, 0, max(maxp - 2, 0))[:, None]
        ihi = torch.clamp(ilo + 1, max=maxp - 1)
        lp0 = _take(kin.plog_logP, ilo)
        lp1 = _take(kin.plog_logP, ihi)
        lk0 = _take(lk, ilo)
        lk1 = _take(lk, ihi)
        span = lp1 - lp0
        w = _clip(torch.where(torch.isfinite(span) & (lp1 > lp0),
                              (lnP - lp0) / torch.where(
                                  lp1 > lp0, span, torch.ones_like(span)),
                              torch.zeros_like(span)), 0.0, 1.0)
        kf = torch.where(kin.is_plog, torch.exp(lk0 + w * (lk1 - lk0)), kf)
    if np.any(np.asarray(mech.is_cheb)):
        P = torch.sum(conc) * R_GAS * T
        # ChebyshevRate.cpp: log10 k = sum a_ij Ti(Tred) Tj(Pred)
        Tmin, Tmax = kin.cheb_Tlim[:, 0], kin.cheb_Tlim[:, 1]
        Pmin, Pmax = kin.cheb_Plim[:, 0], kin.cheb_Plim[:, 1]
        tr = ((2.0 / T - 1.0 / Tmin - 1.0 / Tmax)
              / (1.0 / Tmax - 1.0 / Tmin))
        pr_ = ((2.0 * torch.log10(P) - torch.log10(Pmin)
                - torch.log10(Pmax))
               / (torch.log10(Pmax) - torch.log10(Pmin)))
        nT, nP = kin.cheb_coeffs.shape[1], kin.cheb_coeffs.shape[2]

        def _cheb_basis(x, nfun):
            basis = [torch.ones_like(x), x]
            for _ in range(2, nfun):
                basis.append(2.0 * x * basis[-1] - basis[-2])
            return torch.stack(basis[:nfun], dim=-1)   # (nrxn, nfun)

        bt = _cheb_basis(tr, nT)
        bp = _cheb_basis(pr_, nP)
        log10k = torch.einsum("rij,ri,rj->r", kin.cheb_coeffs, bt, bp)
        kf = torch.where(kin.is_cheb, torch.pow(10.0, log10k), kf)
    return kf


def equilibrium_constants(kin: KineticsArrays, mech: Mechanism, T):
    """Kc in concentration units (mol/m^3)^dnu."""
    T = as_scalar(T, kin.dnu)
    g_RT = h0_RT(mech, T) - s0_R(mech, T)            # mu0/(RT) per species
    dG_RT = mxv(kin.g_net, g_RT)                     # engine mxv
    return torch.exp(-dG_RT) * torch.pow(P_REF / (R_GAS * T), kin.dnu)


def rates_of_progress(kin: KineticsArrays, mech: Mechanism, T, conc):
    """(rop_f, rop_r) for all reactions; conc (nspec,) mol/m^3 >= 0."""
    T = as_scalar(T, conc)
    logc = torch.log(_floor(conc, _LOG_FLOOR))
    kf = forward_rate_constants(kin, mech, T, conc)
    # concentration products via the engine's layout choice (mxv in log
    # space) — the StoichManager multiply() role
    rop_f = kf * torch.exp(mxv(kin.g_reac, logc))
    Kc = equilibrium_constants(kin, mech, T)
    kr = torch.where(kin.reversible, kf / _floor(Kc, 1e-300),
                     torch.zeros_like(kf))
    rop_r = kr * torch.exp(mxv(kin.g_prod, logc))
    return rop_f, rop_r


def net_production_rates(kin: KineticsArrays, mech: Mechanism, T, conc):
    """wdot (nspec,) mol/m^3/s — getNetProductionRates.

    The increment/decrementSpecies contraction (Kinetics.cpp:489-492) as
    the engine's vxm: wdot_k = sum_r rop_r nu_net[r, k]."""
    rop_f, rop_r = rates_of_progress(kin, mech, T, conc)
    return vxm(kin.g_net, rop_f - rop_r)
