"""HKFT standard states and variable Debye parameters for aqueous ions
(counterpart of g4s_tpu/models/cantera/hkft.py).

Reference: cantera/src/thermo/PDSS_HKFT.cpp (revised Helgeson-Kirkham-
Flowers equation of state for aqueous species) and WaterProps.cpp
(Bradley-Pitzer relative permittivity, variable A_Debye).

The standard chemical potential mu0(T, P) is one differentiable closed
form,

  mu0 = mu0_tr_pr - s0 (T-Tr) - c1 (T ln(T/Tr) - T + Tr)
        + a1 (p-pr) + a2 ln((PSI+p)/(PSI+pr))
        - c2 [ (1/(T-TH) - 1/(Tr-TH)) (TH-T)/TH
               - T/TH^2 ln(Tr (T-TH) / (T (Tr-TH))) ]
        + (a3 (p-pr) + a4 ln((PSI+p)/(PSI+pr))) / (T-TH)
        - omega_j(T,P) (Z+1) + omega_tr_pr (Z_ref+1)
        + omega_tr_pr Y_ref (T-Tr)                 [PDSS_HKFT::deltaG]

with TH = 228 K, PSI = 2600 bar, Z = -1/eps(T,P), the charge-dependent
omega_j through the Shock g-function (solvent-density dependent) and eps
the Bradley-Pitzer fit; V = dmu0/dP, S = -dmu0/dT and H = mu0 + TS come
from torch.func.grad, through the IAPWS-95 density Newton (water.py).
T and P are tensors or numbers (numbers become f64 tensors on `device`,
"cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.func import grad

from g4s_tpu_torch.models.cantera import water
from g4s_tpu_torch.models.cantera.condensed import _mw, parse_qty
from g4s_tpu_torch.models.cantera.thermo import as_tensors

R = 8314.462618153324
CAL = 4184.0                  # J/kmol per cal/gmol
T_R = 298.15
P_R_BAR = 1.0                 # reference pressure, bar (PDSS_HKFT.cpp:48)
THETA = 228.0
PSI_BAR = 2600.0
NU = 166027.0                 # cal gmol^-1 Angstrom (Born radius constant)
AVOGADRO = 6.02214076e26
E_CHARGE = 1.602176634e-19
EPS0 = 8.854187812773345e-12  # 1/(c^2 mu_0), ct_defs.h:134

# standard entropies of the elements at 298.15 K, J/kmol/K
# (JANAF 4th ed. / Robie & Hemingway, as Cantera's
# data/element-standard-entropies.yaml)
ENTROPY298 = {
    "H": 65340.0, "LI": 29085.0, "C": 5740.0, "N": 95804.5, "O": 102573.5,
    "F": 101394.5, "NA": 51455.0, "MG": 32671.0, "AL": 28275.0,
    "SI": 18820.0, "S": 32056.0, "CL": 111535.0, "K": 64670.0,
    "CA": 41588.0, "FE": 27321.0, "BR": 76103.0, "E": 0.0,
}


def rel_epsilon(T, P, *, device="cuda"):
    """Bradley-Pitzer relative permittivity of water
    (WaterProps.cpp:relEpsilon, the ifunc=0 branch; derivatives by
    torch.func instead of the hand-coded ifunc=1..3)."""
    T, P = as_tensors(T, P, device=device)
    U1, U2, U3 = 3.4279e2, -5.0866e-3, 9.4690e-7
    U4, U5, U6 = -2.0525, 3.1159e3, -1.8289e2
    U7, U8, U9 = -8.0325e3, 4.2142e6, 2.1417
    eps1000 = U1 * torch.exp(U2 * T + U3 * T * T)
    C = U4 + U5 / (U6 + T)
    B = U7 + U8 / T + U9 * T
    pbar = P * 1e-5
    return eps1000 + C * torch.log((B + pbar) / (B + 1000.0))


def _water_density(T, P, rho):
    return water.density(T, P) if rho is None \
        else water.density_at(T, P, rho)


def a_debye(T, P, *, rho=None, device="cuda"):
    """A_Debye(T, P) on the molality scale, kg^1/2 gmol^-1/2
    (WaterProps.cpp:ADebye ifunc=0). The reference clamps P at water's
    saturation pressure where water.py has one; it has none, so P is
    used as given (floored at 0)."""
    T, P = as_tensors(T, P, device=device)
    P_eff = torch.clamp_min(P, 0.0)
    eps = EPS0 * rel_epsilon(T, P_eff)
    dw = _water_density(T, P_eff, rho)      # kg/m^3
    tmp = torch.sqrt(2.0 * AVOGADRO * dw / 1000.0)
    tmp2 = E_CHARGE * E_CHARGE * AVOGADRO / (eps * R * T)
    return tmp * tmp2 * torch.sqrt(tmp2) / (8.0 * math.pi)


def _ag(T):
    return -2.037662 + 5.747000e-3 * T + -6.557892e-6 * T * T


def _bg(T):
    return 6.107361 + -1.074377e-2 * T + 1.268348e-5 * T * T


def _f_func(T, P):
    """PDSS_HKFT::f: the high-T correction; exactly 0 below 155 C."""
    TC = torch.clamp_max(T - 273.15, 355.0)
    pbar = P / 1e5
    # clamp before the fractional power: a negative base in the untaken
    # branch would poison the gradient through torch.where
    T1 = torch.clamp_min((TC - 155.0) / 300.0, 0.0)
    pd = 1000.0 - pbar
    fac2 = -0.1504956e-9 * pd ** 3 + 0.5107997e-13 * pd ** 4
    val = T1 ** 4.8 + 3.666666e1 * T1 ** 16.0 * fac2
    return torch.where((TC < 155.0) | (pbar > 1000.0),
                       torch.zeros_like(val), val)


def g_star(T, P, *, rho=None, device="cuda"):
    """Shock et al. solvent g-function (PDSS_HKFT::gstar = g - f)."""
    T, P = as_tensors(T, P, device=device)
    dens = _water_density(T, P, rho) * 1e-3  # g/cm^3
    gval = _ag(T) * (1.0 - dens) ** _bg(T)
    gval = torch.where(dens >= 1.0, torch.zeros_like(gval), gval)
    return gval - _f_func(T, P)


class HKFTSpecies(NamedTuple):
    name: str
    charge: float
    mw: float                    # kg/kmol
    mu0_tr_pr: float             # J/kmol at (Tr, Pr)
    s0: float                    # cal/gmol/K
    a1: float                    # cal/gmol/bar
    a2: float                    # cal/gmol
    a3: float                    # cal K/gmol/bar
    a4: float                    # cal K/gmol
    c1: float                    # cal/gmol/K
    c2: float                    # cal K/gmol
    omega: float                 # cal/gmol


def load_hkft_species(sp: dict) -> HKFTSpecies:
    """Build from a YAML species entry with equation-of-state: HKFT.

    h0/g0/s0 follow the reference's completion rules
    (PDSS_HKFT::initThermo): with h0+s0, mu0 = h0 - Tr*s0; with g0+s0,
    mu0 = g0 + sum_el n_el*(-Tr*S298_el) - z*(-Tr*S298_H)."""
    eos = sp["equation-of-state"]
    if eos["model"] != "HKFT":
        raise ValueError(f"species {sp['name']!r} has no HKFT eos")
    comp = sp.get("composition", {})
    charge = float(comp.get("E", 0)) * -1.0
    mw = _mw(comp)
    a = eos.get("a", [0, 0, 0, 0])
    c = eos.get("c", [0, 0])

    def qv(v, unit_cal):
        """eos value -> the internal cal-based working units. Strings
        carry their own units; bare numbers are already in cal units."""
        if isinstance(v, str):
            return parse_qty(v) / parse_qty("1 " + unit_cal)
        return float(v)
    a1 = qv(a[0], "cal/gmol/bar")
    a2 = qv(a[1], "cal/gmol")
    a3 = qv(a[2], "cal*K/gmol/bar")
    a4 = qv(a[3], "cal*K/gmol")
    c1 = qv(c[0], "cal/gmol/K")
    c2 = qv(c[1], "cal*K/gmol")
    omega = qv(eos.get("omega", 0.0), "cal/gmol")
    s0 = qv(eos.get("s0", 0.0), "cal/gmol/K")
    h0 = eos.get("h0")
    g0 = eos.get("g0")
    # PDSS_HKFT::initThermo ends with an unconditional
    # convertDGFormation(), so g0 wins whenever it is present; h0 only
    # seeds mu0 when g0 is absent.
    if g0 is not None:
        g0 = qv(g0, "cal/gmol")
        total = sum(n * (-T_R * ENTROPY298[el.upper()])
                    for el, n in comp.items() if n > 0)
        total -= charge * (-T_R * ENTROPY298["H"])
        mu0 = g0 * CAL + total
    else:
        h0 = qv(h0, "cal/gmol")
        mu0 = h0 * CAL - T_R * s0 * CAL
    return HKFTSpecies(sp["name"], charge, mw, mu0, s0, a1, a2, a3, a4,
                       c1, c2, omega)


def hkft_species_from_reference(fields) -> HKFTSpecies:
    """An HKFTSpecies from the reference's (the NamedTuple or a dict of
    its fields); a missing or unknown field raises."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if sorted(fields) != sorted(HKFTSpecies._fields):
        raise KeyError(f"HKFTSpecies fields {sorted(HKFTSpecies._fields)}, "
                       f"got {sorted(fields)}")
    return HKFTSpecies(str(fields["name"]),
                       *(float(fields[k]) for k in HKFTSpecies._fields[1:]))


@functools.lru_cache(maxsize=None)
def _z_y_ref():
    """Z and Y = dZ/dT at (Tr, 1 atm) (PDSS_HKFT::initThermo): two
    numbers, computed once in f64 on the host CPU."""
    T, P = as_tensors(T_R, 101325.0, device="cpu")
    Z = -1.0 / rel_epsilon(T, P)
    Y = grad(lambda t: -1.0 / rel_epsilon(t, P))(T)
    return float(Z), float(Y)


def _omega_j(sp: HKFTSpecies, T, P, rho=None):
    if sp.charge == 0.0:
        return torch.full_like(T, sp.omega)
    r_ref = sp.charge ** 2 / (sp.omega / NU + sp.charge / 3.082)
    gval = g_star(T, P, rho=rho)
    r_e = r_ref + abs(sp.charge) * gval
    return NU * (sp.charge ** 2 / r_e - sp.charge / (3.082 + gval))


@functools.lru_cache(maxsize=None)
def _domega_ref(sp: HKFTSpecies) -> float:
    """domega_j/dT at (Tr, 1 atm), a number per species (the reference's
    otrterm), computed once in f64 on the host CPU."""
    t_r, p_r = as_tensors(T_R, 101325.0, device="cpu")
    rho = water.density(t_r, p_r)
    return float(grad(lambda t: _omega_j(sp, t, p_r, rho))(t_r))


def mu0(sp: HKFTSpecies, T, P, *, rho=None, device="cuda"):
    """Standard chemical potential J/kmol at (T, P): PDSS_HKFT::deltaG
    + m_Mu0_tr_pr, differentiable in (T, P)."""
    Z_ref, Y_ref = _z_y_ref()
    T, P = as_tensors(T, P, device=device)
    pbar = P * 1e-5
    sterm = -sp.s0 * (T - T_R)
    c1term = -sp.c1 * (T * torch.log(T / T_R) - (T - T_R))
    a1term = sp.a1 * (pbar - P_R_BAR)
    a2term = sp.a2 * torch.log((PSI_BAR + pbar) / (PSI_BAR + P_R_BAR))
    c2term = -sp.c2 * ((1.0 / (T - THETA) - 1.0 / (T_R - THETA))
                       * (THETA - T) / THETA
                       - T / (THETA * THETA)
                       * torch.log((T_R * (T - THETA))
                                   / (T * (T_R - THETA))))
    a3term = sp.a3 / (T - THETA) * (pbar - P_R_BAR)
    a4term = sp.a4 / (T - THETA) * torch.log(
        (PSI_BAR + pbar) / (PSI_BAR + P_R_BAR))
    if sp.charge == 0.0:
        omega_j = sp.omega
    else:
        omega_j = _omega_j(sp, T, P, rho)
    Z = -1.0 / rel_epsilon(T, P)
    wterm = -omega_j * (Z + 1.0)
    wrterm = sp.omega * (Z_ref + 1.0)
    yterm = sp.omega * Y_ref * (T - T_R)
    dg_cal = (sterm + c1term + a1term + a2term + c2term + a3term + a4term
              + wterm + wrterm + yterm)
    return sp.mu0_tr_pr + dg_cal * CAL


def standard_state(sp: HKFTSpecies, T, P, *, rho=None, device="cuda"):
    """(mu0, V0, S0, H0) at (T, P) by torch.func.grad of mu0, the water
    density solved once (or `rho`, solved already) and its derivatives
    those of water.density_at.

    H0 carries the reference's `otrterm` (PDSS_HKFT::deltaH: -T
    domega/dT|ref (Z_ref+1)), a term its hand-derived enthalpy includes
    but its deltaG does not generate under the Gibbs-Helmholtz relation
    (deltaG holds omega_ref constant)."""
    Z_ref, _ = _z_y_ref()
    T, P = as_tensors(T, P, device=device)
    if rho is None:
        rho = water.density(T, P)
    g = mu0(sp, T, P, rho=rho)
    V = grad(lambda p: mu0(sp, T, p, rho=rho))(P)
    S = -grad(lambda t: mu0(sp, t, P, rho=rho))(T)
    H = g + T * S
    if sp.charge != 0.0:
        H = H - T * _domega_ref(sp) * (Z_ref + 1.0) * CAL
    return g, V, S, H
