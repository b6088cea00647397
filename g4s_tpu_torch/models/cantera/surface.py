"""Surface phases + interface kinetics (heterogeneous catalysis);
counterpart of g4s_tpu/models/cantera/surface.py.

Reference: cantera/src/thermo/SurfPhase.cpp (ideal 2-D adsorbate solution:
coverages theta on a fixed site density, standard state = full occupancy)
and cantera/src/kinetics/InterfaceKinetics.cpp (reactions coupling a gas
phase to surface species; sticking-coefficient rates, coverage-dependent
activation, explicit reaction orders). The benchmark mechanisms are the
bundled Deutschmann Pt mechanisms (data/ptcombust.yaml,
methane_pox_on_pt.yaml).

The whole interface ROP is one masked all-reaction evaluation (like the
gas kinetics) over tensors built once on the caller's device
(`load_interface(..., device=)`, default "cuda"), and coverage relaxation
runs through the port's BDF integrator (ops/odeint.bdf_solve). Gas species resolve against an
existing gas `Mechanism` (the cross-file `gri30.yaml/species` reference
in the phase definition), surface species index separately.

Units: YAML files in (cm, mol) convert to SI exactly as
InterfaceKinetics::convert does — gas concentrations mol/m^3, surface
concentrations mol/m^2, rates mol/m^2/s.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.kinetics import _clip, _floor
from g4s_tpu_torch.models.cantera.mech import (Mechanism, P_REF, R_GAS,
                                               _yaml_load)
from g4s_tpu_torch.models.cantera.thermo import h0_RT as gas_h0_RT
from g4s_tpu_torch.models.cantera.thermo import as_scalar, mech_tensor
from g4s_tpu_torch.models.cantera.thermo import s0_R as gas_s0_R
from g4s_tpu_torch.sparse.containers import resolve_device

_CAL2J = 4.184
_COEF_SPECIES = re.compile(r"^(\d+\.?\d*)\s+(.+)$")


@dataclasses.dataclass(eq=False)
class SurfacePhase:
    """Ideal surface solution (SurfPhase). Host numpy; its arrays are
    staged on T's device once (`thermo.mech_tensor`)."""
    name: str
    species_names: tuple
    site_density: float          # Gamma, mol/m^2 (SI)
    sizes: np.ndarray            # sites per adsorbate (n,)
    nasa_low: np.ndarray         # (n, 7)
    nasa_high: np.ndarray
    t_mid: np.ndarray

    @property
    def standard_concentrations(self) -> np.ndarray:
        """Gamma / size_k, mol/m^2."""
        return self.site_density / self.sizes

    @property
    def nspec(self) -> int:
        return len(self.species_names)

    def species_index(self, name: str) -> int:
        return self.species_names.index(name)

    def _nasa(self, T):
        lo = mech_tensor(self, "nasa_low", T)
        hi = mech_tensor(self, "nasa_high", T)
        return torch.where((T < mech_tensor(self, "t_mid", T))[:, None],
                           lo, hi)

    def h0_RT(self, T):
        c = self._nasa(T)
        return (c[:, 0] + c[:, 1] * T / 2 + c[:, 2] * T ** 2 / 3
                + c[:, 3] * T ** 3 / 4 + c[:, 4] * T ** 4 / 5 + c[:, 5] / T)

    def s0_R(self, T):
        c = self._nasa(T)
        return (c[:, 0] * torch.log(T) + c[:, 1] * T + c[:, 2] * T ** 2 / 2
                + c[:, 3] * T ** 3 / 3 + c[:, 4] * T ** 4 / 4 + c[:, 6])

    def concentrations(self, theta):
        """c_k = theta_k * Gamma / size_k (SurfPhase::getConcentrations)."""
        return theta * self.site_density / mech_tensor(self, "sizes", theta)


class InterfaceKinetics(NamedTuple):
    """Device arrays for all interface reactions (built once)."""
    surf: SurfacePhase
    nrxn: int
    nu_reac_g: torch.Tensor      # (nrxn, ngas)
    nu_prod_g: torch.Tensor
    nu_reac_s: torch.Tensor      # (nrxn, nsurf)
    nu_prod_s: torch.Tensor
    ord_g: torch.Tensor          # reaction orders (defaults = nu_reac)
    ord_s: torch.Tensor
    arr: torch.Tensor            # (nrxn, 3) A (SI), b, Ea (J/mol)
    is_sticking: torch.Tensor    # bool
    stick_W: torch.Tensor        # molecular weight of the sticking gas sp.
    stick_m: torch.Tensor        # total surface-site reaction order
    cov_a: torch.Tensor          # (nrxn, nsurf) 10^(a theta) modifier
    cov_m: torch.Tensor          # theta^m modifier
    cov_E: torch.Tensor          # exp(-E theta / RT) modifier (J/mol)
    reversible: torch.Tensor


_IK_ARRAYS = InterfaceKinetics._fields[2:]


def _interface(surf, nr, arrays, device, dtype):
    """InterfaceKinetics from host arrays in _IK_ARRAYS order: floating
    arrays as `dtype` on `device`, bool arrays as bool."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.append(torch.as_tensor(
            a, dtype=dtype if a.dtype.kind == "f" else None, device=device))
    return InterfaceKinetics(surf, int(nr), *out)


def interface_from_reference(fields, *, device="cuda",
                             dtype=torch.float64) -> InterfaceKinetics:
    """An InterfaceKinetics from another loader's: the reference's
    InterfaceKinetics (its SurfacePhase and arrays read as numpy), or a
    dict of its fields with `surf` a dict of SurfacePhase's fields."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if sorted(fields) != sorted(InterfaceKinetics._fields):
        raise KeyError(f"InterfaceKinetics fields "
                       f"{sorted(InterfaceKinetics._fields)}, got "
                       f"{sorted(fields)}")
    sf = fields["surf"]
    if hasattr(sf, "_asdict"):
        sf = sf._asdict()
    surf = SurfacePhase(str(sf["name"]),
                        tuple(str(s) for s in sf["species_names"]),
                        float(sf["site_density"]),
                        *(np.array(sf[k], np.float64) for k in
                          ("sizes", "nasa_low", "nasa_high", "t_mid")))
    return _interface(surf, fields["nrxn"],
                      [np.array(fields[k]) for k in _IK_ARRAYS],
                      resolve_device(device), dtype)


def _parse_side_two(side: str, gas_idx: Dict[str, int], ngas: int,
                    surf_idx: Dict[str, int], nsurf: int):
    nu_g = np.zeros(ngas)
    nu_s = np.zeros(nsurf)
    for term in side.strip().split(" + "):
        term = term.strip()
        if not term:
            continue
        m = _COEF_SPECIES.match(term)
        coef, name = (float(m.group(1)), m.group(2).strip()) if m \
            else (1.0, term)
        if name in surf_idx:
            nu_s[surf_idx[name]] += coef
        elif name in gas_idx:
            nu_g[gas_idx[name]] += coef
        else:
            raise KeyError(f"unknown species {name!r} in {side!r}")
    return nu_g, nu_s


def load_interface(path, gas: Mechanism, *, phase_name: Optional[str] = None,
                   device="cuda", dtype=torch.float64) -> InterfaceKinetics:
    """Build the interface from a YAML file's ideal-surface phase.

    `gas` supplies the adjacent gas phase (the cross-file species
    reference in e.g. ptcombust.yaml's gas phase resolves to gri30)."""
    doc = _yaml_load(path)
    phase = None
    for p in doc.get("phases", []):
        th = str(p.get("thermo", "")).lower()
        if th == "ideal-surface" and (phase_name is None
                                      or p.get("name") == phase_name):
            phase = p
            break
    if phase is None:
        raise KeyError(f"no ideal-surface phase in {path}")

    units = doc.get("units", {})
    length_u = units.get("length", "m")
    qty_u = units.get("quantity", "mol")
    ea_u = units.get("activation-energy", "J/mol")
    ea_factor = {"cal/mol": _CAL2J, "kcal/mol": _CAL2J * 1e3, "J/mol": 1.0,
                 "kJ/mol": 1e3, "K": R_GAS}[ea_u]
    len_factor = {"cm": 1e-2, "m": 1.0}[length_u]
    qty_factor = {"mol": 1.0, "kmol": 1e3}[qty_u]
    # site density in file units (qty/length^2) -> mol/m^2
    gamma = float(phase["site-density"]) * qty_factor / len_factor ** 2
    # concentration units for rate conversion
    cg_unit = qty_factor / len_factor ** 3       # gas conc unit in mol/m^3
    cs_unit = qty_factor / len_factor ** 2       # surf conc unit in mol/m^2

    names = list(phase["species"])
    by_name = {s["name"]: s for s in doc.get("species", [])}
    n = len(names)
    nasa_low = np.zeros((n, 7))
    nasa_high = np.zeros((n, 7))
    t_mid = np.full(n, 1000.0)
    sizes = np.ones(n)
    for i, nm in enumerate(names):
        sp = by_name[nm]
        sizes[i] = float(sp.get("sites", 1.0))
        th = sp["thermo"]
        tr = th["temperature-ranges"]
        data = th["data"]
        if len(data) == 1:
            nasa_low[i] = nasa_high[i] = data[0]
            t_mid[i] = tr[-1]
        else:
            nasa_low[i], nasa_high[i] = data[0], data[1]
            t_mid[i] = tr[1]
    surf = SurfacePhase(phase.get("name", "surface"), tuple(names), gamma,
                        sizes, nasa_low, nasa_high, t_mid)

    gas_idx = {s: i for i, s in enumerate(gas.species_names)}
    surf_idx = {s: i for i, s in enumerate(names)}
    rxns = doc.get("reactions", [])
    nr = len(rxns)
    ngas = gas.nspec
    nu_rg = np.zeros((nr, ngas))
    nu_pg = np.zeros((nr, ngas))
    nu_rs = np.zeros((nr, n))
    nu_ps = np.zeros((nr, n))
    ordg = np.zeros((nr, ngas))
    ords = np.zeros((nr, n))
    arr = np.zeros((nr, 3))
    sticking = np.zeros(nr, bool)
    stick_W = np.ones(nr)
    stick_m = np.zeros(nr)
    cov_a = np.zeros((nr, n))
    cov_m = np.zeros((nr, n))
    cov_E = np.zeros((nr, n))
    reversible = np.zeros(nr, bool)

    for k, rx in enumerate(rxns):
        eq = rx["equation"]
        if "<=>" in eq:
            lhs, rhs = eq.split("<=>")
            reversible[k] = True
        elif "=>" in eq:
            lhs, rhs = eq.split("=>")
        else:
            lhs, rhs = eq.split("=")
            reversible[k] = True
        nu_rg[k], nu_rs[k] = _parse_side_two(lhs, gas_idx, ngas,
                                             surf_idx, n)
        nu_pg[k], nu_ps[k] = _parse_side_two(rhs, gas_idx, ngas,
                                             surf_idx, n)
        ordg[k], ords[k] = nu_rg[k].copy(), nu_rs[k].copy()
        for nm, o in (rx.get("orders") or {}).items():
            if nm in surf_idx:
                ords[k, surf_idx[nm]] = float(o)
            else:
                ordg[k, gas_idx[nm]] = float(o)
        for nm, cd in (rx.get("coverage-dependencies") or {}).items():
            j = surf_idx[nm]
            cov_a[k, j] = float(cd.get("a", 0.0))
            cov_m[k, j] = float(cd.get("m", 0.0))
            cov_E[k, j] = float(cd.get("E", 0.0)) * ea_factor
        if "sticking-coefficient" in rx:
            sticking[k] = True
            rc = rx["sticking-coefficient"]
            arr[k] = [float(rc["A"]), float(rc.get("b", 0.0)),
                      float(rc.get("Ea", 0.0)) * ea_factor]
            # the (single) gas reactant supplies the thermal flux term
            gi = int(np.argmax(nu_rg[k]))
            stick_W[k] = gas.mol_weights[gi]
            stick_m[k] = float((ords[k] * 1.0).sum())
        else:
            rc = rx["rate-constant"]
            # A in file units (length, qty): rate_SI = A_file *
            # cg_unit^(1-sum og) ... exact conversion:
            # A_SI = A_file * cs_unit * cg_unit^(-og) * cs_unit^(-os+... )
            og = float(ordg[k].sum())
            os_ = float(ords[k].sum())
            # rate in file units: mol/len^2/s; SI target mol/m^2/s
            A = float(rc["A"]) * cs_unit * cg_unit ** (-og) \
                * cs_unit ** (-os_)
            arr[k] = [A, float(rc.get("b", 0.0)),
                      float(rc.get("Ea", 0.0)) * ea_factor]

    device = resolve_device(device)
    return _interface(
        surf, nr, [nu_rg, nu_pg, nu_rs, nu_ps, ordg, ords, arr, sticking,
                   stick_W, stick_m, cov_a, cov_m, cov_E, reversible],
        device, dtype)


_LOG_FLOOR = 1e-300




def forward_rate_constants_interface(ik: InterfaceKinetics, gas: Mechanism,
                                     T, theta):
    """kf for every interface reaction (InterfaceKinetics::updateROP):
    Arrhenius or sticking-coefficient form, times the coverage
    modifiers 10^(a theta) theta^m exp(-E theta/RT)."""
    T = as_scalar(T, theta)
    logT = torch.log(T)
    A, b, Ea = ik.arr[:, 0], ik.arr[:, 1], ik.arr[:, 2]
    k_arr = A * torch.exp(b * logT - Ea / (R_GAS * T))
    # sticking: kf = gamma_stick / Gamma_tot^m * sqrt(RT / 2 pi W)
    gam_stick = _clip(k_arr, 0.0, 1.0)
    flux = torch.sqrt(R_GAS * T / (2.0 * math.pi * ik.stick_W))
    k_stick = gam_stick * flux / ik.surf.site_density ** ik.stick_m
    kf = torch.where(ik.is_sticking, k_stick, k_arr)
    # coverage dependence
    lg10 = math.log(10.0)
    mod = torch.exp(torch.sum(ik.cov_a * theta[None, :] * lg10, dim=1)
                    - torch.sum(ik.cov_E * theta[None, :], dim=1)
                    / (R_GAS * T))
    theta_m = torch.exp(torch.sum(
        ik.cov_m * torch.log(_floor(theta, _LOG_FLOOR))[None, :], dim=1))
    return kf * mod * theta_m


def rates_of_progress_interface(ik: InterfaceKinetics, gas: Mechanism,
                                T, conc_gas, theta):
    """(rop_f, rop_r) in mol/m^2/s."""
    T = as_scalar(T, theta)
    kf = forward_rate_constants_interface(ik, gas, T, theta)
    cs = ik.surf.concentrations(_floor(theta, 0.0))
    logcg = torch.log(_floor(conc_gas, _LOG_FLOOR))
    logcs = torch.log(_floor(cs, _LOG_FLOOR))
    rop_f = kf * torch.exp(ik.ord_g @ logcg + ik.ord_s @ logcs)
    # equilibrium: delta G0 over gas + surface; standard concentrations
    # P0/RT (gas) and Gamma/size (surface)
    g_g = gas_h0_RT(gas, T) - gas_s0_R(gas, T)
    g_s = ik.surf.h0_RT(T) - ik.surf.s0_R(T)
    dnu_g = ik.nu_prod_g - ik.nu_reac_g
    dnu_s = ik.nu_prod_s - ik.nu_reac_s
    dG_RT = dnu_g @ g_g + dnu_s @ g_s
    c0_g = P_REF / (R_GAS * T)
    c0_s = mech_tensor(ik.surf, "standard_concentrations", T)
    logKc = -dG_RT - torch.sum(dnu_g, dim=1) * torch.log(1.0 / c0_g) \
        - dnu_s @ torch.log(1.0 / c0_s)
    # note: Kc = exp(-dG0/RT) * prod c0^dnu  ->  logKc = -dG0/RT + sum dnu log c0
    kr = torch.where(ik.reversible, kf / torch.exp(logKc), 0.0)
    rop_r = kr * torch.exp(ik.nu_prod_g @ logcg + ik.nu_prod_s @ logcs)
    return rop_f, rop_r


def net_production_rates_interface(ik: InterfaceKinetics, gas: Mechanism,
                                   T, conc_gas, theta):
    """(sdot_gas mol/m^3-facing mol/m^2/s, dtheta_dt 1/s).

    Site conservation holds by construction: sum_k size_k * nu_net_s[k]
    is zero for every reaction in a valid mechanism, so
    sum(dtheta) = 0."""
    rop_f, rop_r = rates_of_progress_interface(ik, gas, T, conc_gas, theta)
    rop = rop_f - rop_r
    sdot_gas = rop @ (ik.nu_prod_g - ik.nu_reac_g)        # mol/m^2/s
    sdot_surf = rop @ (ik.nu_prod_s - ik.nu_reac_s)       # mol/m^2/s
    dtheta = sdot_surf * mech_tensor(ik.surf, "sizes", theta) \
        / ik.surf.site_density
    return sdot_gas, dtheta


def advance_coverages(ik: InterfaceKinetics, gas: Mechanism, T, conc_gas,
                      theta0, t_end, *, rtol=1e-7, atol=1e-12):
    """Integrate the coverage ODE at fixed gas state
    (InterfaceKinetics::advanceCoverages). T, conc_gas and theta0 (arrays
    or tensors) go to the interface's device, f64."""
    from g4s_tpu_torch.ops.odeint import bdf_solve

    like = ik.arr

    def to(v):
        return torch.as_tensor(v.detach() if torch.is_tensor(v)
                               else np.asarray(v, np.float64),
                               dtype=like.dtype, device=like.device)

    T, conc_gas = to(T), to(conc_gas)

    def rhs(t, th):
        _, dth = net_production_rates_interface(ik, gas, T, conc_gas,
                                                _clip(th, 0.0, 1.0))
        return dth

    res = bdf_solve(rhs, to(theta0), 0.0, t_end, rtol=rtol,
                    atol=atol, max_steps=100000)
    th = _clip(res.y, 0.0, 1.0)
    return th / torch.sum(th), res
