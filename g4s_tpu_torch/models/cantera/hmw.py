"""HMWSoln: Pitzer-model electrolyte activity coefficients (counterpart
of g4s_tpu/models/cantera/hmw.py).

Reference: cantera/src/thermo/HMWSoln.cpp (MolalityVPSSTP phase with the
Harvie-Moller-Weare formulation of Pitzer's equations: binary beta0/
beta1/beta2/Cphi with alpha1/alpha2, like-charge theta, ternary psi,
with the PITZER_TEMP_COMPLEX1 five-coefficient temperature model,
HMWSoln.cpp:2003-2030). Standard states: liquid water through the
IAPWS-95 EoS (water.py / PDSS_Water), Mu0Poly ("piecewise-Gibbs"),
Shomate over a constant volume, and HKFT (hkft.py).

Unsymmetrical higher-order electrostatic mixing (E-theta/E-theta',
Pitzer 1975's J(x) integral in the reference's closed-form c1..c4
approximation, HMWSoln.cpp calc_lambdas/calc_thetas) acts on like-sign
ions of unequal charge; as in the reference the Debye parameter inside
J(x) is pinned at its 25 C value (aphi = 0.392), so E-theta is T/P-
independent and the derivative sums carry none of it.

Split as the reference's: the loader, the complex-1 coefficients at T
and the Mu0Poly and Shomate standard states are host numpy; the Pitzer
sums, the variable Debye parameter, and the IAPWS and HKFT standard
states run in torch on `device` ("cuda" unless the caller asks for the
CPU), and the results are tensors there.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad

from g4s_tpu_torch.models.cantera import hkft, water
from g4s_tpu_torch.models.cantera.mech import ELEMENT_WEIGHTS, _yaml_load
from g4s_tpu_torch.models.cantera.thermo import as_tensors
from g4s_tpu_torch.sparse.containers import resolve_device

GAS_CONSTANT = 8314.46261815324   # J / kmol / K (Cantera ct_defs.h)
T_PITZER_REF = 298.15

# h0 units of a piecewise-Gibbs species -> J/kmol, matched exactly
# ('kcal/mol' must not fall into a substring-'cal' branch)
H0_UNITS = {"cal/mol": 4184.0, "kcal/mol": 4.184e6, "J/mol": 1e3,
            "kJ/mol": 1e6, "J/kmol": 1.0, "kJ/kmol": 1e3}


def _coeff5(v):
    if isinstance(v, (int, float)):
        return np.array([float(v), 0, 0, 0, 0])
    a = np.asarray([float(x) for x in v], np.float64)
    out = np.zeros(5)
    out[: a.size] = a
    return out


def _eval_complex1(q, T):
    """PITZER_TEMP_COMPLEX1 (HMWSoln.cpp:2003-2030)."""
    tlin = T - T_PITZER_REF
    tquad = T * T - T_PITZER_REF * T_PITZER_REF
    tln = np.log(T / T_PITZER_REF)
    tinv = 1.0 / T - 1.0 / T_PITZER_REF
    return q[..., 0] + q[..., 1] * tlin + q[..., 2] * tquad \
        + q[..., 3] * tinv + q[..., 4] * tln


def _eval_complex1_dT(q, T):
    """d/dT of _eval_complex1."""
    return q[..., 1] + 2.0 * q[..., 2] * T - q[..., 3] / (T * T) \
        + q[..., 4] / T


class Mu0Poly(NamedTuple):
    """Piecewise-Gibbs standard state (src/thermo/Mu0Poly.cpp): constant
    cp on each knot interval, chained from h(T_ref)=h0; extrapolates
    with the end interval's cp. Host numpy."""
    T_knots: np.ndarray
    h_knots: np.ndarray
    s_knots: np.ndarray
    cp: np.ndarray            # per interval

    @staticmethod
    def build(data: dict, h0: float, dimensionless: bool,
              T_ref: float = 298.15) -> "Mu0Poly":
        Ts = np.array(sorted(float(t) for t in data))
        mu0 = np.array([float(v) for _, v in
                        sorted(((float(k), v) for k, v in data.items()))])
        if dimensionless:
            mu0 = mu0 * GAS_CONSTANT * Ts
        i_ref = int(np.argmin(np.abs(Ts - T_ref)))
        n = Ts.size
        h = np.zeros(n)
        s = np.zeros(n)
        cp = np.zeros(max(n - 1, 1))
        h[i_ref] = h0
        s[i_ref] = (h0 - mu0[i_ref]) / Ts[i_ref]
        # forward sweep
        for j in range(i_ref, n - 1):
            dT = Ts[j + 1] - Ts[j]
            lnr = np.log(Ts[j + 1] / Ts[j])
            cp[j] = (mu0[j + 1] - h[j] + Ts[j + 1] * s[j]) \
                / (dT - Ts[j + 1] * lnr)
            h[j + 1] = h[j] + cp[j] * dT
            s[j + 1] = s[j] + cp[j] * lnr
        # backward sweep
        for j in range(i_ref - 1, -1, -1):
            dT = Ts[j] - Ts[j + 1]
            lnr = np.log(Ts[j] / Ts[j + 1])
            cp[j] = (mu0[j] - h[j + 1] + Ts[j] * s[j + 1]) \
                / (dT - Ts[j] * lnr)
            h[j] = h[j + 1] + cp[j] * dT
            s[j] = s[j + 1] + cp[j] * lnr
        return Mu0Poly(Ts, h, s, cp)

    def mu0(self, T: float) -> float:
        j = int(np.clip(np.searchsorted(self.T_knots, T) - 1, 0,
                        max(self.T_knots.size - 2, 0)))
        cp = self.cp[min(j, self.cp.size - 1)]
        hT = self.h_knots[j] + cp * (T - self.T_knots[j])
        sT = self.s_knots[j] + cp * np.log(T / self.T_knots[j])
        return hT - T * sT


class HMWPhase(NamedTuple):
    species_names: tuple
    charge: np.ndarray          # (ns,) solvent first
    Mw_solvent: float           # kg/mol
    A_debye: float
    beta0: np.ndarray           # (ns, ns, 5)
    beta1: np.ndarray
    beta2: np.ndarray
    Cphi: np.ndarray
    alpha1: np.ndarray          # (ns, ns)
    alpha2: np.ndarray
    theta: np.ndarray           # (ns, ns, 5)
    psi: np.ndarray             # (ns, ns, ns, 5)
    mu0_models: tuple           # per species: ("iapws",) | ("mu0poly", ...)
    state_molalities: dict

    @property
    def nspec(self):
        return len(self.species_names)

    def species_index(self, name):
        return self.species_names.index(name)


def _h0_j_per_kmol(raw) -> float:
    """A piecewise-Gibbs species' h0 ("-57433 cal/mol" or a bare number
    in J/kmol) in J/kmol; a unit not in H0_UNITS raises."""
    parts = str(raw).split()
    unit = parts[1] if len(parts) > 1 else "J/kmol"
    if unit not in H0_UNITS:
        raise ValueError(f"h0 {raw!r}: unit {unit!r} is none of "
                         f"{sorted(H0_UNITS)}")
    return float(parts[0]) * H0_UNITS[unit]


def load_hmw(path, phase_name: str) -> HMWPhase:
    doc = _yaml_load(path)
    ph = next(p for p in doc["phases"] if p["name"] == phase_name)
    if ph["thermo"] != "HMW-electrolyte":
        raise ValueError(f"phase {phase_name!r} is not an HMW electrolyte")
    # species may live in named sections of the same file (possibly
    # several, e.g. {HMW-species: [H2O(L)]} + {HKFT-species: [...]})
    names, table = [], {}
    for spec_entry in ph["species"]:
        if isinstance(spec_entry, dict):
            section, sec_names = next(iter(spec_entry.items()))
            sec_table = {s["name"]: s for s in doc[section]}
            if sec_names == "all":
                sec_names = [s["name"] for s in doc[section]]
        else:
            sec_names = [spec_entry]
            sec_table = {s["name"]: s for s in doc["species"]}
        for n in sec_names:
            names.append(n)
            table[n] = sec_table[n]
    ns = len(names)
    charge = np.zeros(ns)
    mu0_models = []
    for i, nm in enumerate(names):
        sp = table[nm]
        charge[i] = -sp["composition"].get("E", 0.0)
        eos = sp.get("equation-of-state", {})
        th = sp.get("thermo", {})
        if eos.get("model") == "liquid-water-IAPWS95":
            mu0_models.append(("iapws",))
        elif eos.get("model") == "HKFT":
            mu0_models.append(("hkft", hkft.load_hkft_species(sp)))
        elif th.get("model") == "piecewise-Gibbs":
            # constant-volume PDSS: mu0(T,P) = mu0_ref(T) + V (P - Pref)
            # (PDSS_ConstVol.cpp; molar-volume in m^3/kmol, Pref from
            # the species' reference-pressure, default 1 bar)
            vol = float(eos.get("molar-volume", 0.0))
            pref = th.get("reference-pressure",
                          eos.get("reference-pressure", "1 bar"))
            pref = 1e5 if str(pref).strip() in ("1 bar", "1bar") \
                else float(str(pref).split()[0])
            h0 = _h0_j_per_kmol(th.get("h0", 0.0))
            mu0_models.append(("mu0poly", Mu0Poly.build(
                th["data"], h0,
                bool(th.get("dimensionless", False))), vol, pref))
        elif th.get("model") == "Shomate":
            # NIST Shomate standard state over a constant-volume PDSS
            # (ShomatePoly2.h semantics: t = T/1000, h in kJ/mol,
            # s in J/mol/K)
            vol = float(eos.get("molar-volume", 0.0))
            coeffs = np.asarray(th["data"], np.float64)
            tr = [float(t) for t in th["temperature-ranges"]]
            mu0_models.append(("shomate", coeffs, tr, vol, 1e5))
        else:
            mu0_models.append(("none",))
    act = ph["activity-data"]
    A_debye = act["A_Debye"]
    if isinstance(A_debye, str):
        if A_debye.strip() == "variable":
            A_debye = float("nan")      # computed from WaterProps at (T,P)
        else:
            A_debye = float(A_debye.split()[0])
    idx = {nm: i for i, nm in enumerate(names)}
    b0 = np.zeros((ns, ns, 5))
    b1 = np.zeros((ns, ns, 5))
    b2 = np.zeros((ns, ns, 5))
    cph = np.zeros((ns, ns, 5))
    a1 = np.full((ns, ns), 2.0)
    a2 = np.full((ns, ns), 12.0)
    th_ = np.zeros((ns, ns, 5))
    psi = np.zeros((ns, ns, ns, 5))
    for inter in act.get("interactions", []):
        sp = [idx[s] for s in inter["species"]]
        if len(sp) == 2:
            i, j = sp
            for tgt, key in ((b0, "beta0"), (b1, "beta1"), (b2, "beta2"),
                             (cph, "Cphi")):
                if key in inter:
                    tgt[i, j] = tgt[j, i] = _coeff5(inter[key])
            if "alpha1" in inter:
                a1[i, j] = a1[j, i] = float(inter["alpha1"])
            if "alpha2" in inter:
                a2[i, j] = a2[j, i] = float(inter["alpha2"])
            if "theta" in inter:
                th_[i, j] = th_[j, i] = _coeff5(inter["theta"])
        elif len(sp) == 3:
            c5 = _coeff5(inter["psi"])
            for p in itertools.permutations(sp):
                psi[p] = c5
    state = ph.get("state", {})
    # solvent molar mass from Cantera's element weights (H 1.008,
    # O 15.999 -> 18.015 g/mol), NOT the IAPWS EoS value 18.015268:
    # getMolalities' 1/Mw uses the phase's element-derived weight
    comp0 = table[names[0]]["composition"]
    Mw = sum(ELEMENT_WEIGHTS[el] * n for el, n in comp0.items()
             if el != "E")          # ELEMENT_WEIGHTS already kg/mol
    return HMWPhase(tuple(names), charge, Mw, float(A_debye),
                    b0, b1, b2, cph, a1, a2, th_, psi, tuple(mu0_models),
                    dict(state.get("molalities", {})))


def _model_from_reference(mdl):
    kind = str(mdl[0])
    if kind in ("iapws", "none"):
        return (kind,)
    if kind == "hkft":
        return (kind, hkft.hkft_species_from_reference(mdl[1]))
    if kind == "mu0poly":
        poly = mdl[1]._asdict() if hasattr(mdl[1], "_asdict") else mdl[1]
        if sorted(poly) != sorted(Mu0Poly._fields):
            raise KeyError(f"Mu0Poly fields {sorted(Mu0Poly._fields)}, got "
                           f"{sorted(poly)}")
        return (kind, Mu0Poly(*(np.array(poly[k], np.float64)
                                for k in Mu0Poly._fields)),
                float(mdl[2]), float(mdl[3]))
    if kind == "shomate":
        return (kind, np.array(mdl[1], np.float64),
                [float(t) for t in mdl[2]], float(mdl[3]), float(mdl[4]))
    raise KeyError(f"unknown standard-state model {kind!r}")


def hmw_from_reference(fields) -> HMWPhase:
    """An HMWPhase from the reference's (the NamedTuple or a dict of its
    fields, arrays as numpy), its Mu0Poly and HKFTSpecies standard states
    carried across; a missing or unknown field or model raises."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if sorted(fields) != sorted(HMWPhase._fields):
        raise KeyError(f"HMWPhase fields {sorted(HMWPhase._fields)}, got "
                       f"{sorted(fields)}")
    f = dict(fields)
    for k in ("charge", "beta0", "beta1", "beta2", "Cphi", "alpha1",
              "alpha2", "theta", "psi"):
        f[k] = np.array(f[k], np.float64)
    f["species_names"] = tuple(str(s) for s in f["species_names"])
    f["Mw_solvent"] = float(f["Mw_solvent"])
    f["A_debye"] = float(f["A_debye"])
    f["mu0_models"] = tuple(_model_from_reference(m)
                            for m in f["mu0_models"])
    f["state_molalities"] = {str(k): float(v)
                             for k, v in f["state_molalities"].items()}
    return HMWPhase(**f)


def _g(x):
    x = torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)
    return 2.0 * (1.0 - (1.0 + x) * torch.exp(-x)) / (x * x)


def _gprime(x):
    """gp(x) = -2(1-(1+x+x^2/2)e^-x)/x^2, with B' = [b1 gp(a1 sqrt I) +
    b2 gp(a2 sqrt I)] / I."""
    x = torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)
    return -2.0 * (1.0 - (1.0 + x + 0.5 * x * x) * torch.exp(-x)) / (x * x)


def _molalities(ph: HMWPhase, molalities, device):
    if molalities is None:
        m = np.zeros(ph.nspec)
        for k, v in ph.state_molalities.items():
            m[ph.species_index(k)] = float(v)
        molalities = m
    if isinstance(molalities, torch.Tensor):
        return molalities
    return torch.as_tensor(np.asarray(molalities, np.float64),
                           device=resolve_device(device))


def _stage(a, like):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)


def activity_all(ph: HMWPhase, molalities=None, T: float = 298.15,
                 P: float = 101325.0, *, rho_water=None, device="cuda"):
    """Molality activity coefficients, activities, osmotic coefficient.

    Returns a dict of tensors on the molalities' device: acMol (solvent
    slot = a_w / x_w), activities (solvent a_w, solutes gamma*m),
    molalities (solvent slot = 1/Mw_solvent), mole fractions.
    Formulas: Pitzer 1991 / HMWSoln.cpp s_updatePitzer_lnMolalityActCoeff.
    `rho_water`, the water density already solved at (T, P), spares the
    variable Debye parameter its solve.
    """
    m = _molalities(ph, molalities, device)
    T, P = float(T), float(P)
    Aphi = _aphi(ph, T, P, m.device, rho_water)
    coeffs = tuple(_stage(_eval_complex1(q, T), m) for q in
                   (ph.beta0, ph.beta1, ph.beta2, ph.Cphi, ph.theta,
                    ph.psi))
    ln_g, phi_sum = _pitzer_terms(ph, m, coeffs, Aphi, with_etheta=True)

    z = _stage(ph.charge, m)
    solute = torch.arange(ph.nspec, device=m.device) != 0
    msum = torch.sum(m[1:])
    I = 0.5 * torch.sum(m * z * z)

    phi = 1.0 + (2.0 / msum) * phi_sum
    a_w = torch.exp(-phi * msum * ph.Mw_solvent)
    x_w = (1.0 / ph.Mw_solvent) / (1.0 / ph.Mw_solvent + msum)
    mf = torch.where(solute, m * x_w * ph.Mw_solvent, x_w)
    acMol = torch.where(solute, torch.exp(ln_g), a_w / x_w)
    activities = torch.where(solute, torch.exp(ln_g) * m, a_w)
    moll = torch.where(solute, m, torch.full_like(m, 1.0 / ph.Mw_solvent))
    return {"acMol": acMol, "activities": activities, "molalities": moll,
            "mole_fractions": mf, "osmotic": phi, "a_w": a_w,
            "ionic_strength": I}


def _aphi(ph: HMWPhase, T: float, P: float, device, rho=None):
    """A^phi = A_Debye/3, constant or variable (WaterProps::ADebye)."""
    if np.isnan(ph.A_debye):
        return hkft.a_debye(T, P, rho=rho, device=device) / 3.0
    return ph.A_debye / 3.0


def _etheta_matrices(z: np.ndarray, I, like):
    """E-theta(i,j) and E-theta'(i,j) = d(E-theta)/dI species-pair
    matrices for like-sign ions (zero for opposite signs and for equal
    |z|, where the combination cancels exactly), zero where I < 1e-150.

    HMWSoln.cpp calc_lambdas (Pitzer 1975 closed-form approximation of
    the J(x) electrostatic integral; aphi pinned at the 25 C value 0.392
    as in the reference) + calc_thetas (Pitzer 1987):

      x_mn    = 6 z_m z_n aphi sqrt(I)
      J(x)    = x / (4 + c1 x^-c2 exp(-c3 x^c4))
      lam_mn  = z_m z_n J(x)/(4I);  lam'_mn = d(lam)/dI
      Etheta  = lam_mn - (m/2n) lam_nn - (n/2m) lam_mm
    """
    c1, c2, c3, c4 = 4.581, 0.7237, 0.0120, 0.528
    aphi = 0.392
    tiny = I < 1e-150
    I = torch.where(tiny, torch.ones_like(I), I)
    zp = torch.arange(1, 17, dtype=like.dtype, device=like.device)
    x = 6.0 * zp * aphi * torch.sqrt(I)
    jf = x / (4.0 + c1 * x ** -c2 * torch.exp(-c3 * x ** c4))
    t = c3 * c4 * x ** c4
    dj = c1 * x ** (-c2 - 1.0) * (c2 + t) * torch.exp(-c3 * x ** c4)
    jp = (jf / x) * (1.0 + jf * dj)
    zero = torch.zeros(1, dtype=like.dtype, device=like.device)
    elam = torch.cat([zero, zp * jf / (4.0 * I)])
    elam1 = torch.cat([zero, (3.0 * zp ** 2 * aphi * jp
                              / (4.0 * torch.sqrt(I)) - elam[1:]) / I])
    zi = np.abs(z).astype(np.int64)
    like_sign = _stage(z[:, None] * z[None, :] > 0, like) > 0
    i_ = np.maximum(zi, 1)[:, None]
    j_ = np.maximum(zi, 1)[None, :]
    f1 = _stage(i_ / (2.0 * j_), like)
    f2 = _stage(j_ / (2.0 * i_), like)
    ij, jj, ii = (torch.as_tensor(np.clip(a, 0, 16), device=like.device)
                  for a in (i_ * j_, np.broadcast_to(j_ * j_, (zi.size,) * 2),
                            np.broadcast_to(i_ * i_, (zi.size,) * 2)))
    keep = like_sign & ~tiny
    ETH = torch.where(keep, elam[ij] - f1 * elam[jj] - f2 * elam[ii], 0.0)
    ETHP = torch.where(keep, elam1[ij] - f1 * elam1[jj] - f2 * elam1[ii],
                       0.0)
    return ETH, ETHP


def _pitzer_terms(ph: HMWPhase, m, coeffs, Aphi, with_etheta=False):
    """The Pitzer sums (HMWSoln.cpp s_updatePitzer_lnMolalityActCoeff):
    returns (ln_gamma solutes vector, phi_sum with phi = 1 +
    (2/msum) phi_sum). Linear in (Aphi, B0, B1, B2, CPH, TH, PSI) at
    fixed molalities, so temperature/pressure derivatives of ln_gamma
    are the same sums evaluated at the coefficient derivatives. The
    reference's loops over ion pairs and triples are masked einsums
    here; the masks come from the charges on the host. `with_etheta` adds
    the unsymmetrical E-theta terms (base evaluation only)."""
    B0, B1, B2, CPH, TH, PSI = coeffs
    ns = ph.nspec
    zh = np.asarray(ph.charge, np.float64)
    z = _stage(zh, m)
    solute = torch.arange(ns, device=m.device) != 0
    I = 0.5 * torch.sum(m * z * z)
    sqI = torch.sqrt(I)
    Z = torch.sum(m * torch.abs(z))
    b = 1.2

    x1 = _stage(ph.alpha1, m) * sqI
    x2 = _stage(ph.alpha2, m) * sqI
    B = B0 + B1 * _g(x1) + B2 * _g(x2)
    Bphi = B0 + B1 * torch.exp(-x1) + B2 * torch.exp(-x2)
    Bprime = (B1 * _gprime(x1) + B2 * _gprime(x2)) / I
    zzh = np.abs(zh[:, None] * zh[None, :])
    C = CPH / _stage(2.0 * np.sqrt(np.where(zzh > 0, zzh, 1.0)), m) \
        * _stage(zzh > 0, m)

    mc = torch.where(z > 0, m, torch.zeros_like(m))
    ma = torch.where(z < 0, m, torch.zeros_like(m))

    if with_etheta:
        ETH, ETHP = _etheta_matrices(zh, I, m)
    else:
        ETH = ETHP = torch.zeros((ns, ns), dtype=m.dtype, device=m.device)

    # F (Pitzer's F function; theta is I-independent, so Phi' = Etheta')
    F = -Aphi * (sqI / (1.0 + b * sqI) + (2.0 / b) * torch.log(1.0 + b * sqI))
    F = F + torch.einsum("i,j,ij->", mc, ma, Bprime)

    # ln gamma for every solute ion i:
    # z_i^2 F + sum_opp m_j (2B_ij + Z C_ij)
    #        + sum_same m_j (2 Phi_ij + sum_opp m_a psi_ija)
    #        + sum over opposite-sign pairs m_j m_k psi_jki
    #        + |z_i| sum_c sum_a m_c m_a C_ca
    zz = zh[:, None] * zh[None, :]
    eye = np.eye(ns, dtype=bool)
    opp = _stage(zz < 0, m)
    same = _stage((zz > 0) & ~eye, m)
    # unsymmetrical-mixing contribution to F: like-sign pair Phi' sums
    F = F + 0.5 * torch.einsum("i,j,ij->", m, m, same * ETHP)
    ln_g = z * z * F
    ln_g = ln_g + torch.einsum("ij,j,ij->i", opp, m, 2.0 * B + Z * C)
    psi_term = torch.einsum("ij,j,ja,a,ija->i", same, m, opp, m, PSI)
    # Phi_ij = theta_ij + Etheta(z_i, z_j)
    ln_g = ln_g + torch.einsum("ij,j,ij->i", same, m, 2.0 * (TH + ETH)) \
        + psi_term
    # for ion i, the pairs j < k of ions both opposite in sign to i
    jk = np.triu(np.ones((ns, ns), dtype=bool), 1)
    pair = (jk[:, :, None] & (zz[:, :, None] > 0)
            & (zz[:, None, :] < 0) & (zz.T[None, :, :] < 0)
            & (zh[None, None, :] != 0))
    ln_g = ln_g + torch.einsum("jki,j,k,jki->i", _stage(pair, m), m, m, PSI)
    ln_g = ln_g + torch.abs(z) * torch.einsum("i,j,ij->", mc, ma, C)
    ln_g = torch.where(solute, ln_g, torch.zeros_like(ln_g))

    # osmotic coefficient
    phi_sum = -Aphi * I ** 1.5 / (1.0 + b * sqI)
    phi_sum = phi_sum + torch.einsum("i,j,ij->", mc, ma, Bphi + Z * C)
    # like-sign pairs i < j (Phi^phi = theta + Etheta + I Etheta') and
    # their psi sums over the ions a of the other sign
    inner = TH + ETH + I * ETHP + torch.einsum("ia,a,ija->ij", opp, m, PSI)
    phi_sum = phi_sum + torch.einsum(
        "ij,i,j,ij->", _stage(jk & (zz > 0), m), m, m, inner)
    return ln_g, phi_sum


def _shomate_hs(coeffs: np.ndarray, tr, T: float):
    """(h [J/kmol], s [J/kmol/K]) from NIST Shomate rows."""
    r = 0
    while r + 1 < len(coeffs) and r + 2 < len(tr) and T > tr[r + 1]:
        r += 1
    A, B, C, D, E, F, G = coeffs[r]
    t = T / 1000.0
    h = (A * t + B * t * t / 2 + C * t ** 3 / 3 + D * t ** 4 / 4
         - E / t + F) * 1e6              # kJ/mol -> J/kmol
    s = (A * np.log(t) + B * t + C * t * t / 2 + D * t ** 3 / 3
         - E / (2 * t * t) + G) * 1e3    # J/mol/K -> J/kmol/K
    return h, s


def _water_rho(ph: HMWPhase, T: float, P: float, device):
    """The liquid water density at (T, P) when a model of the phase reads
    it (variable A_Debye, IAPWS water, HKFT), solved once; else None."""
    if np.isnan(ph.A_debye) or any(mdl[0] in ("iapws", "hkft")
                                   for mdl in ph.mu0_models):
        return water.density(T, P, device=device)
    return None


def _water_mu0(T, rho):
    """WaterStandardState.mu0 at a solved density."""
    h = water.enthalpy_mole(T, rho) + water.WaterStandardState.EW_OFFSET
    s = water.entropy_mole(T, rho) + water.WaterStandardState.SW_OFFSET
    return h - T * s


def standard_chem_potentials(ph: HMWPhase, T: float, P: float = 101325.0,
                             *, device="cuda"):
    """mu0 per species [J/kmol] (getStandardChemPotentials), a tensor on
    `device`."""
    dev = resolve_device(device)
    T, P = float(T), float(P)
    rho = _water_rho(ph, T, P, dev)
    out = []
    for mdl in ph.mu0_models:
        if mdl[0] == "iapws":
            out.append(_water_mu0(T, rho))
        elif mdl[0] == "hkft":
            out.append(hkft.mu0(mdl[1], T, P, rho=rho, device=dev))
        else:
            out.append(as_tensors(_host_mu0(mdl, T, P), device=dev)[0])
    return torch.stack(out)


def _host_mu0(mdl, T, P) -> float:
    if mdl[0] == "mu0poly":
        return mdl[1].mu0(T) + mdl[2] * (P - mdl[3])
    if mdl[0] == "shomate":
        h, s = _shomate_hs(mdl[1], mdl[2], T)
        return h - T * s + mdl[3] * (P - mdl[4])
    return 0.0


def _standard_states(ph: HMWPhase, T: float, P: float, device, rho=None):
    """(mu0, V0, S0, H0) tensors over species [Cantera SI] on `device`;
    `rho` is the water density at (T, P) when a model reads it."""
    rows = []
    for mdl in ph.mu0_models:
        if mdl[0] == "iapws":
            mu0 = _water_mu0(T, rho)
            # PDSS_Water::molarVolume uses the IAPWS molar mass
            # (18.015268), not the phase's element-derived 18.015
            V0 = water.M_WATER / rho
            H0 = water.enthalpy_mole(T, rho) + \
                water.WaterStandardState.EW_OFFSET
            rows.append((mu0, V0, (H0 - mu0) / T, H0))
        elif mdl[0] == "hkft":
            rows.append(hkft.standard_state(mdl[1], T, P, rho=rho,
                                            device=device))
        elif mdl[0] == "mu0poly":
            mu0 = _host_mu0(mdl, T, P)
            # the reference takes the piecewise model's entropy by a
            # central difference of h = 1e-3 K
            h = 1e-3
            S0 = -(mdl[1].mu0(T + h) - mdl[1].mu0(T - h)) / (2 * h)
            rows.append(as_tensors(mu0, mdl[2], S0, mu0 + T * S0,
                                   device=device))
        elif mdl[0] == "shomate":
            h, s = _shomate_hs(mdl[1], mdl[2], T)
            # H carries the constant-volume delta(pV) term so that
            # G = H - T*S holds across branches (PDSS_ConstVol)
            rows.append(as_tensors(h - T * s + mdl[3] * (P - mdl[4]),
                                   mdl[3], s, h + mdl[3] * (P - mdl[4]),
                                   device=device))
        else:
            rows.append(as_tensors(0.0, 0.0, 0.0, 0.0, device=device))
    return tuple(torch.stack(col) for col in zip(*rows))


def partial_molar_props(ph: HMWPhase, T: float = 298.15,
                        P: float = 101325.0, molalities=None, *,
                        device="cuda"):
    """Mole-fraction activity coefficients, partial molar volumes and
    enthalpies (HMWSoln::getActivityCoefficients /
    getPartialMolarVolumes / getPartialMolarEnthalpies), tensors on the
    molalities' device.

        vbar_k = V0_k + RT  dln(gamma_k)/dP
        hbar_k = H0_k - RT^2 dln(gamma_k)/dT

    The Pitzer sums are linear in the interaction coefficients and in
    A^phi, so the T/P derivatives are the same sums evaluated at the
    coefficient derivatives (d/dT of the complex-1 model; dA/dT, dA/dP
    by torch.func.grad of the variable Debye parameter through the IAPWS
    density and the Bradley-Pitzer permittivity; the density is solved
    once and differentiated as water.density_at). Solvent slots use
    ln(gamma_o) = -phi m_sum M_o - ln x_w."""
    m = _molalities(ph, molalities, device)
    T, P = float(T), float(P)
    dev = m.device
    solute = torch.arange(ph.nspec, device=dev) != 0
    msum = torch.sum(m[1:])

    rho = _water_rho(ph, T, P, dev)
    base = activity_all(ph, m, T, P, rho_water=rho)
    coeffs_dT = tuple(_stage(_eval_complex1_dT(q, T), m) for q in
                      (ph.beta0, ph.beta1, ph.beta2, ph.Cphi, ph.theta,
                       ph.psi))
    zeros = tuple(torch.zeros(q.shape[:-1], dtype=m.dtype, device=dev)
                  for q in (ph.beta0, ph.beta1, ph.beta2, ph.Cphi,
                            ph.theta, ph.psi))
    if np.isnan(ph.A_debye):
        T64, P64 = as_tensors(T, P, device=dev)
        dAphi_dT = grad(lambda t: hkft.a_debye(t, P64, rho=rho))(T64) / 3.0
        dAphi_dP = grad(lambda p: hkft.a_debye(T64, p, rho=rho))(P64) / 3.0
    else:
        dAphi_dT = dAphi_dP = 0.0

    dln_dT, dps_dT = _pitzer_terms(ph, m, coeffs_dT, dAphi_dT)
    dln_dP, dps_dP = _pitzer_terms(ph, m, zeros, dAphi_dP)
    dphi_dT = (2.0 / msum) * dps_dT
    dphi_dP = (2.0 / msum) * dps_dP
    # solvent: ln gamma_o = -phi msum Mw - ln x_w (x_w T,P-independent)
    dln_dT = torch.where(solute, dln_dT, -msum * ph.Mw_solvent * dphi_dT)
    dln_dP = torch.where(solute, dln_dP, -msum * ph.Mw_solvent * dphi_dP)

    mu0, V0, S0, H0 = _standard_states(ph, T, P, dev, rho)
    RT = GAS_CONSTANT * T
    vbar = V0 + RT * dln_dP
    hbar = H0 - RT * T * dln_dT
    # getActivityCoefficients (MolalityVPSSTP): molality-scale gamma
    # divided by the solvent mole fraction for solutes; a_w/x_w solvent
    x_w = (1.0 / ph.Mw_solvent) / (1.0 / ph.Mw_solvent + msum)
    acoeff = torch.where(solute, base["acMol"] / x_w, base["acMol"])
    return {"acoeff": acoeff, "vbar": vbar, "hbar": hbar,
            "acMol": base["acMol"], "mu0": mu0, "V0": V0, "H0": H0,
            "osmotic": base["osmotic"]}
