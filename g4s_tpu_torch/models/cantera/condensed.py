"""Condensed phases and excess-Gibbs solution models (counterpart of
g4s_tpu/models/cantera/condensed.py).

Reference: the remaining `src/thermo` phase families of Cantera:
StoichSubstance, IdealSolidSolnPhase, LatticePhase, LatticeSolidPhase,
MargulesVPSSTP, RedlichKisterVPSSTP, MaskellSolidSolnPhase,
IonsFromNeutralVPSSTP, IdealMolalSoln, IdealSolnGasVPSS,
BinarySolutionTabulatedThermo and the electron-cloud `Metal` phase.

Each phase exposes one scalar function, the molar Gibbs energy
g(T, P, composition), and every other property is a torch.func
derivative of it:

    s = -dg/dT        h = g + T s        cp = -T d2g/dT2
    v = dg/dP         mu_k = d(n g)/dn_k

Species standard states follow PDSS_ConstVol/PDSS_SSVol: NASA7, Shomate
(multi-range) and constant-cp reference thermo plus a pressure term
(P - Pref) * v(T), with v from constant-volume or the
density-temperature-polynomial equation of state. A multi-range species
evaluates each range's polynomial and keeps the one whose range holds T
(torch.where), which is the reference's row selection.

The loaders are host code; evaluation takes T, P as tensors or numbers
(numbers become f64 tensors on `device`, "cuda" unless the caller asks
for the CPU) and the composition as a tensor or an array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd

from g4s_tpu_torch.models.cantera.mech import ELEMENT_WEIGHTS, _yaml_load
from g4s_tpu_torch.models.cantera.thermo import as_tensors

R = 8314.462618153324      # J/kmol/K (Avogadro * Boltzmann, ct_defs.h:113)
P_REF = 101325.0           # Pa
ONE_ATM = 101325.0


# ---------------------------------------------------------------------------
# Units: Cantera SI is (J, kmol, m, s, K, Pa)
# ---------------------------------------------------------------------------

_UNIT_SCALE = {
    "J": 1.0, "kJ": 1e3, "cal": 4.184, "kcal": 4184.0,
    "mol": 1e-3, "gmol": 1e-3, "kmol": 1.0, "molec": 1e-3 / 6.02214076e23,
    "m": 1.0, "cm": 1e-2, "mm": 1e-3, "L": 1e-3, "mL": 1e-6,
    "kg": 1.0, "g": 1e-3,
    "K": 1.0, "s": 1.0,
    "Pa": 1.0, "kPa": 1e3, "bar": 1e5, "atm": 101325.0,
}


def parse_qty(v, default: float = 1.0) -> float:
    """'37.57 cm^3/gmol' / '2 bar' / bare number -> Cantera-SI scalar.

    Unit grammar: tokens joined by '/' (everything after the first '/'
    divides), each token optionally '^'-powered. Bare numbers are
    multiplied by `default` (the caller's SI scale for its field)."""
    if isinstance(v, (int, float)):
        return float(v) * default
    parts = str(v).split()
    x = float(parts[0])
    if len(parts) == 1:
        return x * default
    num_den = parts[1].split("/")
    scale = 1.0
    for i, tok in enumerate(num_den):
        if not tok:
            continue
        s = 1.0
        for f in tok.split("*"):
            if "^" in f:
                base, exp = f.split("^")
                s *= _UNIT_SCALE[base] ** float(exp)
            else:
                s *= _UNIT_SCALE[f]
        scale = scale * s if i == 0 else scale / s
    return x * scale


def _mw(composition: dict) -> float:
    """kg/kmol from an elemental composition dict."""
    return 1e3 * sum(ELEMENT_WEIGHTS[el.upper()] * n
                     for el, n in composition.items())


def _like(T, v):
    """The number v as T's kind: a tensor like T, or a float."""
    if isinstance(T, torch.Tensor):
        return torch.full_like(T, float(v))
    return float(v)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


# ---------------------------------------------------------------------------
# Species standard states
# ---------------------------------------------------------------------------


class SpeciesStd(NamedTuple):
    """One species' reference thermo + condensed equation of state."""

    name: str
    mw: float                      # kg/kmol
    charge: float
    kind: str                      # 'nasa7' | 'shomate' | 'const-cp'
    tmids: Tuple[float, ...]       # interior range boundaries
    coeffs: Tuple[Tuple[float, ...], ...]   # one row per range
    v_const: Optional[float]       # m^3/kmol (constant-volume eos)
    rho_poly: Optional[Tuple[float, ...]]   # kg/m^3 = sum c_i T^i

    def _ranged(self, f, T):
        """f(row, T) on the row whose range holds T (the reference's
        row index: the number of interior boundaries below T)."""
        out = f(self.coeffs[0], T)
        for tm, row in zip(self.tmids, self.coeffs[1:]):
            out = torch.where(T > tm, f(row, T), out)
        return out

    def cp0(self, T):
        """J/kmol/K at the reference pressure."""
        if self.kind == "nasa7":
            return self._ranged(lambda a, T: R * (
                a[0] + a[1] * T + a[2] * T ** 2 + a[3] * T ** 3
                + a[4] * T ** 4), T)
        if self.kind == "shomate":
            def f(a, T):
                A, B, Cc, D, E, F, G = a
                t = T / 1000.0
                return 1e3 * (A + B * t + Cc * t ** 2 + D * t ** 3
                              + E / t ** 2)
            return self._ranged(f, T)
        return _like(T, self.coeffs[0][3])

    def h0(self, T):
        """J/kmol at the reference pressure."""
        if self.kind == "nasa7":
            return self._ranged(lambda a, T: R * T * (
                a[0] + a[1] / 2 * T + a[2] / 3 * T ** 2 + a[3] / 4 * T ** 3
                + a[4] / 5 * T ** 4 + a[5] / T), T)
        if self.kind == "shomate":
            def f(a, T):
                A, B, Cc, D, E, F, G = a
                t = T / 1000.0
                return 1e6 * (A * t + B / 2 * t ** 2 + Cc / 3 * t ** 3
                              + D / 4 * t ** 4 - E / t + F)
            return self._ranged(f, T)
        T0, h0, s0, cp0 = self.coeffs[0]
        return h0 + cp0 * (T - T0)

    def s0(self, T):
        """J/kmol/K at the reference pressure."""
        if self.kind == "nasa7":
            return self._ranged(lambda a, T: R * (
                a[0] * torch.log(T) + a[1] * T + a[2] / 2 * T ** 2
                + a[3] / 3 * T ** 3 + a[4] / 4 * T ** 4 + a[6]), T)
        if self.kind == "shomate":
            def f(a, T):
                A, B, Cc, D, E, F, G = a
                t = T / 1000.0
                return 1e3 * (A * torch.log(t) + B * t + Cc / 2 * t ** 2
                              + D / 3 * t ** 3 - E / (2 * t ** 2) + G)
            return self._ranged(f, T)
        T0, h0, s0, cp0 = self.coeffs[0]
        return s0 + cp0 * _log(T / T0)

    def v(self, T):
        """Standard molar volume m^3/kmol (PDSS_ConstVol / PDSS_SSVol)."""
        if self.rho_poly is not None:
            rho = sum(c * T ** i for i, c in enumerate(self.rho_poly))
            return self.mw / rho
        return _like(T, self.v_const if self.v_const is not None else 0.0)

    def g0(self, T, P):
        """Standard chemical potential J/kmol at (T, P)."""
        return self.h0(T) - T * self.s0(T) + (P - P_REF) * self.v(T)


def load_species_std(sp: dict, default_v: Optional[float] = None
                     ) -> SpeciesStd:
    """Build a SpeciesStd from one YAML species entry."""
    th = sp.get("thermo", {}) or {}
    model = str(th.get("model", "constant-cp"))
    charge = float(sp.get("charge", 0) or 0)
    mw = _mw(sp.get("composition", {}))
    if model in ("NASA7", "Shomate"):
        tr = [float(t) for t in th["temperature-ranges"]]
        rows = tuple(tuple(map(float, r)) for r in th["data"])
        tmids = tuple(tr[1:-1])
    elif model == "constant-cp":
        rows = ((float(parse_qty(th.get("T0", 298.15))),
                 parse_qty(th.get("h0", 0.0), 1.0),
                 parse_qty(th.get("s0", 0.0), 1.0),
                 parse_qty(th.get("cp0", 0.0), 1.0)),)
        tmids = ()
    else:
        raise NotImplementedError(f"species thermo model {model}")
    kind = {"NASA7": "nasa7", "Shomate": "shomate",
            "constant-cp": "const-cp"}[model]

    v_const, rho_poly = default_v, None
    eos = sp.get("equation-of-state")
    if eos:
        em = eos.get("model")
        if em == "constant-volume":
            if "molar-volume" in eos:
                v_const = parse_qty(eos["molar-volume"])
            elif "density" in eos:
                v_const = mw / parse_qty(eos["density"])
            elif "molar-density" in eos:
                v_const = 1.0 / parse_qty(eos["molar-density"])
        elif em == "density-temperature-polynomial":
            u = eos.get("units", {})
            sc = _UNIT_SCALE[u.get("mass", "kg")] / \
                _UNIT_SCALE[u.get("length", "m")] ** 3
            rho_poly = tuple(float(c) * sc for c in eos["data"])
            v_const = None
        else:
            raise NotImplementedError(f"species eos {em}")
    return SpeciesStd(sp["name"], mw, charge, kind, tmids, rows,
                      v_const, rho_poly)


def _find_phase(doc: dict, name: str) -> dict:
    for p in doc["phases"]:
        if p["name"] == name:
            return p
    raise KeyError(name)


def _resolve_species(doc: dict, phase: dict) -> list:
    """YAML species list -> species entry dicts (handles the
    {'section': [names...]} and {'section': 'all'} forms)."""
    out = []
    for item in phase["species"]:
        if isinstance(item, str):
            sec, names = "species", [item]
        else:
            (sec, names), = item.items()
        table = {s["name"]: s for s in doc[sec]}
        if names == "all":
            out.extend(doc[sec])
        else:
            out.extend(table[n] for n in names)
    return out


# ---------------------------------------------------------------------------
# Property derivation from one molar-Gibbs closed form
# ---------------------------------------------------------------------------


class Props(NamedTuple):
    g: torch.Tensor          # molar Gibbs J/kmol
    h: torch.Tensor
    s: torch.Tensor
    cp: torch.Tensor
    v: torch.Tensor          # molar volume m^3/kmol
    mu: torch.Tensor         # (nsp,) chemical potentials
    mw_mean: torch.Tensor    # kg/kmol


def _composition(X, like):
    if isinstance(X, torch.Tensor):
        return X.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(X, np.float64), dtype=like.dtype,
                           device=like.device)


def props_from_gibbs(g_fn, T, P, X, mws, *, device="cuda") -> Props:
    """All thermodynamic properties from g(T, P, X) by differentiation."""
    T, P = as_tensors(T, P, device=device)
    X = _composition(X, T)
    g = g_fn(T, P, X)
    s = -grad(g_fn, 0)(T, P, X)
    cp = -T * grad(grad(g_fn, 0), 0)(T, P, X)
    v = grad(g_fn, 1)(T, P, X)

    def total_g(n):
        ntot = torch.sum(n)
        return ntot * g_fn(T, P, n / ntot)
    mu = grad(total_g)(X)
    return Props(g, g + T * s, s, cp, v, mu,
                 torch.dot(X, _composition(mws, T)))


# ---------------------------------------------------------------------------
# The phase models
# ---------------------------------------------------------------------------


class CondensedPhase(NamedTuple):
    """A loaded phase: `kind` selects the gibbs closed form; params hold
    the model-specific constants. Evaluate with `props(phase, T, P, X)`."""

    kind: str
    species: Tuple[SpeciesStd, ...]
    params: dict
    state: dict                    # YAML initial state (T, P, X...)

    @property
    def names(self):
        return tuple(s.name for s in self.species)

    @property
    def mws(self):
        return np.array([s.mw for s in self.species])

    def species_index(self, name):
        return self.names.index(name)


def _g0_vector(species, T, P):
    return torch.stack([s.g0(T, P) for s in species])


def _ideal_gibbs(species, T, P, X):
    """sum_k X_k (g0_k + RT ln X_k) with 0*log(0) guarded to 0."""
    Xs = torch.clamp_min(X, 1e-300)
    return torch.dot(X, _g0_vector(species, T, P) + R * T * torch.log(Xs))


def _margules_ex(inter, T, X):
    """Excess Gibbs of the Margules binary interactions
    (MargulesVPSSTP.cpp:s_update_lnActCoeff's generating function)."""
    ge = 0.0
    for (iA, iB, h0, h1, s0, s1) in inter:
        XA, XB = X[iA], X[iB]
        ge = ge + XA * XB * ((h0 - T * s0) + (h1 - T * s1) * XB)
    return ge


def _redlich_kister_ex(inter, T, X):
    """G_ex = XA XB sum_m A_m(T) (XA - XB)^m (RedlichKisterVPSSTP.cpp)."""
    ge = 0.0
    for (iA, iB, hs, ss) in inter:
        XA, XB = X[iA], X[iB]
        d = XA - XB
        acc, poly = 0.0, 1.0
        for h_m, s_m in zip(hs, ss):
            acc = acc + (h_m - T * s_m) * poly
            poly = poly * d
        ge = ge + XA * XB * acc
    return ge


def _interp(x, xp, fp):
    """jnp.interp for a 0-d x over a sorted grid (ends clamped; a zero
    interval takes its left value)."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, xp.shape[0] - 1)[0]
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (x - xp[i - 1])
                    / torch.where(dx0, torch.ones_like(dx), dx)
                    * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def gibbs_fn(ph: CondensedPhase):
    """The phase's molar-Gibbs closed form g(T, P, X)."""
    sp = ph.species
    kind = ph.kind
    if kind in ("fixed-stoichiometry", "electron-cloud"):
        return lambda T, P, X: torch.dot(X, _g0_vector(sp, T, P))
    if kind in ("ideal-condensed", "lattice", "ideal-solution-VPSS"):
        return lambda T, P, X: _ideal_gibbs(sp, T, P, X)
    if kind == "Margules":
        inter = ph.params["interactions"]
        return lambda T, P, X: (_ideal_gibbs(sp, T, P, X)
                                + _margules_ex(inter, T, X))
    if kind == "Redlich-Kister":
        inter = ph.params["interactions"]
        return lambda T, P, X: (_ideal_gibbs(sp, T, P, X)
                                + _redlich_kister_ex(inter, T, X))
    if kind == "binary-solution-tabulated":
        it = ph.params["tab_index"]

        def g(T, P, X):
            xg = _composition(ph.params["tab_x"], T)
            dh = _interp(X[it], xg, _composition(ph.params["tab_h"], T))
            # BinarySolutionTabulatedThermo.cpp:_updateThermo adds the
            # configurational term R ln(x/(1-x)) to the tabulated entropy
            x = torch.clamp(X[it], 1e-300, 1.0 - 1e-16)
            ds = _interp(X[it], xg, _composition(ph.params["tab_s"], T)) \
                + R * torch.log(x / (1.0 - x))
            return _ideal_gibbs(sp, T, P, X) + X[it] * (dh - T * ds)
        return g
    raise NotImplementedError(kind)


def props(ph: CondensedPhase, T, P, X, *, device="cuda") -> Props:
    return props_from_gibbs(gibbs_fn(ph), T, P, X, ph.mws, device=device)


def density(ph: CondensedPhase, T, P, X, *, device="cuda"):
    """kg/m^3: mean MW over the molar volume.

    LatticePhase: species without their own eos get the site volume
    1/site_density (LatticePhase.cpp standard volumes)."""
    p = props(ph, T, P, X, device=device)
    return p.mw_mean / p.v


def load_phase(path: str, name: str):
    """Load one of the condensed/solution phases from a YAML file."""
    doc = _yaml_load(path)
    phase = _find_phase(doc, name)
    kind = phase["thermo"]
    if kind == "Maskell-solid-solution":
        return _load_maskell(doc, phase)
    if kind == "compound-lattice":
        return _load_compound_lattice(doc, phase, path)
    if kind == "ions-from-neutral-molecule":
        return _load_ions_from_neutral(doc, phase, path)
    if kind == "ideal-molal-solution":
        return _load_ideal_molal(doc, phase)

    default_v = None
    if kind == "lattice":
        site_density = parse_qty(phase["site-density"])     # kmol/m^3
        default_v = 1.0 / site_density
    if kind == "electron-cloud":
        # density fixed by the phase; thermo is the bare electron species
        rho = parse_qty(phase["density"])
        entries = _resolve_species(doc, phase)
        species = tuple(load_species_std(s) for s in entries)
        species = tuple(s._replace(v_const=s.mw / rho) for s in species)
        return CondensedPhase(kind, species, {}, phase.get("state", {}))

    entries = _resolve_species(doc, phase)
    species = tuple(load_species_std(s, default_v) for s in entries)
    params = {}
    if kind == "lattice":
        params["v_site"] = default_v
    if kind in ("Margules", "Redlich-Kister"):
        qscale = _UNIT_SCALE[
            phase.get("units", {}).get("quantity", "kmol")]
        escale = _UNIT_SCALE[phase.get("units", {}).get("energy", "J")]
        per_kmol = escale / qscale
        names = [s.name for s in species]
        inter = []
        for it in phase.get("interactions", []):
            iA, iB = (names.index(n) for n in it["species"])
            he = [parse_qty(h, per_kmol) if isinstance(h, str)
                  else float(h) * per_kmol
                  for h in np.atleast_1d(it.get("excess-enthalpy", [0.0]))]
            se = [parse_qty(s_, per_kmol) if isinstance(s_, str)
                  else float(s_) * per_kmol
                  for s_ in np.atleast_1d(it.get("excess-entropy", [0.0]))]
            if kind == "Margules":
                he = (he + [0.0, 0.0])[:2]
                se = (se + [0.0, 0.0])[:2]
                inter.append((iA, iB, he[0], he[1], se[0], se[1]))
            else:
                n_ = max(len(he), len(se))
                he = he + [0.0] * (n_ - len(he))
                se = se + [0.0] * (n_ - len(se))
                inter.append((iA, iB, tuple(he), tuple(se)))
        params["interactions"] = tuple(inter)
    if kind == "binary-solution-tabulated":
        u = phase.get("units", {})
        per_kmol = _UNIT_SCALE[u.get("energy", "J")] / \
            _UNIT_SCALE[u.get("quantity", "kmol")]
        tab = phase["tabulated-thermo"]
        names = [s.name for s in species]
        params["tab_index"] = names.index(phase["tabulated-species"])
        params["tab_x"] = tuple(float(x) for x in tab["mole-fractions"])
        params["tab_h"] = tuple(float(h) * per_kmol
                                for h in tab["enthalpy"])
        params["tab_s"] = tuple(float(s_) * per_kmol
                                for s_ in tab["entropy"])
    return CondensedPhase(kind, species, params, phase.get("state", {}))


# ---------------------------------------------------------------------------
# Maskell association solid solution
# ---------------------------------------------------------------------------


def _load_maskell(doc, phase) -> CondensedPhase:
    entries = _resolve_species(doc, phase)
    species = tuple(load_species_std(s) for s in entries)
    names = [s.name for s in species]
    params = {
        # excess-enthalpy strings carry their own units ("5 J/mol")
        "h_mixing": parse_qty(phase.get("excess-enthalpy", 0.0)),
        "product": names.index(phase.get("product-species", names[0])),
    }
    return CondensedPhase("maskell", species, params,
                          phase.get("state", {}))


def maskell_chem_potentials(ph: CondensedPhase, T, P, X, *, device="cuda"):
    """MaskellSolidSolnPhase.cpp:getChemPotentials: the association
    model's closed form (fm, p, s helper functions inlined)."""
    if ph.kind != "maskell":
        raise ValueError(f"not a Maskell phase: {ph.kind}")
    T, P = as_tensors(T, P, device=device)
    X = _composition(X, T)
    ip = ph.params["product"]
    ir = 1 - ip
    hm = ph.params["h_mixing"]
    r = X[ip]
    sv = 1.0 + torch.exp(hm / (R * T))
    fm = (1.0 - torch.sqrt(1.0 - 4.0 * r * (1.0 - r) / sv)) / (2.0 * r)
    pv = (1.0 - 2.0 * r) / torch.sqrt(sv * sv - 4.0 * sv * r
                                      + 4.0 * sv * r * r)
    rfm = r * fm
    dgbar_dr = pv * hm + R * T * torch.log(
        ((1.0 - rfm) ** pv * rfm ** pv * (r - rfm) ** (1.0 - pv) * r)
        / ((1.0 - r - rfm) ** (1.0 + pv) * (1.0 - r)))
    g0 = [s.h0(T) - T * s.s0(T) for s in ph.species]  # Pref standard states
    mu = [None, None]
    mu[ip] = g0[ip] + dgbar_dr
    mu[ir] = g0[ir] - dgbar_dr
    return torch.stack(mu)


# ---------------------------------------------------------------------------
# Compound lattice (LatticeSolidPhase)
# ---------------------------------------------------------------------------


class CompoundLattice(NamedTuple):
    lattices: Tuple[CondensedPhase, ...]
    theta: Tuple[float, ...]
    state: dict

    @property
    def names(self):
        return tuple(n for lat in self.lattices for n in lat.names)


def _load_compound_lattice(doc, phase, path) -> CompoundLattice:
    lats, theta = [], []
    for lname, t in phase["composition"].items():
        sub = _find_phase(doc, lname)
        if sub["thermo"] == "fixed-stoichiometry":
            # a stoichiometric sublattice: single-species lattice whose
            # site volume is the species' own molar volume
            entries = _resolve_species(doc, sub)
            species = tuple(load_species_std(s) for s in entries)
            lats.append(CondensedPhase(
                "lattice", species,
                {"v_site": float(species[0].v(298.15))},
                sub.get("state", {})))
        else:
            lats.append(load_phase(path, lname))
        theta.append(float(t))
    return CompoundLattice(tuple(lats), tuple(theta),
                           phase.get("state", {}))


def compound_lattice_props(cl: CompoundLattice, T, P, Xs, *, device="cuda"):
    """Molar properties of theta-weighted sublattices
    (LatticeSolidPhase.cpp enthalpy_mole etc.; mu per sublattice).

    The reference's unit convention: extensive molar sums run over the
    unnormalized theta (per formula unit) while the mean molecular weight
    is per lattice mole (theta-normalized)."""
    T, P = as_tensors(T, P, device=device)
    h = s = v = mw = 0.0
    mus = []
    for lat, th, X in zip(cl.lattices, cl.theta, Xs):
        p = props(lat, T, P, X)
        # LatticePhase.cpp quirk: enthalpy_mole's pressure term uses the
        # site volume 1/site_density while mu (and partial molar
        # volumes) use the species' own eos volumes
        h_lat = p.h + (P - P_REF) * (lat.params["v_site"] - p.v)
        h = h + th * h_lat
        s = s + th * p.s
        v = v + th * p.v
        mw = mw + th * p.mw_mean
        mus.append(p.mu)
    mw = mw / sum(cl.theta)
    return h, s, v, mw, torch.cat(mus)


# ---------------------------------------------------------------------------
# Ions from a neutral-molecule phase
# ---------------------------------------------------------------------------


class IonsFromNeutral(NamedTuple):
    neutral: CondensedPhase
    ion_names: Tuple[str, ...]
    ion_mws: Tuple[float, ...]
    cation_to_neutral: Tuple[int, ...]   # neutral index per cation
    anion: int                           # index of the single anion
    state: dict


def _load_ions_from_neutral(doc, phase, path) -> IonsFromNeutral:
    neutral = load_phase(path, phase["neutral-phase"])
    entries = _resolve_species(doc, phase)
    names = tuple(s["name"] for s in entries)
    mws = tuple(_mw(s.get("composition", {})) for s in entries)
    charges = [float(s.get("charge", 1 if "+" in s["name"] else -1))
               for s in entries]
    anion = next(i for i, c in enumerate(charges) if c < 0)
    cat_map = []
    for i, (nm, c) in enumerate(zip(names, charges)):
        if c > 0:
            # cation K+ maps to the neutral molecule containing it (KCl)
            el = nm.rstrip("+")
            j = next(k for k, s in enumerate(neutral.species)
                     if el in s.name)
            cat_map.append(j)
    return IonsFromNeutral(neutral, names, mws, tuple(cat_map), anion,
                           phase.get("state", {}))


def _cation_indices(ifn: IonsFromNeutral):
    return [i for i in range(len(ifn.ion_names)) if i != ifn.anion]


def ions_chem_potentials(ifn: IonsFromNeutral, T, P, X, *, device="cuda"):
    """IonsFromNeutralVPSSTP.cpp:getChemPotentials, single-anion case:
        mu_cation = mu0_neutral + 2RT ln2 + RT (ln gamma_neutral + ln x)
        mu_anion  = RT ln x
    The neutral activity coefficient comes from the neutral phase's
    excess Gibbs by torch.func.grad."""
    T, P = as_tensors(T, P, device=device)
    X = _composition(X, T)
    gfn = gibbs_fn(ifn.neutral)
    cats = _cation_indices(ifn)
    # neutral-phase composition implied by the cation fractions
    parts = [[] for _ in ifn.neutral.species]
    total = 0.0
    for ci, j in enumerate(ifn.cation_to_neutral):
        parts[j].append(X[cats[ci]])
        total = total + X[cats[ci]]
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    Xn = torch.stack([sum(p, zero) for p in parts])
    Xn = Xn / torch.clamp_min(total, 1e-300)
    g0n = _g0_vector(ifn.neutral.species, T, P)

    def total_g(n):
        ntot = torch.sum(n)
        return ntot * gfn(T, P, n / ntot)
    mun = grad(total_g)(Xn)
    lng = (mun - g0n) / (R * T) - torch.log(torch.clamp_min(Xn, 1e-300))

    mu = [zero] * len(ifn.ion_names)
    for ci, j in enumerate(ifn.cation_to_neutral):
        xx = torch.clamp_min(X[cats[ci]], 1e-300)
        mu[cats[ci]] = (g0n[j] + 2.0 * R * T * np.log(2.0)
                        + R * T * (lng[j] + torch.log(xx)))
    xx = torch.clamp_min(X[ifn.anion], 1e-300)
    mu[ifn.anion] = R * T * torch.log(xx)
    return torch.stack(mu)


def ions_props(ifn: IonsFromNeutral, T, P, X, *, device="cuda"):
    """density (the neutral phase's), enthalpy_mass via h_k = mu_k -
    T dmu_k/dT (IonsFromNeutralVPSSTP.cpp enthalpy_mole role)."""
    T, P = as_tensors(T, P, device=device)
    X = _composition(X, T)

    def mu_t(t):
        return ions_chem_potentials(ifn, t, P, X)
    mu = mu_t(T)
    dmu = jacfwd(mu_t)(T)
    h = torch.dot(X, mu - T * dmu)
    mw = torch.dot(X, _composition(ifn.ion_mws, T))
    # neutral composition for the density, on the host as the reference
    # forms it
    Xh = X.detach().cpu().numpy()
    Xn = np.zeros(len(ifn.neutral.species))
    total = 0.0
    cats = _cation_indices(ifn)
    for ci, j in enumerate(ifn.cation_to_neutral):
        Xn[j] += float(Xh[cats[ci]])
        total += float(Xh[cats[ci]])
    Xn = Xn / max(total, 1e-300)
    rho = density(ifn.neutral, T, P, Xn)
    return {"mu": mu, "h_mole": h, "h_mass": h / mw, "density": rho}


# ---------------------------------------------------------------------------
# Ideal molality-scale solution
# ---------------------------------------------------------------------------


class IdealMolal(NamedTuple):
    species: Tuple[SpeciesStd, ...]     # solvent first
    state: dict

    @property
    def names(self):
        return tuple(s.name for s in self.species)

    @property
    def mws(self):
        return np.array([s.mw for s in self.species])


def _load_ideal_molal(doc, phase) -> IdealMolal:
    entries = _resolve_species(doc, phase)
    species = tuple(load_species_std(s) for s in entries)
    return IdealMolal(species, phase.get("state", {}))


def ideal_molal_props(ph: IdealMolal, T, P, molalities, *, device="cuda"):
    """IdealMolalSoln.cpp: x from molalities (solvent first), ideal
    gamma = 1 on the molality scale.

        mu_solvent = g0_o - RT M_o sum_i m_i
        mu_i       = g0_i + RT ln(m_i / m_std)

    h = sum x h0 (no excess), density from standard volumes."""
    T, P = as_tensors(T, P, device=device)
    # molalities in gmol/kg solvent (the customary scale); solvent first
    m = _composition(molalities, T)
    # moles per kg of solvent: n_solvent = 1e3/MW gmol, n_i = m_i gmol
    n = torch.cat([torch.full((1,), 1e3 / ph.species[0].mw, dtype=T.dtype,
                              device=T.device), m])
    X = n / torch.sum(n)
    g0 = _g0_vector(ph.species, T, P)
    h0 = torch.stack([s.h0(T) + (P - P_REF) * s.v(T) for s in ph.species])
    v0 = torch.stack([s.v(T) for s in ph.species])
    # mu_solvent = g0 - RT Mw_o sum(m) with Mw in kg/gmol, m in gmol/kg
    mu = torch.cat([
        (g0[0] - R * T * (ph.species[0].mw / 1e3) * torch.sum(m))[None],
        g0[1:] + R * T * torch.log(torch.clamp_min(m, 1e-300)),  # m_std = 1
    ])
    return {
        "mu": mu, "X": X,
        "h_mole": torch.dot(X, h0),
        "g_mole": torch.dot(X, mu),
        "density": torch.dot(X, _composition(ph.mws, T)) / torch.dot(X, v0),
    }


# ---------------------------------------------------------------------------
# The reference loader's phases, carried across
# ---------------------------------------------------------------------------


def _fields(obj, names, what):
    """A NamedTuple's or dict's fields, checked against `names`."""
    if hasattr(obj, "_asdict"):
        obj = obj._asdict()
    if sorted(obj) != sorted(names):
        raise KeyError(f"{what} fields {sorted(names)}, got {sorted(obj)}")
    return obj


def _plain(v):
    """A parameter value as plain Python: sequences and arrays as tuples,
    numpy scalars as bool, int or float."""
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return v


def species_std_from_reference(fields) -> SpeciesStd:
    """A SpeciesStd from the reference's (a NamedTuple or a dict of its
    fields); a missing or unknown field raises."""
    f = _fields(fields, SpeciesStd._fields, "SpeciesStd")
    return SpeciesStd(
        str(f["name"]), float(f["mw"]), float(f["charge"]), str(f["kind"]),
        tuple(float(t) for t in f["tmids"]),
        tuple(tuple(float(c) for c in row) for row in f["coeffs"]),
        None if f["v_const"] is None else float(f["v_const"]),
        None if f["rho_poly"] is None
        else tuple(float(c) for c in f["rho_poly"]))


def condensed_from_reference(fields) -> CondensedPhase:
    """A CondensedPhase from the reference's; its species and params are
    carried as plain Python values."""
    f = _fields(fields, CondensedPhase._fields, "CondensedPhase")
    params = {str(k): _plain(v) for k, v in f["params"].items()}
    return CondensedPhase(str(f["kind"]),
                          tuple(species_std_from_reference(s)
                                for s in f["species"]),
                          params, dict(f["state"]))


def compound_lattice_from_reference(fields) -> CompoundLattice:
    f = _fields(fields, CompoundLattice._fields, "CompoundLattice")
    return CompoundLattice(tuple(condensed_from_reference(p)
                                 for p in f["lattices"]),
                           tuple(float(t) for t in f["theta"]),
                           dict(f["state"]))


def ions_from_neutral_from_reference(fields) -> IonsFromNeutral:
    f = _fields(fields, IonsFromNeutral._fields, "IonsFromNeutral")
    return IonsFromNeutral(condensed_from_reference(f["neutral"]),
                           tuple(str(n) for n in f["ion_names"]),
                           tuple(float(m) for m in f["ion_mws"]),
                           tuple(int(j) for j in f["cation_to_neutral"]),
                           int(f["anion"]), dict(f["state"]))


def ideal_molal_from_reference(fields) -> IdealMolal:
    f = _fields(fields, IdealMolal._fields, "IdealMolal")
    return IdealMolal(tuple(species_std_from_reference(s)
                            for s in f["species"]), dict(f["state"]))
