"""YAML reaction-mechanism loader (counterpart of
g4s_tpu/models/cantera/mech.py, which imports no JAX; the port keeps its
own copy so that it imports nothing of g4s_tpu).

Parses Cantera-format mechanism files (Cantera's AnyMap/YAML layer,
cantera/src/base + ThermoFactory) into dense, padded numpy arrays:
stoichiometry as dense (nrxn, nspec) matrices (at mechanism scale, e.g.
553 x 100 for n-dodecane, the engine's dispatcher stages them as dense
operators: the role of StoichManager's sparse nu products,
cantera/src/kinetics/StoichManager.h), Arrhenius parameter vectors, and
mask-based reaction-type handling (elementary / three-body / falloff+Troe /
PLOG / Chebyshev, cantera/src/kinetics/GasKinetics.cpp:227).

Units: everything is converted to mol-based SI (m, mol, J, K):
concentrations mol/m^3, R = 8.314462618 J/mol/K. A mechanism declaring
cm/mol/cal units has its A factors converted by 1e-6^(order-1) and its Ea
by 4.184.

`mechanism_from_reference` builds a Mechanism from another loader's
fields (e.g. the reference package's Mechanism as a dict of numpy
arrays), so parity tests can share one mechanism between the packages.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np

R_GAS = 8.314462618       # J/mol/K
P_REF = 101325.0          # Pa, thermo reference pressure
CAL2J = 4.184

ELEMENT_WEIGHTS = {       # kg/mol
    "H": 1.008e-3, "C": 12.011e-3, "O": 15.999e-3, "N": 14.007e-3,
    "AR": 39.95e-3, "HE": 4.002602e-3, "S": 32.06e-3, "SI": 28.085e-3,
    "NA": 22.98976928e-3, "CL": 35.45e-3, "K": 39.0983e-3,
    "FE": 55.845e-3, "CA": 40.078e-3, "MG": 24.305e-3, "AL": 26.9815e-3,
    "F": 18.998403e-3, "BR": 79.904e-3, "LI": 6.94e-3, "PT": 195.084e-3,
    "E": 5.48579909e-7,
}


@dataclasses.dataclass
class Mechanism:
    name: str
    species_names: List[str]
    compositions: List[Dict[str, float]]   # elemental composition per species
    mol_weights: np.ndarray         # (nspec,) kg/mol
    # NASA7 thermo: low range, high range, Tmid, Tmin, Tmax
    nasa_low: np.ndarray            # (nspec, 7)
    nasa_high: np.ndarray           # (nspec, 7)
    t_mid: np.ndarray               # (nspec,)
    # Redlich-Kwong per-species coefficients (mol-SI), zero when absent
    rk_a: np.ndarray                # (nspec, 2)  a(T) = a0 + a1*T
    rk_b: np.ndarray                # (nspec,)
    # reactions
    nu_reac: np.ndarray             # (nrxn, nspec)
    nu_prod: np.ndarray             # (nrxn, nspec)
    arr_A: np.ndarray               # (nrxn,) SI
    arr_b: np.ndarray
    arr_Ea: np.ndarray              # J/mol
    reversible: np.ndarray          # (nrxn,) bool
    is_three_body: np.ndarray       # (nrxn,) bool (pure three-body)
    is_falloff: np.ndarray          # (nrxn,) bool
    efficiencies: np.ndarray        # (nrxn, nspec) third-body efficiencies
    low_A: np.ndarray               # (nrxn,) falloff low-pressure Arrhenius
    low_b: np.ndarray
    low_Ea: np.ndarray
    troe: np.ndarray                # (nrxn, 4) A, T3, T1, T2 (T2=0 -> absent)
    has_troe: np.ndarray            # (nrxn,) bool
    # pressure-dependent-Arrhenius (PLOG): padded per-pressure tables
    is_plog: np.ndarray             # (nrxn,) bool
    plog_logP: np.ndarray           # (nrxn, maxp) ln(P/Pa), padded w/ +inf
    plog_arr: np.ndarray            # (nrxn, maxp, 3) A(SI), b, Ea(J/mol)
    plog_n: np.ndarray              # (nrxn,) valid point count
    # Chebyshev: padded coefficient grids (log10 k in SI after conversion)
    is_cheb: np.ndarray             # (nrxn,) bool
    cheb_coeffs: np.ndarray         # (nrxn, nT, nP)
    cheb_Tlim: np.ndarray           # (nrxn, 2) Tmin, Tmax (K)
    cheb_Plim: np.ndarray           # (nrxn, 2) Pmin, Pmax (Pa)
    # cubic-EoS selector + Peng-Robinson coefficients (mol-SI)
    eos_model: str = "ideal"        # ideal | redlich-kwong | peng-robinson
    pr_a: Optional[np.ndarray] = None       # (nspec,) Pa (m^3/mol)^2
    pr_b: Optional[np.ndarray] = None       # (nspec,) m^3/mol
    pr_kappa: Optional[np.ndarray] = None   # (nspec,) from acentric factor
    pr_Tc: Optional[np.ndarray] = None      # (nspec,) K
    # NASA9 species (Nasa9Poly1.cpp:14-80, Nasa9PolyMultiTempRegion.cpp):
    # per-species multi-region 9-coefficient polynomials; NASA7 species
    # have is_nasa9 False and zeros here
    is_nasa9: Optional[np.ndarray] = None   # (nspec,) bool
    nasa9_T: Optional[np.ndarray] = None    # (nspec, R+1) region bounds
    nasa9_c: Optional[np.ndarray] = None    # (nspec, R, 9)
    # NIST Shomate species (ShomatePoly2.h): t=T/1000, h in kJ/mol
    is_shomate: Optional[np.ndarray] = None  # (nspec,) bool
    shomate_T: Optional[np.ndarray] = None   # (nspec, R+1)
    shomate_c: Optional[np.ndarray] = None   # (nspec, R, 7)

    @property
    def nspec(self) -> int:
        return len(self.species_names)

    @property
    def nrxn(self) -> int:
        return self.nu_reac.shape[0]

    def species_index(self, name: str) -> int:
        try:
            return self.species_names.index(name)
        except ValueError:
            # mechanism files differ in case conventions (h2o2.yaml uses
            # upper-case, nDodecane_Reitz lower-case); fall back
            # case-insensitively like Cantera's caseInsensitiveEquals paths
            lowered = [s.lower() for s in self.species_names]
            return lowered.index(name.lower())


_COEF_SPECIES = re.compile(r"^(\d+(?:\.\d+)?)\s+(.*)$")

_PRESSURE_UNITS = {"Pa": 1.0, "kPa": 1e3, "bar": 1e5, "atm": 101325.0,
                   "torr": 133.322}


def _parse_pressure(v) -> float:
    """'1.0 atm' / '1.0e5 Pa' / bare number (Pa) -> Pa."""
    if isinstance(v, (int, float)):
        return float(v)
    num, unit = v.split()
    return float(num) * _PRESSURE_UNITS[unit]


def _split_terms(side: str):
    """Split one side of a reaction equation into species terms.

    A '+' is a separator only when it stands alone between whitespace —
    Cantera tokenizes equations on whitespace (`Reaction.cpp`
    parseReactionEquation) so charged species keep their trailing '+':
    'H3O+ + E' -> ['H3O+', 'E'], never ['H3O', '', 'E'].
    """
    return re.split(r"\s+\+(?=\s|$)", side.strip())


def _parse_side(side: str, species_idx: Dict[str, int], nspec: int):
    """'2 oh + c2h4 (+M)' -> (nu vector, has_tb, has_falloff_m)."""
    nu = np.zeros(nspec)
    has_plain_m = False
    has_falloff_m = False
    side = side.strip()
    if "(+M)" in side or "(+ M)" in side:
        has_falloff_m = True
        side = side.replace("(+M)", "").replace("(+ M)", "")
    for term in _split_terms(side):
        term = term.strip()
        if not term:
            continue
        if term in ("M", "m"):
            has_plain_m = True
            continue
        mobj = _COEF_SPECIES.match(term)
        if mobj:
            coef, name = float(mobj.group(1)), mobj.group(2).strip()
        else:
            coef, name = 1.0, term
        if name not in species_idx:
            raise KeyError(f"unknown species {name!r} in equation side {side!r}")
        nu[species_idx[name]] += coef
    return nu, has_plain_m, has_falloff_m


def _yaml_load(path):
    """YAML load that keeps chemistry names intact: plain NO/ON/OFF/YES are
    species names, not booleans (YAML 1.1 bool-ification breaks gri30's NO)."""
    import yaml

    class MechLoader(yaml.SafeLoader):
        pass

    def _bool(loader, node):
        v = loader.construct_scalar(node)
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        return v

    MechLoader.add_constructor("tag:yaml.org,2002:bool", _bool)
    with open(path) as f:
        return yaml.load(f, Loader=MechLoader)


def _species_in_equation(eq: str):
    """Species names mentioned on either side of a reaction equation."""
    names = set()
    for arrow in ("<=>", "=>", "="):
        if arrow in eq:
            sides = eq.split(arrow)
            break
    else:
        sides = [eq]
    for side in sides:
        side = side.replace("(+M)", "").replace("(+ M)", "")
        for term in _split_terms(side):
            term = term.strip()
            if not term or term in ("M", "m"):
                continue
            mobj = _COEF_SPECIES.match(term)
            names.add(mobj.group(2).strip() if mobj else term)
    return names


def _resolve_phase_lists(doc, phase, path):
    """Cantera's cross-file phase syntax (newSolution/setupPhase): a
    phase's `species`/`reactions` entries may be plain names, local
    section references, or `<file>/<section>` imports, e.g.

        species:
        - gri30.yaml/species: [H, O, OH]
        - species: [H2, HCO+]
        reactions:
        - gri30.yaml/reactions: declared-species
        - reactions: declared-species

    Returns (species_order, by_name, reactions_list); with
    `declared-species` filtering, imported reactions whose equations
    mention undeclared species are dropped (skip-undeclared-third-
    bodies drops only unknown efficiency entries — the parser already
    ignores those)."""
    import os

    def load_ref(fname):
        # relative to the importing file (the reference also falls back to
        # a data directory of its own installation, which the port has not)
        p = fname if os.path.isabs(fname) else os.path.join(
            os.path.dirname(os.path.abspath(path)), fname)
        return _yaml_load(p)

    def section_species(d, section):
        return {s["name"]: s for s in d.get(section, [])}

    raw = phase["species"]
    species_order: list = []
    by_name: dict = {}
    if isinstance(raw, list) and all(isinstance(s, str) for s in raw):
        species_order = list(raw)
        local = section_species(doc, "species")
        by_name = {n: local[n] for n in species_order if n in local}
        # species may also live in named sections (species_NaCl(S) etc.)
        for sec, val in doc.items():
            if sec.startswith("species") and sec != "species" \
                    and isinstance(val, list):
                for s in val:
                    by_name.setdefault(s["name"], s)
    else:
        for ent in raw:
            if isinstance(ent, str):
                species_order.append(ent)
                by_name[ent] = section_species(doc, "species")[ent]
                continue
            (ref, names), = ent.items()
            if "/" in ref:
                fname, section = ref.rsplit("/", 1)
                table = section_species(load_ref(fname), section)
            else:
                table = section_species(doc, ref)
            if names == "all":
                names = list(table)
            for n in names:
                species_order.append(n)
                by_name[n] = table[n]

    declared = set(species_order)
    raw_rxn = phase.get("reactions", doc.get("reactions", []))
    rxns: list = []
    if isinstance(raw_rxn, list) and raw_rxn \
            and all(isinstance(r, dict) and "equation" in r
                    for r in raw_rxn):
        rxns = list(raw_rxn)
    elif isinstance(raw_rxn, str):
        # 'all' / section name
        sec = "reactions" if raw_rxn in ("all", "declared-species") \
            else raw_rxn
        rxns = list(doc.get(sec, []))
        if raw_rxn == "declared-species":
            rxns = [r for r in rxns
                    if _species_in_equation(r["equation"]) <= declared]
    elif isinstance(raw_rxn, list):
        for ent in raw_rxn:
            if isinstance(ent, dict) and "equation" in ent:
                rxns.append(ent)
                continue
            (ref, mode), = ent.items()
            if "/" in ref:
                fname, section = ref.rsplit("/", 1)
                src = load_ref(fname).get(section, [])
            else:
                src = doc.get(ref, [])
            if mode == "declared-species":
                src = [r for r in src
                       if _species_in_equation(r["equation"]) <= declared]
            elif isinstance(mode, str) and mode not in ("all",):
                raise NotImplementedError(f"reactions mode {mode!r}")
            rxns.extend(src)
    return species_order, by_name, rxns


def load_mechanism(path, phase_name: Optional[str] = None) -> Mechanism:
    doc = _yaml_load(path)

    phases = doc.get("phases", [])
    phase = None
    if phase_name is None and phases:
        phase = phases[0]
    else:
        for p in phases:
            if p.get("name") == phase_name:
                phase = p
                break
    if phase is None:
        raise KeyError(f"phase {phase_name!r} not found in {path}")

    species_order, by_name_resolved, rxns_resolved = _resolve_phase_lists(
        doc, phase, path)
    species_idx = {s: i for i, s in enumerate(species_order)}
    nspec = len(species_order)

    by_name = by_name_resolved
    compositions = [dict() for _ in range(nspec)]
    mol_weights = np.zeros(nspec)
    nasa_low = np.zeros((nspec, 7))
    nasa_high = np.zeros((nspec, 7))
    t_mid = np.zeros(nspec)
    rk_a = np.zeros((nspec, 2))
    rk_b = np.zeros(nspec)
    pr_a = np.zeros(nspec)
    pr_b = np.zeros(nspec)
    pr_kappa = np.zeros(nspec)
    pr_Tc = np.ones(nspec)
    thermo_model = str(phase.get("thermo", "")).lower()
    is_rk_phase = thermo_model.startswith("redlich")
    is_pr_phase = thermo_model.startswith("peng")

    nasa9_entries = {}
    shomate_entries = {}
    for name, i in species_idx.items():
        sp = by_name[name]
        comp = sp["composition"]
        compositions[i] = {el.upper(): float(n) for el, n in comp.items()}
        mol_weights[i] = sum(ELEMENT_WEIGHTS[el.upper()] * n
                             for el, n in comp.items())
        th = sp["thermo"]
        if th.get("model") == "Shomate":
            tr = [float(t) for t in th["temperature-ranges"]]
            shomate_entries[i] = (tr, [list(map(float, row))
                                       for row in th["data"]])
            t_mid[i] = tr[1] if len(tr) > 2 else tr[-1]
            continue
        if th.get("model") == "NASA9":
            # multi-region 9-coefficient polynomials
            # (Nasa9Poly1.cpp:14-80, Nasa9PolyMultiTempRegion.cpp)
            tr = [float(t) for t in th["temperature-ranges"]]
            nasa9_entries[i] = (tr, [list(map(float, row))
                                     for row in th["data"]])
            t_mid[i] = tr[1] if len(tr) > 2 else tr[-1]
            continue
        if th.get("model") != "NASA7":
            raise NotImplementedError(f"thermo model {th.get('model')}")
        tr = th["temperature-ranges"]
        data = th["data"]
        if len(data) == 1:
            nasa_low[i] = nasa_high[i] = data[0]
            t_mid[i] = tr[-1]
        else:
            nasa_low[i] = data[0]
            nasa_high[i] = data[1]
            t_mid[i] = tr[1]
        eos = sp.get("equation-of-state")
        if eos and str(eos.get("model", "")).lower().startswith("redlich"):
            a = eos["a"]
            a = a if isinstance(a, list) else [a, 0.0]
            # (cm^3/mol)^2 * Pa -> (m^3/mol)^2 * Pa
            rk_a[i] = np.asarray(a, dtype=np.float64) * 1e-12
            rk_b[i] = float(eos["b"]) * 1e-6
        elif eos and str(eos.get("model", "")).lower().startswith("peng"):
            # PengRobinson.cpp setSpeciesCoeffs: a, b, acentric factor;
            # Tc recovered from a/b via the critical-point relations
            # a = 0.45724 R^2 Tc^2/Pc, b = 0.07780 R Tc/Pc
            pr_a[i] = float(eos["a"]) * 1e-12
            pr_b[i] = float(eos["b"]) * 1e-6
            w = float(eos.get("acentric-factor", 0.0))
            pr_kappa[i] = 0.37464 + 1.54226 * w - 0.26992 * w * w
            pr_Tc[i] = (pr_a[i] * 0.07780) / (pr_b[i] * 0.45724 * R_GAS)

    # units block
    units = doc.get("units", {})
    len_u = units.get("length", "m")
    qty_u = units.get("quantity", "kmol")
    ea_u = units.get("activation-energy", "J/kmol")
    conc_factor = {"cm": 1e-2, "m": 1.0, "mm": 1e-3}[len_u] ** 3  # m^3
    qty_factor = {"mol": 1.0, "kmol": 1e3, "molec": 1.0 / 6.02214076e23}[qty_u]
    # concentration unit declared by file, in mol/m^3:
    conc_unit = qty_factor / conc_factor
    ea_factor = {"cal/mol": CAL2J, "kcal/mol": CAL2J * 1e3, "J/mol": 1.0,
                 "J/kmol": 1e-3, "kJ/mol": 1e3, "K": R_GAS}[ea_u]

    rxns = rxns_resolved
    n = len(rxns)
    nu_reac = np.zeros((n, nspec))
    nu_prod = np.zeros((n, nspec))
    arr = np.zeros((n, 3))
    low = np.zeros((n, 3))
    reversible = np.zeros(n, bool)
    is_tb = np.zeros(n, bool)
    is_fo = np.zeros(n, bool)
    effs = np.ones((n, nspec))
    troe = np.zeros((n, 4))
    has_troe = np.zeros(n, bool)
    is_plog = np.zeros(n, bool)
    plog_entries: list = [None] * n
    is_cheb = np.zeros(n, bool)
    cheb_entries: list = [None] * n

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
        nu_r, m_r, fo_r = _parse_side(lhs, species_idx, nspec)
        nu_p, m_p, fo_p = _parse_side(rhs, species_idx, nspec)
        nu_reac[k], nu_prod[k] = nu_r, nu_p
        rtype = rx.get("type", "elementary")
        if rtype == "three-body" or (m_r and m_p):
            is_tb[k] = True
        if rtype == "falloff" or (fo_r and fo_p):
            is_fo[k] = True
        for sp_name, e in (rx.get("efficiencies") or {}).items():
            if sp_name in species_idx:
                effs[k, species_idx[sp_name]] = float(e)

        def _convert_arrhenius(rc, order):
            A = float(rc["A"]) * conc_unit ** (-(order - 1.0))
            return A, float(rc.get("b", 0.0)), float(rc.get("Ea", 0.0)) * ea_factor

        order = nu_r.sum()
        if is_tb[k]:
            order += 1.0
        if is_fo[k]:
            hi = rx["high-P-rate-constant"] if "high-P-rate-constant" in rx \
                else rx["rate-constant"]
            lo = rx["low-P-rate-constant"]
            arr[k] = _convert_arrhenius(hi, nu_r.sum())
            low[k] = _convert_arrhenius(lo, nu_r.sum() + 1.0)
            tr = rx.get("Troe")
            if tr:
                has_troe[k] = True
                troe[k] = [float(tr.get("A", 0.0)), float(tr.get("T3", 1e-30)),
                           float(tr.get("T1", 1e-30)), float(tr.get("T2", 0.0))]
        elif rtype == "pressure-dependent-Arrhenius":
            # PlogRate (cantera/src/kinetics/PlogRate.cpp): piecewise
            # log-log interpolation between tabulated pressures
            is_plog[k] = True
            pts = []
            for rc in rx["rate-constants"]:
                pts.append((np.log(_parse_pressure(rc["P"])),
                            *_convert_arrhenius(rc, order)))
            pts.sort(key=lambda t: t[0])
            plog_entries[k] = pts
        elif rtype == "Chebyshev":
            # ChebyshevRate (cantera/src/kinetics/ChebyshevRate.cpp):
            # log10 k = sum_ij a_ij Ti(Tred) Tj(Pred); unit conversion of k
            # folds into the constant coefficient a00
            is_cheb[k] = True
            coeffs = np.asarray(rx["data"], dtype=np.float64)
            conv = conc_unit ** (-(order - 1.0))
            coeffs[0, 0] += np.log10(conv)
            tr_ = [float(t) for t in rx["temperature-range"]]
            pr_ = [_parse_pressure(p) for p in rx["pressure-range"]]
            cheb_entries[k] = (coeffs, tr_, pr_)
        else:
            arr[k] = _convert_arrhenius(rx["rate-constant"], order)

    # pack PLOG points into padded tables (pad logP with +inf so the
    # bracketing search naturally clamps to the last real interval)
    maxp = max((len(p) for p in plog_entries if p), default=1)
    plog_logP = np.full((n, maxp), np.inf)
    plog_arr = np.zeros((n, maxp, 3))
    plog_arr[:, :, 0] = 1.0
    plog_n = np.zeros(n, np.int32)
    for k, pts in enumerate(plog_entries):
        if pts:
            plog_n[k] = len(pts)
            for j, (lp, A, b, Ea) in enumerate(pts):
                plog_logP[k, j] = lp
                plog_arr[k, j] = (A, b, Ea)

    nT = max((c[0].shape[0] for c in cheb_entries if c), default=1)
    nP = max((c[0].shape[1] for c in cheb_entries if c), default=1)
    cheb_coeffs = np.zeros((n, nT, nP))
    cheb_Tlim = np.tile(np.array([300.0, 3000.0]), (n, 1))
    cheb_Plim = np.tile(np.array([1e3, 1e7]), (n, 1))
    for k, ent in enumerate(cheb_entries):
        if ent:
            c, tr_, pr_ = ent
            cheb_coeffs[k, :c.shape[0], :c.shape[1]] = c
            cheb_Tlim[k] = tr_
            cheb_Plim[k] = pr_

    is_shomate = shomate_T = shomate_c = None
    if shomate_entries:
        R_max = max(len(d) for _, d in shomate_entries.values())
        is_shomate = np.zeros(nspec, bool)
        shomate_T = np.full((nspec, R_max + 1), np.inf)
        shomate_T[:, 0] = 0.0
        shomate_c = np.zeros((nspec, R_max, 7))
        for i, (tr, data) in shomate_entries.items():
            is_shomate[i] = True
            shomate_T[i, : len(tr)] = tr
            for r in range(R_max):
                shomate_c[i, r] = data[min(r, len(data) - 1)]

    is_nasa9 = nasa9_T = nasa9_c = None
    if nasa9_entries:
        R_max = max(len(d) for _, d in nasa9_entries.values())
        is_nasa9 = np.zeros(nspec, bool)
        nasa9_T = np.full((nspec, R_max + 1), np.inf)
        nasa9_T[:, 0] = 0.0
        nasa9_c = np.zeros((nspec, R_max, 9))
        for i, (tr, data) in nasa9_entries.items():
            is_nasa9[i] = True
            nasa9_T[i, : len(tr)] = tr
            # pad missing regions by repeating the last one so any
            # region pick stays finite
            for r in range(R_max):
                nasa9_c[i, r] = data[min(r, len(data) - 1)]

    return Mechanism(
        name=phase.get("name", "gas"), species_names=list(species_order),
        compositions=compositions, mol_weights=mol_weights, nasa_low=nasa_low, nasa_high=nasa_high,
        t_mid=t_mid, rk_a=rk_a if is_rk_phase else np.zeros_like(rk_a),
        rk_b=rk_b if is_rk_phase else np.zeros_like(rk_b),
        nu_reac=nu_reac, nu_prod=nu_prod,
        arr_A=arr[:, 0], arr_b=arr[:, 1], arr_Ea=arr[:, 2],
        reversible=reversible, is_three_body=is_tb, is_falloff=is_fo,
        efficiencies=effs, low_A=low[:, 0], low_b=low[:, 1], low_Ea=low[:, 2],
        troe=troe, has_troe=has_troe,
        is_plog=is_plog, plog_logP=plog_logP, plog_arr=plog_arr,
        plog_n=plog_n, is_cheb=is_cheb, cheb_coeffs=cheb_coeffs,
        cheb_Tlim=cheb_Tlim, cheb_Plim=cheb_Plim,
        eos_model=("redlich-kwong" if is_rk_phase
                   else "peng-robinson" if is_pr_phase else "ideal"),
        pr_a=pr_a, pr_b=pr_b, pr_kappa=pr_kappa, pr_Tc=pr_Tc,
        is_nasa9=is_nasa9, nasa9_T=nasa9_T, nasa9_c=nasa9_c,
        is_shomate=is_shomate, shomate_T=shomate_T, shomate_c=shomate_c)


def mechanism_from_reference(fields: dict) -> Mechanism:
    """A Mechanism from another loader's fields: a dict with every field of
    Mechanism (e.g. `{f.name: getattr(m, f.name) for f in
    dataclasses.fields(m)}` of the reference package's Mechanism). Arrays
    are copied as numpy arrays, lists and dicts copied; a missing or unknown
    field raises."""
    names = [f.name for f in dataclasses.fields(Mechanism)]
    unknown = sorted(set(fields) - set(names))
    if unknown:
        raise KeyError(f"not fields of Mechanism: {unknown}")
    kw = {}
    for f in dataclasses.fields(Mechanism):
        if f.name not in fields:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"missing Mechanism field {f.name!r}")
            continue
        v = fields[f.name]
        if f.name == "species_names":
            v = [str(s) for s in v]
        elif f.name == "compositions":
            v = [{str(k): float(n) for k, n in c.items()} for c in v]
        elif f.name in ("name", "eos_model"):
            v = str(v)
        elif v is not None:
            v = np.array(v)
        kw[f.name] = v
    return Mechanism(**kw)
