"""Electrolyte solutions: Debye-Huckel molality-scale activity models
(counterpart of g4s_tpu/models/cantera/electrolyte.py).

Reference: cantera/src/thermo/DebyeHuckel.cpp (a MolalityVPSSTP phase:
solvent + solutes on the molality scale, five activity-coefficient
formulations selected by `activity-data.model`):

  dilute-limit            ln g_k = -z_k^2 A sqrt(I)
  B-dot-with-variable-a   extended DH with per-species ionic radii a_k
                          plus the B-dot linear term (charged species)
  B-dot-with-common-a     same with the solvent's single radius
  beta_ij                 DH + 2 sum_j beta_kj m_j interaction terms
  Pitzer-with-beta_ij     Pitzer-form DH denominator + beta_ij terms

plus the solvent activity (osmotic) expressions per form and the
Helgeson fixed-form water activity for brines.

The loader is host code and the phase holds numpy arrays; the evaluation
is one vectorized torch expression over the species axis, on the
molalities' device (numbers and arrays go to `device`, "cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.mech import ELEMENT_WEIGHTS, _yaml_load
from g4s_tpu_torch.sparse.containers import resolve_device

_FORMS = {"dilute-limit": 0, "B-dot-with-variable-a": 1,
          "B-dot-with-common-a": 2, "beta_ij": 3, "Pitzer-with-beta_ij": 4}
_EST_CHARGED = 0
_EST_WEAK_ACID = 1
_EST_NONPOLAR = 2
_EST_POLAR = 3


def _parse_qty(v, default_unit_scale=1.0) -> float:
    """'4 angstrom' / '9e-10 m' / bare number -> SI scalar (per scale)."""
    if isinstance(v, (int, float)):
        return float(v) * default_unit_scale
    parts = str(v).split()
    x = float(parts[0])
    if len(parts) == 1:
        return x * default_unit_scale
    unit = parts[1]
    if unit in ("angstrom", "Å", "A"):
        return x * 1e-10
    if unit == "m":
        return x
    return x   # A_Debye/B_Debye units are already the working units


class DebyeHuckelPhase(NamedTuple):
    species_names: tuple
    charge: np.ndarray          # z_k (solvent first)
    stoich_charge: np.ndarray   # zs_k (weak-acid split)
    est: np.ndarray             # electrolyte species type
    a_ionic: np.ndarray         # ionic radius (m)
    form: int
    A_Debye: float              # kg^0.5 mol^-0.5
    B_Debye: float              # kg^0.5 mol^-0.5 m^-1
    B_dot: np.ndarray           # per species (charged only)
    max_I: float
    beta: np.ndarray            # (n, n) interaction matrix
    helgeson: bool
    M_naught: float             # solvent molecular weight, kg/mol

    @property
    def nspec(self):
        return len(self.species_names)

    def species_index(self, name):
        return self.species_names.index(name)


def load_debye_huckel(path, phase_name: str) -> DebyeHuckelPhase:
    doc = _yaml_load(path)
    phase = next(p for p in doc["phases"] if p.get("name") == phase_name)
    if not str(phase.get("thermo", "")).lower().startswith("debye"):
        raise ValueError(f"phase {phase_name!r} is not a Debye-Huckel phase")
    ad = phase["activity-data"]
    form = _FORMS[ad["model"]]

    # resolve the species list (supports {section: all} and plain lists)
    entries = []
    for item in phase["species"]:
        if isinstance(item, dict):
            (section, sel), = item.items()
            pool = doc[section]
            names = [s["name"] for s in pool] if sel == "all" else sel
            by = {s["name"]: s for s in pool}
            entries += [by[n] for n in names]
        else:
            by = {s["name"]: s for s in doc.get("species", [])}
            entries.append(by[item])

    n = len(entries)
    names = tuple(e["name"] for e in entries)
    default_a = _parse_qty(ad.get("default-ionic-radius", 0.0))
    z = np.zeros(n)
    zs = np.zeros(n)
    est = np.full(n, _EST_CHARGED)
    a_ion = np.full(n, default_a)
    Mw = np.zeros(n)
    for k, e in enumerate(entries):
        comp = e.get("composition", {})
        z[k] = -float(comp.get("E", 0.0))
        Mw[k] = sum(ELEMENT_WEIGHTS[el.upper()] * c
                    for el, c in comp.items() if el.upper() != "E")
        zs[k] = z[k]
        dh = e.get("Debye-Huckel", {}) or {}
        if "ionic-radius" in dh:
            a_ion[k] = _parse_qty(dh["ionic-radius"])
        t = dh.get("electrolyte-species-type")
        if t == "weak-acid-associated":
            est[k] = _EST_WEAK_ACID
            zs[k] = float(dh.get("weak-acid-charge", 0.0))
        elif t == "nonpolar-neutral":
            est[k] = _EST_NONPOLAR
        elif t == "polar-neutral":
            est[k] = _EST_POLAR
        elif abs(z[k]) < 1e-4:
            # neutral solutes default to nonpolar unless declared
            # weak-acid (the reference's interp_est default)
            est[k] = _EST_NONPOLAR
    est[0] = -1                       # solvent

    A = _parse_qty(ad.get("A_Debye", 1.172576))
    B = _parse_qty(ad.get("B_Debye", 3.28640e9))
    bdot_scalar = float(ad.get("B-dot", 0.0))
    bdot = np.where(np.abs(z) > 1e-4, bdot_scalar, 0.0)
    beta = np.zeros((n, n))
    for ent in ad.get("beta", []) or []:
        i = names.index(ent["species"][0])
        j = names.index(ent["species"][1])
        beta[i, j] = beta[j, i] = float(ent["beta"])
    return DebyeHuckelPhase(
        names, z, zs, est, a_ion, form, A, B, bdot,
        float(ad.get("max-ionic-strength", 100.0)), beta,
        bool(ad.get("use-Helgeson-fixed-form", False)),
        Mw[0])    # ELEMENT_WEIGHTS are kg/mol already


def debye_huckel_from_reference(fields) -> DebyeHuckelPhase:
    """A DebyeHuckelPhase from the reference's (the NamedTuple or a dict
    of its fields, arrays as numpy); a missing or unknown field raises."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if sorted(fields) != sorted(DebyeHuckelPhase._fields):
        raise KeyError(f"DebyeHuckelPhase fields "
                       f"{sorted(DebyeHuckelPhase._fields)}, got "
                       f"{sorted(fields)}")
    f = dict(fields)
    for k in ("charge", "stoich_charge", "a_ionic", "B_dot", "beta"):
        f[k] = np.array(f[k], np.float64)
    f["est"] = np.array(f["est"])
    f["species_names"] = tuple(str(s) for s in f["species_names"])
    f["form"] = int(f["form"])
    f["helgeson"] = bool(f["helgeson"])
    for k in ("A_Debye", "B_Debye", "max_I", "M_naught"):
        f[k] = float(f[k])
    return DebyeHuckelPhase(**f)


def _molalities(molalities, device):
    if isinstance(molalities, torch.Tensor):
        return molalities
    return torch.as_tensor(np.asarray(molalities, np.float64),
                           device=resolve_device(device))


def _arr(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device)


def molality_activity_coefficients(ph: DebyeHuckelPhase, molalities, *,
                                   device="cuda"):
    """gamma_k on the molality scale for solutes; the solvent slot (k=0)
    carries the MOLAR-scale solvent activity coefficient a_w / x_w
    (getMolalityActivityCoefficients semantics)."""
    m = _molalities(molalities, device)
    z = _arr(ph.charge, m)
    zs = _arr(ph.stoich_charge, m)
    a = _arr(ph.a_ionic, m)
    solute = torch.arange(ph.nspec, device=m.device) != 0
    zero = torch.zeros((), dtype=m.dtype, device=m.device)

    I = 0.5 * torch.sum(torch.where(solute, m * z * z, zero))
    I = torch.clamp_max(I, ph.max_I)
    z2s = torch.where(zs == z, z * z, zs ** 2 + (z - zs) ** 2)
    I_stoich = torch.clamp_max(
        0.5 * torch.sum(torch.where(solute, m * z2s, zero)), ph.max_I)
    sqI = torch.sqrt(I)
    x_solv = 1.0 / (1.0 + ph.M_naught
                    * torch.sum(torch.where(solute, m, zero)))
    xs = torch.clamp_min(x_solv, 8.689e-3)
    num = ph.A_Debye * sqI
    den = ph.B_Debye * sqI
    ln10 = math.log(10.0)
    Bdot = _arr(ph.B_dot, m)
    beta = _arr(ph.beta, m)

    def sigma_of(y):
        yp1 = y + 1.0
        return torch.where(y > 0,
                           3.0 / torch.clamp_min(y, 1e-300) ** 3
                           * (yp1 - 1.0 / yp1 - 2.0 * torch.log(yp1)), zero)

    if ph.form == 0:        # dilute limit
        lng = -z * z * num
        ln_aw = (xs - 1.0) / xs + (2.0 / 3.0) * ph.A_Debye * ph.M_naught \
            * I * sqI
    elif ph.form == 1:      # B-dot, variable a
        np_ac = 10.0 ** (0.1127 * I - 0.01049 * I ** 2 + 1.545e-3 * I ** 3)
        lng_charged = -z * z * num / (1.0 + den * a) + ln10 * Bdot * I
        lng = torch.where(_arr(ph.est, m) == _EST_NONPOLAR,
                          torch.log(np_ac), lng_charged)
        coeff = (2.0 / 3.0) * ph.A_Debye * ph.M_naught * sqI
        sig = sigma_of(den * a)
        contrib = torch.where(solute | (a > 0), m * z * z * sig / 2.0, zero)
        ln_aw = (xs - 1.0) / xs + coeff * torch.sum(contrib)
        ln_aw = ln_aw - ph.M_naught * ln10 * I \
            * torch.sum(torch.where(solute, Bdot * m, zero)) / 2.0
        if ph.helgeson:
            ln_aw = _helgeson_ln_aw(ph, m, I_stoich, solute)
    elif ph.form == 2:      # B-dot, common a (the solvent's)
        den_c = den * float(ph.a_ionic[0])
        lng = -z * z * num / (1.0 + den_c) + ln10 * Bdot * I
        sig = sigma_of(den_c)
        ln_aw = (xs - 1.0) / xs + (2.0 / 3.0) * ph.A_Debye * ph.M_naught \
            * I * sqI * sig
        ln_aw = ln_aw - ph.M_naught * ln10 * I \
            * torch.sum(torch.where(solute, Bdot * m, zero)) / 2.0
    elif ph.form == 3:      # beta_ij
        den_b = ph.B_Debye * float(ph.a_ionic[0]) * sqI
        lng = -z * z * num / (1.0 + den_b) + 2.0 * (beta @ m)
        sig = sigma_of(den_b)
        ln_aw = (xs - 1.0) / xs + (2.0 / 3.0) * ph.A_Debye * ph.M_naught \
            * I * sqI * sig
        ln_aw = ln_aw - ph.M_naught * (m @ beta @ m)
        # the reference honors use-Helgeson-fixed-form ONLY in the
        # B-dot-with-variable-a branch (s_update_lnMolalityActCoeff)
    else:                   # Pitzer beta_ij
        a0 = float(ph.a_ionic[0])
        den_p = ph.B_Debye * sqI * a0
        lng = (-z * z * num / 3.0 / (1.0 + den_p)
               - 2.0 * z * z * ph.A_Debye * torch.log(1.0 + den_p)
               / (3.0 * ph.B_Debye * a0)
               + 2.0 * (beta @ m))
        ln_aw = (xs - 1.0) / xs + (2.0 / 3.0) * ph.A_Debye * ph.M_naught \
            * I * sqI / (1.0 + den_p)
        ln_aw = ln_aw - ph.M_naught * (m @ beta @ m)

    gamma = torch.exp(lng)
    gamma_solvent = torch.exp(ln_aw) / x_solv
    return torch.where(solute, gamma, gamma_solvent)


def _helgeson_ln_aw(ph: DebyeHuckelPhase, m, I_stoich, solute):
    """Helgeson fixed-form brine water activity
    (_osmoticCoeffHelgesonFixedForm / _lnactivityWaterHelgesonFixedForm)."""
    a0, b0, c0, d0 = 1.454, 0.02236, 9.380e-3, -5.362e-4
    Is = I_stoich
    bhat = 1.0 + a0 * torch.sqrt(Is)
    func = bhat - 2.0 * torch.log(bhat) - 1.0 / bhat
    v1 = ph.A_Debye / (a0 ** 3 * torch.clamp_min(Is, 1e-300)) * func
    oc = torch.where(Is > 0,
                     1.0 - v1 + b0 * Is / 2.0 + 2.0 * c0 * Is ** 2 / 3.0
                     + 3.0 * d0 * Is ** 3 / 4.0, torch.zeros_like(Is))
    tot = torch.clamp_max(torch.sum(torch.where(
        solute, torch.clamp_min(m, 0.0), torch.zeros_like(m))),
        2.0 * ph.max_I)
    return -ph.M_naught * tot * oc


def ionic_strength(ph: DebyeHuckelPhase, molalities, *, device="cuda"):
    m = _molalities(molalities, device)
    z = _arr(ph.charge, m)
    solute = torch.arange(ph.nspec, device=m.device) != 0
    return 0.5 * torch.sum(torch.where(solute, m * z * z,
                                       torch.zeros((), dtype=m.dtype,
                                                   device=m.device)))
