"""PlasmaPhase: an ideal gas whose electrons have their own temperature
(counterpart of g4s_tpu/models/cantera/plasma.py).

Reference: cantera/src/thermo/PlasmaPhase.cpp and
kinetics/TwoTempPlasmaRate.h. The phase carries an electron energy
distribution f(eps) over an energy-level grid [eV]:

  isotropic    f = c1/em^1.5 exp(-c2 (eps/em)^x) with the
               generalized-Maxwellian shape factor x
               (x = 1 Maxwellian, x = 2 Druyvesteyn),
               c1 = x G(5/(2x))^1.5 / G(3/(2x))^2.5,
               c2 = (G(5/(2x))/G(3/(2x)))^x
               (the Hagelaar-Pitchford form, self-consistent with the
               normalization and mean-energy quadratures below; the
               reference documents why it departs from Cantera 2.6's
               PlasmaPhase.cpp:64-78)
  discretized  user-supplied (levels, f) pairs, optionally normalized
               to 2/3 int f d(eps^3/2) = 1

The electron temperature follows the mean energy
  em = 2/5 int f d(eps^5/2),   Te = (2/3) em e / kB,
and the electron species' reference thermo is evaluated at Te while all
heavy species use T (PlasmaPhase::updateThermo). The two-temperature
rate k = A exp(b ln Te - Ea_g/T + Ea_e (Te-T)/(Te T)) couples both
temperatures (TwoTempPlasmaRate.h:97-103).

The distribution and its quadratures are torch tensors on the phase's
device (`load_plasma(..., device=)`, "cuda" unless the caller asks for
the CPU); Te is a number, read once when the phase is loaded.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.condensed import (SpeciesStd,
                                                    load_species_std,
                                                    species_std_from_reference)
from g4s_tpu_torch.models.cantera.mech import _yaml_load
from g4s_tpu_torch.models.cantera.thermo import as_tensors
from g4s_tpu_torch.sparse.containers import resolve_device

R = 8314.462618153324
BOLTZMANN = 1.380649e-23
E_CHARGE = 1.602176634e-19


def _quad_d(f, g):
    """int f dg by trapezoid on the (monotone) transformed variable g."""
    return torch.sum(0.5 * (f[1:] + f[:-1]) * (g[1:] - g[:-1]))


def normalize_dist(levels, dist):
    """Scale so 2/3 int f d(eps^3/2) = 1
    (normalizeElectronEnergyDistribution)."""
    norm = 2.0 / 3.0 * _quad_d(dist, levels ** 1.5)
    return dist / norm


def mean_electron_energy(levels, dist):
    """em [eV] = 2/5 int f d(eps^5/2)
    (updateElectronTemperatureFromEnergyDist)."""
    return 2.0 / 5.0 * _quad_d(dist, levels ** 2.5)


def electron_temp_from_energy(em_eV):
    return 2.0 / 3.0 * em_eV * E_CHARGE / BOLTZMANN


def isotropic_dist(levels, em_eV, x: float):
    """The generalized-Maxwellian EEDF at mean energy em [eV].

    Satisfies 2/3 int f d(eps^3/2) = 1 and 2/5 int f d(eps^5/2) = em
    exactly (in the continuum limit) for every shape factor x."""
    g1, g2 = torch.exp(torch.lgamma(torch.tensor(
        [1.5 / x, 2.5 / x], dtype=torch.float64))).tolist()
    c1 = x * g2 ** 1.5 / g1 ** 2.5
    c2 = (g2 / g1) ** x
    return c1 / em_eV ** 1.5 * torch.exp(-c2 * (levels / em_eV) ** x)


def two_temp_plasma_rate(A, b, Ea_gas_K, Ea_electron_K, T, Te, *,
                         device="cuda"):
    """k = A exp(b ln Te - Ea_g/T + Ea_e (Te - T)/(Te T))
    (TwoTempPlasmaRate::evalFromStruct; activation energies in K)."""
    T, Te = as_tensors(T, Te, device=device)
    return A * torch.exp(b * torch.log(Te) - Ea_gas_K / T
                         + Ea_electron_K * (Te - T) / (Te * T))


class PlasmaPhase(NamedTuple):
    species: Tuple[SpeciesStd, ...]
    electron_index: int
    dist_type: str
    levels: torch.Tensor           # eV
    dist: torch.Tensor
    shape_factor: float
    Te: float

    @property
    def names(self):
        return tuple(s.name for s in self.species)

    def mean_energy(self):
        return float(mean_electron_energy(self.levels, self.dist))

    # ---- thermo: heavy species at T, the electron species at Te ----

    def _temps(self, T):
        T, Te = as_tensors(T, self.Te, device=self.levels.device)
        return [Te if i == self.electron_index else T
                for i in range(len(self.species))]

    def h0_RT(self, T):
        return torch.stack([s.h0(Ts) / (R * Ts) for s, Ts in
                            zip(self.species, self._temps(T))])

    def s0_R(self, T):
        return torch.stack([s.s0(Ts) / R for s, Ts in
                            zip(self.species, self._temps(T))])

    def cp0_R(self, T):
        return torch.stack([s.cp0(Ts) / R for s, Ts in
                            zip(self.species, self._temps(T))])

    def enthalpy_mole(self, T, X):
        """sum X_k h_k with the electron enthalpy at Te."""
        h = torch.stack([s.h0(Ts) for s, Ts in
                         zip(self.species, self._temps(T))])
        X = torch.as_tensor(np.asarray(X, np.float64), dtype=h.dtype,
                            device=h.device) \
            if not isinstance(X, torch.Tensor) else X
        return torch.dot(X, h)


def _resolve_plasma_species(doc, phase, base_dir):
    """Species lists may point into other files: 'nasa_gas.yaml/species'."""
    entries = []
    for item in phase["species"]:
        (sec, names), = item.items() if isinstance(item, dict) \
            else (("species", [item]),)
        if "/" in sec:
            fname, section = sec.rsplit("/", 1)
            for cand in (os.path.join(base_dir, fname),
                         os.path.join(base_dir, os.pardir, os.pardir,
                                      "data", fname)):
                if os.path.exists(cand):
                    sub = _yaml_load(cand)
                    break
            else:
                raise FileNotFoundError(fname)
            table = {s["name"]: s for s in sub[section]}
        else:
            table = {s["name"]: s for s in doc[sec]}
        entries.extend(table[n] for n in
                       (names if names != "all" else table))
    return entries


def load_plasma(path: str, name: str, *, device="cuda") -> PlasmaPhase:
    doc = _yaml_load(path)
    phase = next(p for p in doc["phases"] if p["name"] == name)
    if phase["thermo"] != "plasma":
        raise ValueError(f"phase {name!r} is not a plasma phase")
    dev = resolve_device(device)
    entries = _resolve_plasma_species(doc, phase, os.path.dirname(path))
    species = tuple(load_species_std(s) for s in entries)
    e_idx = next(i for i, s in enumerate(entries)
                 if s.get("composition") == {"E": 1})

    eedf = phase["electron-energy-distribution"]
    levels = torch.as_tensor(
        np.asarray([float(v) for v in eedf["energy-levels"]]), device=dev)
    if eedf["type"] == "isotropic":
        x = float(eedf["shape-factor"])
        # "1.0 eV" or a bare number -> eV (the distribution's native unit)
        mee = eedf["mean-electron-energy"]
        if isinstance(mee, str):
            val, unit = mee.split()
            if unit != "eV":
                raise ValueError(f"mean-electron-energy {mee!r}: not in eV")
            em = float(val)
        else:
            em = float(mee)
        dist = isotropic_dist(levels, em, x)
        Te = float(electron_temp_from_energy(em))
        return PlasmaPhase(species, e_idx, "isotropic", levels, dist, x, Te)
    if eedf["type"] == "discretized":
        dist = torch.as_tensor(
            np.asarray([float(v) for v in eedf["distribution"]]), device=dev)
        if eedf.get("normalize", True):
            dist = normalize_dist(levels, dist)
        em = mean_electron_energy(levels, dist)
        Te = float(electron_temp_from_energy(em))
        return PlasmaPhase(species, e_idx, "discretized", levels, dist,
                           float("nan"), Te)
    raise NotImplementedError(eedf["type"])


def plasma_from_reference(fields, *, device="cuda") -> PlasmaPhase:
    """A PlasmaPhase from the reference's (the NamedTuple or a dict of its
    fields; levels and dist as arrays, put on `device`); a missing or
    unknown field raises."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if sorted(fields) != sorted(PlasmaPhase._fields):
        raise KeyError(f"PlasmaPhase fields {sorted(PlasmaPhase._fields)}, "
                       f"got {sorted(fields)}")
    dev = resolve_device(device)
    return PlasmaPhase(
        tuple(species_std_from_reference(s) for s in fields["species"]),
        int(fields["electron_index"]), str(fields["dist_type"]),
        torch.as_tensor(np.array(fields["levels"], np.float64), device=dev),
        torch.as_tensor(np.array(fields["dist"], np.float64), device=dev),
        float(fields["shape_factor"]), float(fields["Te"]))
