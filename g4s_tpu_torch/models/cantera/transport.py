"""Mixture-averaged transport properties (counterpart of
g4s_tpu/models/cantera/transport.py).

Capability match for cantera/src/transport (MixTransport): species
viscosity / thermal conductivity from Chapman-Enskog theory with
Lennard-Jones collision integrals, Wilke mixture rule for viscosity,
and mixture-averaged binary diffusion coefficients. Transport data comes
from the mechanism YAML `transport:` blocks (geometry, well-depth [K],
diameter [A], dipole, polarizability, rotational-relaxation).

Collision integrals use the Neufeld et al. (1972) analytic fits — the
same fits Cantera's MMCollisionInt tabulates.

Every function takes T as a 0-d tensor and x as a (K,) tensor (one
state, as the reference's), runs on their device in their dtype and
composes with torch.func (vmap over states, jvp/jacfwd through the flame
RHS). TransportData is host numpy; its arrays are staged on the caller's
device once per TransportData (`thermo.mech_tensor`, made outside any
transform).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.kinetics import _floor
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.thermo import as_scalar, mech_tensor

KB = 1.380649e-23       # J/K
AVOGADRO = 6.02214076e23


@dataclasses.dataclass(eq=False)
class TransportData:
    geometry: np.ndarray       # 0=atom, 1=linear, 2=nonlinear
    well_depth: np.ndarray     # K
    diameter: np.ndarray       # m
    dipole: np.ndarray         # Debye
    polarizability: np.ndarray  # A^3
    rot_relax: np.ndarray

    @property
    def rot_dof(self) -> np.ndarray:
        """Rotational degrees of freedom / 2 per geometry: 0, 1, 1.5."""
        g = self.geometry
        return np.where(g == 0, 0.0, np.where(g == 1, 1.0, 1.5))


def load_transport(path, mech: Mechanism) -> TransportData:
    from g4s_tpu_torch.models.cantera.mech import _yaml_load
    doc = _yaml_load(path)
    by_name = {s["name"]: s for s in doc["species"]}
    n = mech.nspec
    geom = np.zeros(n)
    eps = np.full(n, 100.0)
    sig = np.full(n, 3.0e-10)
    dip = np.zeros(n)
    pol = np.zeros(n)
    rot = np.ones(n)
    gmap = {"atom": 0, "linear": 1, "nonlinear": 2}
    for name, i in ((s, mech.species_index(s)) for s in mech.species_names):
        tr = by_name.get(name, {}).get("transport")
        if not tr:
            continue
        geom[i] = gmap.get(tr.get("geometry", "linear"), 1)
        eps[i] = float(tr.get("well-depth", 100.0))
        sig[i] = float(tr.get("diameter", 3.0)) * 1e-10
        dip[i] = float(tr.get("dipole", 0.0))
        pol[i] = float(tr.get("polarizability", 0.0))
        rot[i] = float(tr.get("rotational-relaxation", 1.0))
    return TransportData(geom, eps, sig, dip, pol, rot)


def transport_from_reference(fields) -> TransportData:
    """A TransportData from another loader's fields: the reference's
    TransportData (a NamedTuple of numpy arrays) or a dict with its six
    fields. Arrays are copied; a missing or unknown field raises."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    names = [f.name for f in dataclasses.fields(TransportData)]
    if sorted(fields) != sorted(names):
        raise KeyError(f"TransportData fields {sorted(names)}, got "
                       f"{sorted(fields)}")
    return TransportData(**{k: np.array(fields[k], np.float64)
                            for k in names})


def _omega22(t_star):
    """Neufeld fit for the (2,2) reduced collision integral."""
    return (1.16145 * t_star ** -0.14874 + 0.52487 * torch.exp(-0.7732 * t_star)
            + 2.16178 * torch.exp(-2.43787 * t_star))


def _omega11(t_star):
    """Neufeld fit for the (1,1) reduced collision integral."""
    return (1.06036 * t_star ** -0.15610 + 0.19300 * torch.exp(-0.47635 * t_star)
            + 1.03587 * torch.exp(-1.52996 * t_star)
            + 1.76474 * torch.exp(-3.89411 * t_star))


def _offdiag(K: int, like: torch.Tensor) -> torch.Tensor:
    """(K, K) bool, True off the diagonal."""
    return ~torch.eye(K, dtype=torch.bool, device=like.device)


def species_viscosities(mech: Mechanism, tr: TransportData, T):
    """mu_k = 5/16 sqrt(pi m k T) / (pi sigma^2 Omega22)  [Pa s]."""
    m = mech_tensor(mech, "mol_weights", T) / AVOGADRO
    eps = mech_tensor(tr, "well_depth", T)
    sig = mech_tensor(tr, "diameter", T)
    om22 = _omega22(T / eps)
    return (5.0 / 16.0) * torch.sqrt(np.pi * m * KB * T) \
        / (np.pi * sig ** 2 * om22)


def mixture_viscosity(mech: Mechanism, tr: TransportData, T, x):
    """Wilke mixing rule (MixTransport::viscosity)."""
    T = as_scalar(T, x)
    mu = species_viscosities(mech, tr, T)
    W = mech_tensor(mech, "mol_weights", T)
    ratio_mu = mu[:, None] / mu[None, :]
    ratio_w = W[None, :] / W[:, None]
    phi = (1.0 + torch.sqrt(ratio_mu) * ratio_w ** 0.25) ** 2 \
        / torch.sqrt(8.0 * (1.0 + 1.0 / ratio_w))
    denom = phi @ x
    return torch.sum(x * mu / denom)


def binary_diffusion(mech: Mechanism, tr: TransportData, T, P):
    """D_jk matrix (m^2/s) from Chapman-Enskog."""
    m = mech_tensor(mech, "mol_weights", T) / AVOGADRO
    mu_jk = m[:, None] * m[None, :] / (m[:, None] + m[None, :])
    wd = mech_tensor(tr, "well_depth", T)
    dia = mech_tensor(tr, "diameter", T)
    eps = torch.sqrt(wd[:, None] * wd[None, :])
    sig = 0.5 * (dia[:, None] + dia[None, :])
    om11 = _omega11(T / eps)
    return (3.0 / 16.0) * torch.sqrt(2.0 * np.pi * (KB * T) ** 3 / mu_jk) \
        / (np.pi * sig ** 2 * om11 * P)


def mixture_diffusion_coeffs(mech: Mechanism, tr: TransportData, T, P, x):
    """Mixture-averaged D_km (MixTransport::getMixDiffCoeffs)."""
    T = as_scalar(T, x)
    D = binary_diffusion(mech, tr, T, P)
    x = _floor(x, 1e-30)
    W = mech_tensor(mech, "mol_weights", T)
    Wmix = torch.sum(x * W)
    sum_term = torch.sum(torch.where(_offdiag(mech.nspec, x),
                                     x[None, :] / D, 0.0), dim=1)
    return (1.0 - x * W / Wmix) / _floor(sum_term, 1e-30)


def thermal_conductivity(mech: Mechanism, tr: TransportData, T, x, cp_R):
    """Mixture thermal conductivity, modified Eucken per species +
    (sum x_k lam_k + 1/sum(x_k/lam_k))/2 combining rule
    (MixTransport::thermalConductivity)."""
    T = as_scalar(T, x)
    mu = species_viscosities(mech, tr, T)
    W = mech_tensor(mech, "mol_weights", T)
    cv_R = cp_R - 1.0
    cv_trans = 1.5
    cv_rot = mech_tensor(tr, "rot_dof", T)
    cv_vib = _floor(cv_R - cv_trans - cv_rot, 0.0)
    f_trans = 5.0 / 2.0
    f_rot = 1.0
    f_vib = 1.0
    lam_k = mu * R_GAS / W * (f_trans * cv_trans + f_rot * cv_rot
                              + f_vib * cv_vib)
    lam_mix = 0.5 * (torch.sum(x * lam_k)
                     + 1.0 / torch.sum(x / _floor(lam_k, 1e-30)))
    return lam_mix


def stefan_maxwell_velocities(mech: Mechanism, tr: TransportData, T, P,
                              x, grad_x):
    """Exact multicomponent diffusion velocities (the MultiTransport
    role, src/transport/MultiTransport.cpp): solve the Stefan-Maxwell
    system

        grad X_i = sum_{j != i} X_i X_j / D_ij (V_j - V_i),
        sum_k Y_k V_k = 0   (mass-flux closure, replacing one row)

    for the species diffusion velocities V_k [m/s]. Thermal diffusion
    (Soret) lives in `multi_transport.py`."""
    T = as_scalar(T, x)
    K = mech.nspec
    D = binary_diffusion(mech, tr, T, P)
    x = _floor(x, 1e-16)
    x = x / torch.sum(x)
    W = mech_tensor(mech, "mol_weights", T)
    Y = x * W / torch.sum(x * W)
    G = torch.where(_offdiag(K, x), x[:, None] * x[None, :] / D, 0.0)
    # row i of A: sum_j G_ij V_j - (sum_j G_ij) V_i = grad X_i
    A = G - torch.diag(torch.sum(G, dim=1))
    # replace the last row by the closure sum Y_k V_k = 0 (the system is
    # singular: rows sum to zero, like the reference's L-matrix)
    A = torch.cat([A[:-1], Y[None, :]])
    b = torch.cat([grad_x[:-1], torch.zeros_like(grad_x[-1:])])
    return torch.linalg.solve(A, b)


def multi_diff_coeffs(mech: Mechanism, tr: TransportData, T, P, x):
    """Multicomponent diffusion coefficient matrix D_km such that the
    species flux is j_k = rho Y_k V_k with V from unit composition
    gradients (getMultiDiffCoeffs role): column m holds the velocities
    response to grad X_m = e_m - X (projected to sum-zero)."""
    K = mech.nspec
    eye = torch.eye(K, dtype=x.dtype, device=x.device)
    basis = eye - x[None, :]                    # sum-zero gradient probes
    V = torch.func.vmap(lambda g: stefan_maxwell_velocities(
        mech, tr, T, P, x, g))(basis)           # (K probes, K species)
    return V.T                                  # response matrix
