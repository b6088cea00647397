"""Lithosphere-age thermal structure (counterpart of
g4s_tpu/models/citcoms/lith_age.py, the reference's Lith_age.c; numpy and
scipy on the host, once at model build or once per step).

lith_age_construct_tic (Lith_age.c:130-145): within lith_age_depth of the
surface the initial temperature follows half-space cooling,
    T = mantle_temp * erf((ro - r) / (2 sqrt(age)))
with per-surface-node ages; below, T = mantle_temp.
lith_age_temperature_bound_adj (:186-258): nodes within lith_age_depth of
the top are held at that profile as essential thermal BCs.

Ages are nondimensionalized by the diffusion time scale: age_nd =
age_Myr * (Myr in s) * kappa / R^2 (data.scalet role, Instructions.c:913).
"""

from __future__ import annotations

import numpy as np

_MYR_S = 1.0e6 * 365.25 * 24 * 3600


def age_to_nondim(cfg, age_myr):
    """Myr -> diffusion-time units (R^2 / kappa)."""
    R = cfg.radius_km * 1e3
    kappa = getattr(cfg, "therm_diff", 1e-6)
    return np.asarray(age_myr) * _MYR_S * kappa / (R * R)


def read_age_file(path, nsf: int) -> np.ndarray:
    """Plain-text ages in Myr, one per surface node (gnox*gnoy values,
    Lith_age.c:100-109 fscanf loop)."""
    vals = np.loadtxt(path).ravel()
    if vals.size < nsf:
        raise ValueError(f"age file has {vals.size} entries, need {nsf}")
    return vals[:nsf]


def _profile(cfg, r, age_nd_surf):
    """T at nodes given per-column surface ages (noy*nox,)."""
    from scipy.special import erf
    noz = cfg.nodez
    depth = cfg.radius_outer - r                      # (nno,)
    age_col = np.repeat(np.maximum(age_nd_surf, 1e-12), noz)
    arg = depth * 0.5 / np.sqrt(age_col)
    T = cfg.mantle_temp * erf(arg)
    return np.where(depth <= cfg.lith_age_depth, T, cfg.mantle_temp)


def lith_age_tic(cfg, mesh, age_nd_surf) -> np.ndarray:
    """Initial nodal temperature (lith_age_construct_tic)."""
    return _profile(cfg, np.asarray(mesh.sx[:, 2]), age_nd_surf)


def lith_age_tbc(cfg, mesh, age_nd_surf, tbc_mask, tbc_val):
    """Pin nodes within lith_age_depth of the surface to the half-space
    profile (lith_age_temperature_bound_adj). Takes and returns host
    arrays (tbc_mask, tbc_val)."""
    r = np.asarray(mesh.sx[:, 2])
    in_lith = (cfg.radius_outer - r) <= cfg.lith_age_depth
    Tprof = _profile(cfg, r, age_nd_surf)
    mask = np.asarray(tbc_mask) | in_lith
    val = np.where(in_lith, Tprof, np.asarray(tbc_val))
    return mask, val
