"""Mineral-physics seismic models (counterpart of
g4s_tpu/models/citcoms/mineral_physics.py, the reference's
Mineral_physics_models.c; numpy on the host).

get_prem (Mineral_physics_models.c:40-155): PREM (Dziewonski & Anderson
1981, as tabulated for specfem) piecewise cubic polynomials in
normalized radius for Vp, Vs, rho; radius clamped to the CMB.
modified_Trampert_Vacher_Vlaar_PEPI2001 (:158-232): temperature and
composition anomalies converted to relative seismic-velocity/density
anomalies via depth-dependent sensitivities (Trampert, Vacher & Vlaar,
PEPI 2001, Table 2 — quasi-harmonic + anelastic), anchored on the PREM
radial profile:

  rho = rho_PREM (1 + drho),  vp = vp_PREM (1 + dvp),  vs likewise
  drho = -dT alpha + dC ratio refT alpha / rho_ref
  dvp  = dT (a0 + a1 d + a2 d^2) + dC (...)     [d = depth in km]
"""

from __future__ import annotations

import numpy as np

from g4s_tpu_torch.models.citcoms.output import host

# PREM layer radii (normalized; specfem convention, innermost first)
_PREM_RADIUS = np.array([
    0.19164966253335425, 0.54622508240464607, 0.56976926699105324,
    0.87898289122586726, 0.89483597551404803, 0.90582326165437133,
    0.93721550776958096, 0.96546852927326954, 0.99617014597394449,
    0.99764558154135929, 1.0])
_J_CMB = 1

_PREM_VS = np.array([
    [3.6678, 0.0, -4.4475, 0.0],
    [0.0010, 0.0, 0.0, 0.0],
    [6.9254, 1.4672, -2.0834, 0.9783],
    [11.1671, -13.7818, 17.4575, -9.2777],
    [22.3459, -17.2473, -2.0834, 0.9783],
    [9.9839, -4.9324, 0.0, 0.0],
    [22.3512, -18.5856, 0.0, 0.0],
    [8.9496, -4.4597, 0.0, 0.0],
    [2.1519, 2.3481, 0.0, 0.0],
    [3.9000, 0.0, 0.0, 0.0],
    [3.2000, 0.0, 0.0, 0.0]])

_PREM_VP = np.array([
    [11.2622, 0.0, -6.3640, 0.0],
    [11.0487, -4.0362, 4.8023, -13.5732],
    [15.3891, -5.3181, 5.5242, -2.5514],
    [24.9520, -40.4673, 51.4832, -26.6419],
    [29.2766, -23.6027, 5.5242, -2.5514],
    [19.0957, -9.8672, 0.0, 0.0],
    [39.7027, -32.6166, 0.0, 0.0],
    [20.3926, -12.2569, 0.0, 0.0],
    [4.1875, 3.9382, 0.0, 0.0],
    [6.8000, 0.0, 0.0, 0.0],
    [5.8000, 0.0, 0.0, 0.0]])

_PREM_RHO = np.array([
    [13.0885, 0.0, -8.8381, 0.0],
    [12.5815, -1.2638, -3.6426, -5.5281],
    [7.9565, -6.4761, 5.5283, -3.0807],
    [7.9565, -6.4761, 5.5283, -3.0807],
    [7.9565, -6.4761, 5.5283, -3.0807],
    [5.3197, -1.4836, 0.0, 0.0],
    [11.2494, -8.0298, 0.0, 0.0],
    [7.1089, -3.8045, 0.0, 0.0],
    [2.6910, 0.6924, 0.0, 0.0],
    [2.9000, 0.0, 0.0, 0.0],
    [2.6000, 0.0, 0.0, 0.0]])

# Trampert-Vacher-Vlaar PEPI 2001 Table 2 sensitivities (per K, per km^n)
_DLNVP_DT = (-5.71e-5, 2.44e-8, -3.84e-12)
_DLNVS_DT = (-9.37e-5, 3.70e-8, -5.46e-12)
_DLNVP_DC = (1.72e-1, -0.98e-4, 1.44e-8)
_DLNVS_DC = (1.50e-1, -1.43e-4, 1.92e-8)


def get_prem(r):
    """(vp, vs, rho) [km/s, km/s, g/cm^3] at normalized radius r
    (scalar or array); clamped to the CMB like the reference."""
    r = np.maximum(np.asarray(r, np.float64), _PREM_RADIUS[_J_CMB])
    j = np.searchsorted(_PREM_RADIUS, r, side="right")
    j = np.clip(j, 0, len(_PREM_RADIUS) - 1)
    powers = np.stack([np.ones_like(r), r, r * r, r ** 3], axis=-1)
    vp = np.sum(_PREM_VP[j] * powers, axis=-1)
    vs = np.sum(_PREM_VS[j] * powers, axis=-1)
    rho = np.sum(_PREM_RHO[j] * powers, axis=-1)
    return vp, vs, rho


def _poly(coef, d):
    return coef[0] + coef[1] * d + coef[2] * d * d


def seismic_model(model, T, C=None):
    """Nodal (rho, vp, vs) via the modified TVV scaling.

    T: (nno,) nondimensional temperature; C: optional (nno,) composition
    (tensors on the model's device or host arrays; the result is host
    numpy).
    Deviations are taken from the horizontal averages (compute_horiz_avg)
    and dimensionalized by cfg.ref_temperature.
    """
    cfg = model.cfg
    noz = cfg.nodez
    T = host(T)
    nno = T.shape[0]
    layer = np.arange(nno) % noz
    w = host(model._layer_weights)
    wsum = np.bincount(layer, weights=w, minlength=noz)
    Tave = np.bincount(layer, weights=T * w, minlength=noz) / wsum
    r_layers = np.asarray(model.mesh.r)
    vpr, vsr, rhor = get_prem(r_layers)
    depth = (1.0 - r_layers) * cfg.radius_km
    d = depth[layer]
    dT = (T - Tave[layer]) * cfg.ref_temperature
    drho = -dT * cfg.therm_exp
    dvp = dT * _poly(_DLNVP_DT, d)
    dvs = dT * _poly(_DLNVS_DT, d)
    if C is not None:
        C = host(C)
        Cave = np.bincount(layer, weights=C * w, minlength=noz) / wsum
        dC = C - Cave[layer]
        drho = drho + dC * cfg.buoyancy_ratio * cfg.ref_temperature \
            * cfg.therm_exp
        dvp = dvp + dC * _poly(_DLNVP_DC, d)
        dvs = dvs + dC * _poly(_DLNVS_DC, d)
    return (rhor[layer] * (1 + drho), vpr[layer] * (1 + dvp),
            vsr[layer] * (1 + dvs))
