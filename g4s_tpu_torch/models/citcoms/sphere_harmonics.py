"""Spherical-harmonic expansion of surface fields (the port's own copy of
g4s_tpu/models/citcoms/sphere_harmonics.py, numpy and scipy only).

Reference capability: citcoms/lib/Sphere_harmonics.c (sphere_expansion of
surface fields into Y_lm coefficients, used by the geoid/topography
outputs) and Sphere_util.c. This is a postprocessing path, so it runs
host-side on numpy with scipy's associated Legendre functions; the
quadrature is the same node-area weighting the reference uses.

Conventions: real spherical harmonics,
  f(t, p) = sum_l sum_{m=0..l} [ clm_cos Y_lm cos(m p) + clm_sin ... ]
with orthonormalized associated Legendre P_lm (4-pi normalized like the
reference's modified_plgndr_a).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _plm_norm(lmax: int, costheta: np.ndarray) -> np.ndarray:
    """Orthonormalized associated Legendre P_lm(cos t): (lmax+1, lmax+1, n).

    Normalization: int Y_lm^2 dOmega = 1 with
    Y_lm = P_lm(cos t) * {cos,sin}(m p) (extra sqrt(2) folded into P for
    m>0)."""
    from scipy.special import lpmv
    n = costheta.shape[0]
    out = np.zeros((lmax + 1, lmax + 1, n))
    from math import factorial, pi, sqrt
    for l in range(lmax + 1):
        for m in range(l + 1):
            norm = sqrt((2 * l + 1) / (4 * pi)
                        * factorial(l - m) / factorial(l + m))
            if m > 0:
                norm *= sqrt(2.0)
            out[l, m] = norm * lpmv(m, l, costheta)
    return out


def sph_expand(field: np.ndarray, theta: np.ndarray, fi: np.ndarray,
               lmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expand field (n_theta, n_fi) sampled on a tensor grid into real
    Y_lm coefficients (sphere_expansion semantics).

    Returns (clm_cos, clm_sin), each (lmax+1, lmax+1).
    """
    th = np.asarray(theta)
    ph = np.asarray(fi)
    # trapezoid quadrature weights with the sin(theta) area factor
    wt = np.gradient(th) * np.sin(th)
    wt[0] *= 0.5
    wt[-1] *= 0.5
    wp = np.gradient(ph)
    wp[0] *= 0.5
    wp[-1] *= 0.5
    P = _plm_norm(lmax, np.cos(th))                  # (l, m, nt)
    ms = np.arange(lmax + 1)
    cosmp = np.cos(ms[:, None] * ph[None, :])        # (m, np)
    sinmp = np.sin(ms[:, None] * ph[None, :])
    fw = field * wt[:, None] * wp[None, :]           # (nt, np)
    # clm = sum_t sum_p f w P_lm(t) trig(m p)
    tmp_c = fw @ cosmp.T                             # (nt, m)
    tmp_s = fw @ sinmp.T
    clm_cos = np.einsum("lmt,tm->lm", P, tmp_c)
    clm_sin = np.einsum("lmt,tm->lm", P, tmp_s)
    return clm_cos, clm_sin


def sph_eval(clm_cos: np.ndarray, clm_sin: np.ndarray,
             theta: np.ndarray, fi: np.ndarray) -> np.ndarray:
    """Reconstruct the field from coefficients on a tensor grid."""
    lmax = clm_cos.shape[0] - 1
    P = _plm_norm(lmax, np.cos(np.asarray(theta)))
    ms = np.arange(lmax + 1)
    cosmp = np.cos(ms[:, None] * np.asarray(fi)[None, :])
    sinmp = np.sin(ms[:, None] * np.asarray(fi)[None, :])
    # f = sum_lm P_lm(t) [c cos + s sin](m p)
    gc = np.einsum("lm,lmt->mt", clm_cos, P)
    gs = np.einsum("lm,lmt->mt", clm_sin, P)
    return gc.T @ cosmp + gs.T @ sinmp
