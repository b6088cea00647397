"""Phase-transition buoyancy (counterpart of
g4s_tpu/models/citcoms/phase_change.py, the reference's Phase_change.c).

calc_phase_change (Phase_change.c:156-196): the high-pressure-phase
concentration is a tanh profile of the reduced pressure
    e_p = (r_outer - r - depth) * rho * g - clapeyron * (T - transT)
    B   = (1 + tanh(e_p / width)) / 2
and phase_change_apply (:132-153) subtracts Ra_phase * B from the
buoyancy field. Three transitions are supported (410 km, 670 km, CMB),
enabled by their nonzero Rayleigh numbers (phase_change_input:66-99).
Boussinesq reference state: rho = g = 1.

phase_boundary computes the B = 0.5 crossing radius per vertical column
(Phase_change.c:182-193), the diagnostic the reference writes out.
"""

from __future__ import annotations

import numpy as np
import torch


def phase_function(cfg, r, T, clapeyron, depth, transT, width):
    """B in [0, 1]; r, T are nodal tensors."""
    e_p = (cfg.radius_outer - r - depth) - clapeyron * (T - transT)
    return 0.5 * (1.0 + torch.tanh(e_p / width))


def _transitions(cfg):
    out = []
    for tag, zdef in (("410", 0.06434), ("670", 0.1036), ("cmb", 0.45)):
        Ra = getattr(cfg, f"Ra_{tag}", 0.0)
        if Ra != 0.0:
            out.append((Ra,
                        getattr(cfg, f"clapeyron{tag}", 0.0),
                        getattr(cfg, f"z_{tag}", zdef),
                        getattr(cfg, f"transT{tag}", 0.0),
                        getattr(cfg, f"width{tag}", 0.0058)))
    return out


def apply_phase_changes(cfg, r, T, buoy):
    """buoy -= sum_phases Ra_phase * B_phase (phase_change_apply_410/670/
    cmb, Phase_change.c:103-129). No-op unless some Ra_* is nonzero."""
    for (Ra, clap, depth, transT, width) in _transitions(cfg):
        buoy = buoy - Ra * phase_function(cfg, r, T, clap, depth,
                                          transT, width)
    return buoy


def phase_boundary(cfg, B):
    """Radius of the B = 0.5 crossing per (y, x) column, on the host.

    B: (nno,) nodal phase function on the regional tensor grid (a tensor
    or an array). Returns (noy, nox) crossing radii (0 where no crossing).
    """
    noy, nox, noz = cfg.nodey, cfg.nodex, cfg.nodez
    if isinstance(B, torch.Tensor):
        B = B.detach().cpu().numpy()
    Bg = np.asarray(B).reshape(noy, nox, noz)
    r = np.linspace(cfg.radius_inner, cfg.radius_outer, noz)
    out = np.zeros((noy, nox))
    # scan from the top down: B increases with depth, crossing where
    # B[k] >= 0.5 and B[k+1] <= 0.5 in bottom-up node order
    for k in range(noz - 1):
        hit = (Bg[:, :, k] >= 0.5) & (Bg[:, :, k + 1] <= 0.5)
        frac = (0.5 - Bg[:, :, k]) / (Bg[:, :, k + 1] - Bg[:, :, k] + 1e-300)
        rc = r[k] + (r[k + 1] - r[k]) * frac
        out = np.where(hit & (out == 0.0), rc, out)
    return out
