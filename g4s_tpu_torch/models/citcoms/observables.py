"""Surface observables and diagnostics (counterpart of part of
g4s_tpu/models/citcoms/observables.py; dynamic topography and the geoid
need the spherical-harmonics module and come with it).

Reference capability: heat-flux diagnostics (output_surf_botm surf heat
flux) and the Lenardic-Kaula temperature filter
(Advection_diffusion.c:687 filter()).
"""

from __future__ import annotations

import torch


def surface_heat_flux(model, T, *, top: bool = True):
    """Conductive heat flux through the top (or bottom) surface and the
    Nusselt number (heat-flow diagnostics of output_surf_botm).

    q = -dT/dr evaluated from the outermost node layer pair; Nu is q
    normalized by the conductive flux of the reference profile.
    """
    cfg = model.cfg
    grid = T.reshape(cfg.nodey, cfg.nodex, cfg.nodez)
    r = model.mesh.r
    if top:
        dr = r[-1] - r[-2]
        q = -(grid[:, :, -1] - grid[:, :, -2]) / dr
    else:
        dr = r[1] - r[0]
        q = -(grid[:, :, 1] - grid[:, :, 0]) / dr
    ri, ro = cfg.radius_inner, cfg.radius_outer
    # conductive reference: linear profile dT/dr = -(Tbot)/(ro-ri)
    q_cond = (cfg.bottbcval - cfg.toptbcval) / (ro - ri)
    return q, q.mean() / q_cond


def rms_velocity(model, V):
    """Volume-RMS velocity (the v_norm monitor, global_v_norm2)."""
    return torch.sqrt(torch.sum(V * V * model.nmass[:, None])
                      / model.total_volume)


def filter_temperature(T, tbc_mask, tbc_val):
    """Lenardic & Kaula overshoot filter (Advection_diffusion.c:687):
    clip T to [0,1] while conserving the total heat content."""
    free = ~tbc_mask
    total0 = torch.where(free, T, 0.0).sum()
    Tc = T.clamp(0.0, 1.0)
    # redistribute the clipped energy over interior unclipped free nodes
    interior = free & (Tc > 0.0) & (Tc < 1.0)
    n_free = interior.sum().clamp(min=1)
    correction = (total0 - torch.where(free, Tc, 0.0).sum()) / n_free
    Tf = torch.where(interior, Tc + correction, Tc)
    return torch.where(tbc_mask, tbc_val, Tf)


def max_interior_temperature(T, tbc_mask):
    """Tmaxd over non-BC nodes (monitor.T_interior)."""
    return torch.where(tbc_mask, float("-inf"), T).max()
