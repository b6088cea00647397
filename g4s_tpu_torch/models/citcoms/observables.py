"""Surface observables and diagnostics (counterpart of
g4s_tpu/models/citcoms/observables.py).

Reference capability: citcoms/lib/Topo_gravity.c (surface/bottom topography
from radial stress, the geoid), heat-flux diagnostics (output_surf_botm surf
heat flux), and the Lenardic-Kaula temperature filter
(Advection_diffusion.c:687 filter()).
"""

from __future__ import annotations

import numpy as np
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


def dynamic_topography(model, state, ops):
    """Surface dynamic topography h = sigma_rr / (rho g) in nondimensional
    units (Topo_gravity.c get_STD_topo role, simplified): the radial normal
    stress at the top surface from the velocity/pressure solution.

    sigma_rr = -p + 2 eta du_r/dr, evaluated on the top element layer and
    averaged to surface nodes.
    """
    cfg = model.cfg
    m = model.mesh
    V = state.V
    # du_r/dr at top via one-sided difference of nodal u_r
    grid_v = V[:, 2].reshape(cfg.nodey, cfg.nodex, cfg.nodez)
    dr = m.r[-1] - m.r[-2]
    durdr = (grid_v[:, :, -1] - grid_v[:, :, -2]) / dr
    # element-constant pressure of the top layer -> surface cells
    P = state.P.reshape(cfg.nodey - 1, cfg.nodex - 1, cfg.nodez - 1)[:, :, -1]
    # average p to nodes (simple 4-cell mean, edges clamped)
    p_node = torch.zeros((cfg.nodey, cfg.nodex), dtype=V.dtype,
                         device=V.device)
    cnt = torch.zeros_like(p_node)
    for dy in (0, 1):
        for dx in (0, 1):
            p_node[dy: cfg.nodey - 1 + dy, dx: cfg.nodex - 1 + dx] += P
            cnt[dy: cfg.nodey - 1 + dy, dx: cfg.nodex - 1 + dx] += 1.0
    p_node = p_node / cnt.clamp(min=1.0)
    sigma_rr = -p_node + 2.0 * durdr   # eta = 1 nondimensional at surface
    return sigma_rr / max(cfg.rayleigh, 1.0)


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


def geoid(model, state, ops, *, lmax=None):
    """Geoid height coefficients (meters) from internal buoyancy and
    boundary dynamic topography (Topo_gravity.c compute_geoid:930-966),
    expanded on the host.

    geoid_from_buoyancy (:586-700): per radial layer, expand the layer-mean
    density anomaly into Y_lm and accumulate
        N_lm += 4 pi G R 1e3 rho_lm dlayer r^(l+2) / (g (2l+1))
    with the nondimensional buoyancy converted to density through
    scaling2 = -therm_exp ref_temperature density / |Ra| (:607-609).
    geoid_from_topography (:753-824): surface/CMB topography contributes
        N_lm += 4 pi G R 1e3 drho h_lm / (g (2l+1))  (x ri^(l+2) at CMB).
    Degree 0 and 1 are skipped as in the reference.

    Returns dict of (clm_cos, clm_sin) pairs: "from_buoyancy",
    "from_topo", "total".
    """
    from g4s_tpu_torch.models.citcoms.sphere_harmonics import sph_expand

    cfg = model.cfg
    lmax = cfg.llmax if lmax is None else lmax
    m = model.mesh
    noy, nox, noz = cfg.nodey, cfg.nodex, cfg.nodez
    theta = np.asarray(m.theta)
    fi = np.asarray(m.fi)
    r = np.asarray(m.r)
    radius_m = cfg.radius_km * 1e3
    scaling = 4.0 * np.pi * 1e3 * cfg.radius_km * cfg.grav_const \
        / cfg.grav_acc
    # nondimensional buoyancy -> dimensional density (rho = buoy*scaling2/g)
    scaling2 = (-cfg.therm_exp * cfg.ref_temperature * cfg.density
                / max(abs(cfg.rayleigh), 1e-300))

    buoy = model.buoyancy(state.T).cpu().numpy().reshape(noy, nox, noz)
    zc = np.zeros((lmax + 1, lmax + 1))
    g_cos, g_sin = zc.copy(), zc.copy()
    for k in range(noz - 1):
        rho_layer = 0.5 * (buoy[:, :, k] + buoy[:, :, k + 1]) * scaling2
        # sph_expand takes (n_theta, n_fi); the grid is (y=fi, x=theta)
        cc, ss = sph_expand(rho_layer.T, theta, fi, lmax)
        dlayer = (r[k + 1] - r[k]) * radius_m
        radius = 0.5 * (r[k + 1] + r[k])
        for ll in range(2, lmax + 1):
            con = scaling * dlayer * radius ** (ll + 2) / (2.0 * ll + 1.0)
            g_cos[ll] += con * cc[ll]
            g_sin[ll] += con * ss[ll]

    # topography contribution: h in meters from the nondim sigma_rr/Ra
    # (h_m = h_nd * R * rho alpha dT / drho, see dynamic_topography scaling)
    den1 = cfg.density - cfg.density_above
    h_nd = dynamic_topography(model, state, ops).cpu().numpy()
    h_m = h_nd * radius_m * (cfg.density * cfg.therm_exp
                             * cfg.ref_temperature) / den1
    tc, ts = sph_expand(h_m.T, theta, fi, lmax)
    t_cos, t_sin = zc.copy(), zc.copy()
    for ll in range(2, lmax + 1):
        con = den1 * scaling / (2.0 * ll + 1.0)
        t_cos[ll] = con * tc[ll]
        t_sin[ll] = con * ts[ll]
    return {"from_buoyancy": (g_cos, g_sin),
            "from_topo": (t_cos, t_sin),
            "total": (g_cos + t_cos, g_sin + t_sin)}
