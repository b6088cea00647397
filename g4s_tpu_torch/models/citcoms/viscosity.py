"""Viscosity laws at element quadrature points (counterpart of
g4s_tpu/models/citcoms/viscosity.py).

Reference: citcoms/lib/Viscosity_structures.c — visc_from_mat (:415-430),
visc_from_T rheol cases (:440-640; default rheol=3: eta = N0 *
exp(E/(T+T0) - E/(1+T0)) with nodal T clipped to [0,1], :554-586),
strain-rate weakening visc_from_S (:660-700: eta *= (eta/e_II)^((n-1)/n)),
min/max clipping, and material-layer assignment (Construct_arrays.c
construct_mat_group + the depth-based `layers()` with default boundaries
z_lith=0.0157 / z_410=0.0643 / z_lmantle=0.1036, Instructions.c:422-425).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms.config import CitcomConfig


def element_materials(cfg: CitcomConfig, e_center_r: np.ndarray,
                      radius_outer: float) -> np.ndarray:
    """0-based material index per element from depth layers."""
    depth = radius_outer - np.asarray(e_center_r)
    bounds = np.array([0.0156961230576048, 0.0643541045361796,
                       0.103594412180191])
    mat = np.searchsorted(bounds, depth)          # 0..3
    return np.minimum(mat, max(cfg.num_mat, 1) - 1).astype(np.int32)


def cdepv_prefactor(cfg, C_nodes, ien, N):
    """Compositional geometric-mean viscosity prefactor
    (visc_from_C, Viscosity_structures.c:1110-1155): per vpt,
    vmean = exp((1 - C) ln ff0 + C ln ff1) for the single-component
    ratio method (background flavor 0, dense flavor 1)."""
    C_g = torch.einsum("ea,ag->eg", C_nodes[ien], N).clamp(0.0, 1.0)
    ff = [float(x) for x in cfg.cdepv_ff[:2]]
    return torch.exp((1.0 - C_g) * math.log(ff[0]) + C_g * math.log(ff[1]))


def viscosity_at_vpts(cfg: CitcomConfig, mat, T_nodes, ien, N,
                      strain_rate_II=None, C_nodes=None, r_nodes=None):
    """eta at (nel, 8 gauss points).

    mat: (nel,) int64; T_nodes: (nno,); N: (8a, 8g). With C_nodes and
    cfg.CDEPV the compositional prefactor multiplies in; r_nodes (nno,)
    feeds the plastic yield stress of PDEPV.
    """
    dt, dev = T_nodes.dtype, T_nodes.device

    def per_mat(vals):
        # config constants adopt the state dtype so the f32 path stays f32,
        # written on the device by fills (a tensor made from the list on
        # the host would be a copy that waits for the device); a material
        # past the vector's end takes its last entry, as the reference's
        # clamping gather does (a CitcomConfig built directly can hold
        # fewer entries than num_mat)
        per = torch.empty(len(vals), dtype=dt, device=dev)
        for i, v in enumerate(vals):
            per[i:i + 1].fill_(float(v))
        return per[mat.clamp(max=len(vals) - 1)]

    n0 = per_mat(cfg.visc0)                                 # (nel,)
    if not cfg.TDEPV:
        eta = n0[:, None].expand(mat.shape[0], N.shape[1])
    else:
        T_el = T_nodes[ien].clamp(0.0, 1.0)                 # (nel, 8a)
        T_g = torch.einsum("ea,ag->eg", T_el, N)            # (nel, 8g)
        eE = per_mat(cfg.viscE)[:, None]
        tT = per_mat(cfg.viscT)[:, None]
        zZ = per_mat(cfg.viscZ)[:, None]
        if cfg.rheol == 0:
            # eta = N0 exp(E*(1-T))  (case 0, :443-470 variant)
            eta = n0[:, None] * torch.exp(eE * (1.0 - T_g))
        elif cfg.rheol == 1:
            # eta = N0 exp(E/(T+T0))  (case 1)
            eta = n0[:, None] * torch.exp(
                torch.where(eE == 0.0, 0.0, eE / (T_g + tT)))
        elif cfg.rheol == 2:
            # eta = N0 exp(-T/T0)  (case 2 shape: N0 exp(A - T*E))
            eta = n0[:, None] * torch.exp(-T_g * eE)
        elif cfg.rheol == 4:
            # eta = N0 exp((E + (1-z) Z0)/(T+T0) - (E+Z0)/(1+T0))
            # needs depth at gauss points; approximated at element level
            eta = n0[:, None] * torch.exp(
                torch.where(eE + zZ == 0.0, 0.0,
                            (eE + zZ) / (T_g + tT) - (eE + zZ) / (1.0 + tT)))
        else:
            # rheol 3 (default): eta = N0 exp(E/(T+T0) - E/(1+T0))
            eta = n0[:, None] * torch.exp(
                torch.where(eE == 0.0, 0.0,
                            eE / (T_g + tT) - eE / (1.0 + tT)))
    if cfg.SDEPV and strain_rate_II is not None:
        n = per_mat(cfg.sdepv_expt)[:, None]
        eta = eta * torch.pow(eta / strain_rate_II.clamp(min=1e-32),
                              (n - 1.0) / n)
    if cfg.CDEPV and C_nodes is not None:
        eta = eta * cdepv_prefactor(cfg, C_nodes, ien, N)
    if cfg.PDEPV and strain_rate_II is not None and r_nodes is not None:
        # plasticity (visc_from_P, Viscosity_structures.c:951):
        # sigma_y = min(a + b (1-r), y); eta_y = sigma_y / (2 epsII);
        # eta_eff = harmonic(eta, eta_y) or min(eta, eta_y)
        r_g = torch.einsum("ea,ag->eg", r_nodes[ien], N)
        a = per_mat(cfg.pdepv_a)[:, None]
        b = per_mat(cfg.pdepv_b)[:, None]
        y = per_mat(cfg.pdepv_y)[:, None]
        sigma_y = torch.minimum(a + b * (cfg.radius_outer - r_g), y)
        eta_y = sigma_y / (2.0 * strain_rate_II).clamp(min=1e-32)
        if cfg.pdepv_eff:
            eta = eta * eta_y / (eta + eta_y)
        else:
            eta = torch.minimum(eta, eta_y)
    if cfg.VMIN:
        eta = eta.clamp(min=cfg.visc_min)
    if cfg.VMAX:
        eta = eta.clamp(max=cfg.visc_max)
    return eta


def strain_rate_2inv(B, ien, V, *, sqrt=True):
    """Second invariant of the strain rate at elements
    (strain_rate_2_inv, Viscosity_structures.c:1158+): eps from the B
    tensor, invariant = sum(eps_n^2) + 0.5 sum(gamma_s^2) averaged over
    gauss points; sqrt=False returns the square (the viscous-heating
    form)."""
    eps = torch.einsum("egsai,eai->egs", B, V[ien])         # (nel, 8g, 6)
    ee = ((eps[..., :3] ** 2).sum(-1)
          + 0.5 * (eps[..., 3:] ** 2).sum(-1))              # (nel, 8g)
    val = ee.mean(dim=1)
    return torch.sqrt(val) if sqrt else val
