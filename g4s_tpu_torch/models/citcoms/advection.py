"""SUPG (streamline-upwind Petrov-Galerkin) energy equation (counterpart
of g4s_tpu/models/citcoms/advection.py).

Predictor-corrector advection-diffusion of temperature, following
citcoms/lib/Advection_diffusion.c:
  - std_timestep (:140-194): advective CFL from element-center velocities
    and physical element sizes, combined with the diffusive limit
    0.5*min(size^2) (:316-336), scaled by finetunedt.
  - predictor/corrector (:345-388): T* = T + (1-gamma) dt Tdot; Tdot = 0;
    then per sub-iteration DTdot = M^-1 R, T += gamma dt DTdot,
    Tdot += DTdot.
  - pg_shape_fn (:459-518): streamline diffusion factor from element Peclet
    numbers; PG_a = N_a + adiff * (u . grad N_a).
  - element_residual (:525-685): R_a = -sum_g PG_a dOmega (Tdot + u.grad T
    - Q) - diff * grad N_a . grad T, with Tdot treated as 0 at TBC nodes.
  - lumped-mass scaling + zero at TBC nodes (pg_solver :435-450).

All gradients are physical spherical gradients ((1/r) d/dth,
1/(r sin th) d/dfi, d/dr); velocities are spherical components interpolated
as scalars at gauss points (velo_from_element with sphere_key=1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms.assembly import ScatterPlan
from g4s_tpu_torch.models.citcoms.shapes import (_GAUSS, _PPOINT, shape_dn,
                                                 shape_n)
from g4s_tpu_torch.models.citcoms.solvers import host_true


class AdvectionGeometry(NamedTuple):
    """Static per-element tensors for the energy solver (host-built)."""
    N: torch.Tensor          # (8a, 8g)
    N_center: torch.Tensor   # (8a, 1) shape fns at element center (ppt)
    gweight: torch.Tensor    # (8g,)
    gda: torch.Tensor        # (nel, 8g)
    gradN: torch.Tensor      # (nel, 8g, 3, 8a) physical gradient of N
    e_size: torch.Tensor     # (nel, 3) physical element lengths
    tmass: torch.Tensor      # (nno,) inverse lumped mass
    diff_dt: torch.Tensor    # scalar: diffusive timestep limit


def build_advection_geometry(geo, mesh, tmass) -> AdvectionGeometry:
    """Assemble static advection tensors from shapes.FEMGeometry, in
    tmass's dtype and on its device (built in f64 on the host, then cast,
    as the reference does)."""
    # physical gradient of N at gauss pts: rows ((1/r) d/dth, 1/(r s) d/dfi, d/dr)
    coords = mesh.sx[mesh.ien]
    dth = coords[:, 1, 0] - coords[:, 0, 0]
    dfi = coords[:, 3, 1] - coords[:, 0, 1]
    dr = coords[:, 4, 2] - coords[:, 0, 2]
    half = 0.5 * np.stack([dth, dfi, dr], axis=1)
    dN = shape_dn(_GAUSS)                                  # (8a, 8g, 3)
    gnx = dN[None] / half[:, None, None, :]                # (nel, 8a, 8g, 3)
    rtf = geo.rtf
    ra = 1.0 / rtf[:, :, 2]
    isi = 1.0 / np.sin(rtf[:, :, 0])
    grad = np.stack([
        gnx[:, :, :, 0].transpose(0, 2, 1) * ra[:, :, None],
        gnx[:, :, :, 1].transpose(0, 2, 1) * (ra * isi)[:, :, None],
        gnx[:, :, :, 2].transpose(0, 2, 1),
    ], axis=2)                                             # (nel, 8g, 3, 8a)
    diff_dt = 0.5 * float((mesh.e_size ** 2).min())

    def to(x):
        return torch.as_tensor(np.asarray(x), dtype=tmass.dtype,
                               device=tmass.device)

    return AdvectionGeometry(
        to(geo.N), to(shape_n(_PPOINT)), to(geo.gweight), to(geo.gda),
        to(grad), to(mesh.e_size), tmass, to(diff_dt))


def element_velocities(adv: AdvectionGeometry, ien, V):
    """V at element nodes (nel, 8a, 3) spherical components."""
    return V[ien]


def cfl_timestep(adv: AdvectionGeometry, ien, V, *, finetunedt: float,
                 fixed_timestep: float = 0.0):
    """std_timestep: dt = min(finetunedt * 0.5/max_e(sum |u_c|/size),
    diff_dt)."""
    if fixed_timestep != 0.0:
        return torch.full((), fixed_timestep, dtype=V.dtype, device=V.device)
    vv = element_velocities(adv, ien, V)                   # (nel, 8, 3)
    uc = torch.einsum("eai,a->ei", vv, adv.N_center[:, 0])  # center velocity
    rate = (uc.abs() / adv.e_size).sum(dim=1)              # (nel,)
    step = 0.5 / rate.max()
    return 1.0e-32 + torch.minimum(finetunedt * step, adv.diff_dt)


def pg_residual(adv: AdvectionGeometry, ien, plan: ScatterPlan,
                T, Tdot, V, diff, Q0, tbc_mask):
    """One SUPG residual evaluation -> DTdot (pg_solver)."""
    vv = element_velocities(adv, ien, V)                   # (nel, 8a, 3)
    uc = torch.einsum("eai,a->ei", vv, adv.N_center[:, 0])  # (nel, 3)

    twodiff = 2.0 * diff
    u_l = uc.abs() * adv.e_size                            # (nel, 3)
    xse = torch.where(u_l > twodiff, 1.0 - twodiff / u_l, 0.0)
    unorm = (uc * uc).sum(dim=1)
    adiff = torch.where(unorm > 1e-6,
                        (u_l * xse).sum(dim=1) / (2.0 * unorm), 0.0)

    u_g = torch.einsum("eai,ag->egi", vv, adv.N)           # (nel, 8g, 3)
    # u . grad N  (nel, 8g, 8a)
    ugn = torch.einsum("egi,egia->ega", u_g, adv.gradN)
    PG = adv.N.T[None] + adiff[:, None, None] * ugn        # (nel, 8g, 8a)

    T_el = T[ien]                                          # (nel, 8a)
    Td_el = torch.where(tbc_mask, 0.0, Tdot)[ien]
    dT_g = torch.einsum("ea,ag->eg", Td_el, adv.N)
    gT = torch.einsum("ea,egia->egi", T_el, adv.gradN)     # grad T at gauss
    adv_term = torch.einsum("egi,egi->eg", u_g, gT)

    wg = adv.gda * adv.gweight[None, :]
    res_adv = -torch.einsum("ega,eg,eg->ea", PG, wg, dT_g + adv_term - Q0)
    res_diff = -diff * torch.einsum("egia,egi,eg->ea", adv.gradN, gT, wg)
    Eres = res_adv + res_diff                              # (nel, 8a)

    DTdot = plan.scatter(Eres[:, :, None])[:, 0]
    return torch.where(tbc_mask, 0.0, DTdot * adv.tmass)


def pg_timestep(adv: AdvectionGeometry, ien, plan: ScatterPlan,
                T, Tdot, V, dt, *, diff, Q0, gamma, sub_iterations,
                tbc_mask, tbc_val):
    """One full predictor-corrector temperature step (PG_timestep_solve
    without the max-T subcycling guard; the driver wraps that)."""
    T = T + (1.0 - gamma) * dt * Tdot
    Tdot = torch.zeros_like(Tdot)
    for _ in range(sub_iterations):
        DTdot = pg_residual(adv, ien, plan, T, Tdot, V, diff, Q0, tbc_mask)
        T = T + gamma * dt * DTdot
        Tdot = Tdot + DTdot
        T = torch.where(tbc_mask, tbc_val, T)    # temperatures_conform_bcs
    return T, Tdot


def advect_monitored(advect, T0, dt0, tbc_mask, monitor: bool, *,
                     reduce_max=None):
    """Max-T guard: redo `advect(dt) -> (T, Tdot)` with halved dt while the
    interior maximum grows past T_maxvaried=1.05 (PG_timestep_solve
    do/while, Advection_diffusion.c:234-280; at most 5 retries).
    reduce_max(x) -> the largest entry of x (default x.max(); a sharded
    model passes its all-rank maximum). Returns (T, Tdot, dt_used)."""
    if not monitor:
        T, Tdot = advect(dt0)
        return T, Tdot, dt0
    if reduce_max is None:
        reduce_max = torch.amax

    def interior_max(T):
        return reduce_max(torch.where(tbc_mask, float("-inf"), T))

    T_int0 = interior_max(T0).clamp(min=1e-30)
    T, Tdot = advect(dt0)
    dt, tries = dt0, 0
    while tries < 5 and host_true(interior_max(T) / T_int0 > 1.05):
        dt = dt * 0.5
        T, Tdot = advect(dt)
        tries += 1
    return T, Tdot, dt
