"""Tracer advection + composition (counterpart of
g4s_tpu/models/citcoms/tracers.py, the reference's particle subsystem).

Reference capability: citcoms/lib/Regional_tracer_advection.c /
Full_tracer_advection.c (predictor-corrector tracer advection in the
velocity field), Tracer_setup.c (tracer seeding, per-element counting) and
Composition_related.c (ratio-method composition: per-element fraction of
each tracer flavor, mapped back to nodes for compositional buoyancy).

Tracers are a fixed-size (n_tracers, 3) tensor of (theta, fi, r)
coordinates; element location on the regular tensor grid is closed-form
(no cell search), velocity interpolation is one gather + trilinear weights
per corner. Element counts are integer sums (exact in any order) divided in
the position dtype; the nodal map sums through the model's ScatterPlan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms.mesh import RegionalMesh


class TracerField(NamedTuple):
    """Static grid info for fast point location (uniform tensor grid)."""
    theta0: float
    dtheta: float
    fi0: float
    dfi: float
    r0: float
    dr: float
    nox: int
    noy: int
    noz: int

    @staticmethod
    def from_mesh(mesh: RegionalMesh) -> "TracerField":
        cfg = mesh.cfg
        return TracerField(
            float(mesh.theta[0]), float(mesh.theta[1] - mesh.theta[0]),
            float(mesh.fi[0]), float(mesh.fi[1] - mesh.fi[0]),
            float(mesh.r[0]), float(mesh.r[1] - mesh.r[0]),
            cfg.nodex, cfg.nodey, cfg.nodez)

    def clip(self, pos):
        # the bounds in pos's dtype, as the reference forms them, passed as
        # host scalars (a tensor made from them would be a host-to-device
        # copy per call)
        dt = torch.empty((), dtype=pos.dtype).numpy().dtype
        eps = dt.type(1e-9)
        lo = np.asarray([self.theta0, self.fi0, self.r0], dt) + eps
        hi = np.asarray([self.theta0 + (self.nox - 1) * self.dtheta,
                         self.fi0 + (self.noy - 1) * self.dfi,
                         self.r0 + (self.noz - 1) * self.dr], dt) - eps
        return torch.stack([pos[:, i].clamp(float(lo[i]), float(hi[i]))
                            for i in range(3)], dim=1)

    def locate(self, pos):
        """(element indices (jx, iy, kz), local xi in [-1,1]^3)."""
        tx = (pos[:, 0] - self.theta0) / self.dtheta
        ty = (pos[:, 1] - self.fi0) / self.dfi
        tz = (pos[:, 2] - self.r0) / self.dr
        jx = tx.to(torch.int32).clamp(0, self.nox - 2)
        iy = ty.to(torch.int32).clamp(0, self.noy - 2)
        kz = tz.to(torch.int32).clamp(0, self.noz - 2)
        xi = torch.stack([2 * (tx - jx) - 1, 2 * (ty - iy) - 1,
                          2 * (tz - kz) - 1], dim=1)
        return (jx, iy, kz), xi

    def node_index(self, iy, jx, kz):
        return (iy * self.nox + jx) * self.noz + kz

    def element_index(self, iy, jx, kz):
        return (iy * (self.nox - 1) + jx) * (self.noz - 1) + kz


def interp_velocity(tf: TracerField, V, pos):
    """Trilinear velocity at tracer positions (velo from the 8 cell nodes,
    the role of the reference's shape-fn interpolation in
    Regional_tracer_advection.c)."""
    (jx, iy, kz), xi = tf.locate(pos)
    out = torch.zeros((pos.shape[0], V.shape[-1]), dtype=V.dtype,
                      device=V.device)
    wx = torch.stack([0.5 * (1 - xi[:, 0]), 0.5 * (1 + xi[:, 0])], 1)
    wy = torch.stack([0.5 * (1 - xi[:, 1]), 0.5 * (1 + xi[:, 1])], 1)
    wz = torch.stack([0.5 * (1 - xi[:, 2]), 0.5 * (1 + xi[:, 2])], 1)
    for dy in range(2):
        for dx in range(2):
            for dz in range(2):
                n = tf.node_index(iy + dy, jx + dx, kz + dz)
                w = wy[:, dy] * wx[:, dx] * wz[:, dz]
                out = out + w[:, None] * V[n]
    return out


def _velocity_to_rates(tf: TracerField, pos, v):
    """Spherical velocity components -> coordinate rates
    (dtheta/dt = u_t/r, dfi/dt = u_f/(r sin t), dr/dt = u_r)."""
    r = pos[:, 2]
    st = torch.sin(pos[:, 0])
    return torch.stack([v[:, 0] / r, v[:, 1] / (r * st), v[:, 2]], dim=1)


def advect_tracers(tf: TracerField, V, pos, dt):
    """Predictor-corrector (midpoint) advection step
    (Regional_tracer_advection.c predictor/corrector scheme)."""
    v1 = interp_velocity(tf, V, pos)
    mid = tf.clip(pos + 0.5 * dt * _velocity_to_rates(tf, pos, v1))
    v2 = interp_velocity(tf, V, mid)
    return tf.clip(pos + dt * _velocity_to_rates(tf, mid, v2))


def seed_tracers(mesh: RegionalMesh, tracers_per_element: int,
                 *, seed: int = 0, flavor_boundary_r: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform random seeding (Tracer_setup.c make_tracer_array) with the
    depth-based two-flavor init (ic_method_for_flavors=0 semantics). The
    reference's draws exactly: numpy's default_rng(seed), on the host."""
    cfg = mesh.cfg
    n = mesh.nel * tracers_per_element
    rng = np.random.default_rng(seed)
    pos = np.stack([
        rng.uniform(cfg.theta_min, cfg.theta_max, n),
        rng.uniform(cfg.fi_min, cfg.fi_max, n),
        rng.uniform(cfg.radius_inner, cfg.radius_outer, n)], axis=1)
    if flavor_boundary_r is None:
        flavor_boundary_r = 0.5 * (cfg.radius_inner + cfg.radius_outer)
    flavors = (pos[:, 2] < flavor_boundary_r).astype(np.int32)
    return pos, flavors


def element_composition(tf: TracerField, pos, flavors, n_flavors: int = 2):
    """Ratio-method composition per element (Composition_related.c):
    comp_el[f][e] = (# flavor-f tracers in e) / (# tracers in e).

    The counts are integer sums (int64 index_add_, exact in any order of
    addition and with no host read), divided in the position dtype.
    Returns (comp_el (n_flavors, nel), total (nel,) in that dtype)."""
    (jx, iy, kz), _ = tf.locate(pos)
    el = tf.element_index(iy, jx, kz).long()
    nel = (tf.nox - 1) * (tf.noy - 1) * (tf.noz - 1)
    # one count per (element, flavor); a flavor outside 0..n_flavors-1
    # counts in the total only (slot nel * n_flavors)
    fl = flavors.long()
    valid = (fl >= 0) & (fl < n_flavors)
    key = torch.where(valid, el * n_flavors + fl, nel * n_flavors)
    ones = torch.ones_like(el)
    counts = torch.zeros(nel * n_flavors + 1, dtype=torch.int64,
                         device=pos.device).index_add_(0, key, ones)
    total_i = torch.zeros(nel, dtype=torch.int64,
                          device=pos.device).index_add_(0, el, ones)
    dt = pos.dtype
    total = total_i.to(dt)
    per = counts[:-1].reshape(nel, n_flavors).to(dt)
    den = total.clamp(min=1.0)
    return torch.stack([per[:, f] / den for f in range(n_flavors)]), total


def composition_to_nodes(tf: TracerField, comp_el, plan, ien):
    """Element composition -> nodal field (for compositional buoyancy),
    volume-agnostic averaging (map_composition_to_nodes role)."""
    contrib = comp_el[:, None].expand(comp_el.shape[0], 8)
    num = plan.scatter(contrib[:, :, None])[:, 0]
    den = plan.scatter(torch.ones_like(contrib)[:, :, None])[:, 0]
    return num / den.clamp(min=1.0)
