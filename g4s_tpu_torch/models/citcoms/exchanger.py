"""Coupled coarse-global / fine-regional runs (counterpart of
g4s_tpu/models/citcoms/exchanger.py, the CitcomS Exchanger).

Reference: the CitcomS Exchanger package (citcoms/tests/exchange.py,
test1.sh/test2.sh launch a 12-proc coarse CitcomSFull coupled to a 1-proc
fine CitcomSRegional; the Exchanger's FEMInterpolator samples the coarse
solution at the fine mesh's boundary nodes each step and imposes it as
boundary conditions, while the fine interior temperature is restricted
back to embedded coarse nodes: two-way coupling over MPI).

Here both models live in one process on one device; the exchange is two
batched interpolations: a weighted gather of the coarse solution at the
fine boundary nodes (the full-sphere sampler's stencil, built once in f64
on the host) written into the fine model's boundary values, and the
regional trilinear sampler restricting the fine temperature to the coarse
nodes inside the region.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms import full_tracers as ft
from g4s_tpu_torch.models.citcoms.driver import CitcomModel
from g4s_tpu_torch.models.citcoms.full_driver import FullSphereModel
from g4s_tpu_torch.models.citcoms.full_mesh import _sph_to_xyz
from g4s_tpu_torch.models.citcoms.tracers import interp_velocity
from g4s_tpu_torch.sparse.containers import resolve_device


def _regional_boundary_nodes(cfg) -> np.ndarray:
    """Flat node ids of all six faces of the regional box (the fine
    exchanger's Boundary node set)."""
    nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
    iy, jx, kz = np.meshgrid(np.arange(noy), np.arange(nox), np.arange(noz),
                             indexing="ij")
    on_face = ((iy == 0) | (iy == noy - 1) | (jx == 0) | (jx == nox - 1)
               | (kz == 0) | (kz == noz - 1))
    flat = (iy * nox + jx) * noz + kz
    return flat[on_face].ravel()


class CoupledRun:
    """Two-way coupled coarse full-sphere + fine regional convection. Both
    models must live on `device` (default "cuda": it raises without a
    card; pass device="cpu" with models built on the CPU).

    coarse_stokes: a stokes(T, V, P) -> (V, P, monitor) that replaces the
    coarse model's own solve in every coupled step, e.g. its element-
    sharded solve over several ranks
    (full_driver.shard_full_sphere(coarse, grid)); every rank then runs
    the coupled step, and the fine model's, whole."""

    def __init__(self, coarse: FullSphereModel, fine: CitcomModel,
                 *, two_way: bool = True, device="cuda",
                 coarse_stokes=None):
        dev = resolve_device(device)
        if coarse.device != dev or fine.device != dev:
            raise ValueError(
                f"CoupledRun on {dev}: the coarse model is on "
                f"{coarse.device}, the fine one on {fine.device}")
        self.coarse = coarse
        self.fine = fine
        self.two_way = two_way
        self.coarse_stokes = coarse_stokes

        # fine boundary nodes in Cartesian (sampling sites on the coarse
        # sphere), like the Exchanger's createBoundary; the interpolation
        # stencils coarse -> fine boundary are static: built once in f64
        # on the host, the weights then cast to the coarse model's dtype
        self.b_nodes = _regional_boundary_nodes(fine.cfg)
        sx = fine.mesh.sx[self.b_nodes]
        self.b_xyz = _sph_to_xyz(sx[:, 0], sx[:, 1]) * sx[:, 2:3]
        tf64 = ft.FullTracerField.build(coarse.mesh, dtype=torch.float64,
                                        device="cpu")
        ids, w = ft.interp_weights(tf64, torch.from_numpy(self.b_xyz))
        self.b_ids = ids.to(dev)
        self.b_w = w.to(dev, coarse.dtype)
        self._b_nodes = torch.from_numpy(self.b_nodes.astype(np.int64)).to(dev)

        # masks with every boundary face essential (T and V imposed from
        # the coarse solution)
        tbc_mask = fine.host_bcs[0].copy()
        tbc_mask[self.b_nodes] = True
        vbc_mask = fine.host_bcs[2].copy()
        vbc_mask[self.b_nodes, :] = True
        self._tbc_mask = torch.from_numpy(tbc_mask).to(dev)
        self._vbc_mask = torch.from_numpy(vbc_mask).to(dev)

        # coarse nodes inside the fine region (restriction targets, the
        # Interior exchanger role)
        cfg = fine.cfg
        cs = coarse.mesh.sx
        eps = 1e-9
        inside = ((cs[:, 0] > cfg.theta_min + eps)
                  & (cs[:, 0] < cfg.theta_max - eps)
                  & (cs[:, 1] > cfg.fi_min + eps)
                  & (cs[:, 1] < cfg.fi_max - eps)
                  & (cs[:, 2] > cfg.radius_inner + eps)
                  & (cs[:, 2] < cfg.radius_outer - eps))
        self.interior_ids = torch.from_numpy(np.nonzero(inside)[0]).to(dev)
        self._interior_sph = torch.as_tensor(cs[inside], dtype=fine.dtype,
                                             device=dev)

    # ------------------------------------------------------------------
    def exchange(self, T_c, V_c):
        """Sample the coarse solution at the fine boundary nodes and form
        the fine BC value arrays (FEMInterpolator role)."""
        nno = self.fine.mesh.nno
        Tb = torch.sum(self.b_w * T_c[self.b_ids], dim=1)
        Vb = torch.sum(self.b_w[:, :, None] * V_c[self.b_ids], dim=1)
        tbc_val = torch.zeros(nno, dtype=T_c.dtype, device=T_c.device)
        tbc_val[self._b_nodes] = Tb
        vbc_val = torch.zeros((nno, 3), dtype=V_c.dtype, device=V_c.device)
        vbc_val[self._b_nodes] = Vb
        return tbc_val, vbc_val

    def fine_step(self, s, tbc_val, vbc_val):
        """One fine step under the exchanged boundary values."""
        return self.fine._timestep(
            s, bcs=(self._tbc_mask, tbc_val, self._vbc_mask, vbc_val))

    def restrict(self, T_c, T_f):
        """Fine temperature -> embedded coarse nodes (Interior role)."""
        Tf_at = interp_velocity(self.fine.tracer_field, T_f[:, None],
                                self._interior_sph)[:, 0]
        return T_c.index_copy(0, self.interior_ids, Tf_at.to(T_c.dtype))

    # ------------------------------------------------------------------
    def step(self, s_coarse, s_fine, *, fine_substeps: int = 1):
        """One coupled step: advance coarse, exchange BCs, advance fine
        (optionally several substeps at its smaller CFL dt), restrict."""
        s_coarse, d_c = self.coarse._timestep(s_coarse,
                                              stokes=self.coarse_stokes)
        tbc_val, vbc_val = self.exchange(s_coarse.T, s_coarse.V)
        for _ in range(fine_substeps):
            s_fine, d_f = self.fine_step(s_fine, tbc_val, vbc_val)
        if self.two_way:
            s_coarse = dataclasses.replace(
                s_coarse, T=self.restrict(s_coarse.T, s_fine.T))
        return s_coarse, s_fine, (d_c, d_f)
