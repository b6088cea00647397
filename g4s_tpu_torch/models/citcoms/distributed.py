"""Multi-rank regional CitcomS: domain decomposition over torch.distributed
ranks (counterpart of g4s_tpu/models/citcoms/distributed.py).

The (theta, fi) plane is split over the grid axes ("bx", "by") exactly
like nprocx x nprocy (citcoms/lib/Regional_parallel_related.c:213
regional_parallel_domain_decomp0), with shared boundary nodes duplicated
between neighbour ranks. Each rank holds its brick and in one step:

  - assembles its own elements (each rank owns a clean element brick;
    elements never straddle ranks),
  - follows every nodal scatter with an additive halo exchange
    (parallel.halo, the exchange_id_d/exchange_node_d combine,
    Regional_parallel_related.c:744-858),
  - forms CG / Uzawa dot products as ownership-weighted all-reduces
    (global_vdot, Global_operations.c:496-529: each shared node counted
    once),
  - takes the CFL step and the max-T guard's interior maximum as all-rank
    maxima, and the buoyancy's horizontal layer average from per-layer
    all-reduces.

The SAME solver code (solvers.uzawa_cg over a StokesProblem) runs here as
on one device; only the operator closures change. Every host decision of
the step (the CG and Uzawa tests, the max-T guard) reads a value that was
all-reduced, so every rank takes the same branch.

Supported: the regional model's Solver=cgrad path with temperature-
dependent viscosity (what the reference's distributed step runs); other
branches of CitcomModel raise here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms import advection as adv_mod
from g4s_tpu_torch.models.citcoms import assembly as asm
from g4s_tpu_torch.models.citcoms import bc_files
from g4s_tpu_torch.models.citcoms import solvers as sol
from g4s_tpu_torch.models.citcoms.config import CitcomConfig
from g4s_tpu_torch.models.citcoms.driver import StepDiagnostics
from g4s_tpu_torch.models.citcoms.mesh import (build_regional_mesh,
                                               initial_temperature)
from g4s_tpu_torch.models.citcoms.shapes import build_geometry
from g4s_tpu_torch.models.citcoms.viscosity import (element_materials,
                                                    viscosity_at_vpts)
from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.parallel.collectives import pmax, psum_scalar
from g4s_tpu_torch.parallel.halo import halo_exchange_add
from g4s_tpu_torch.parallel.mesh import RankGrid
from g4s_tpu_torch.sparse.containers import resolve_device

AXES = ("bx", "by")


def _block_slices(n_nodes: int, parts: int):
    """Overlapping node ranges per block along one axis (shared planes)."""
    nel = n_nodes - 1
    assert nel % parts == 0, f"{nel} elements not divisible by {parts} blocks"
    step = nel // parts
    return [(i * step, i * step + step + 1) for i in range(parts)]


def _unsupported(cfg: CitcomConfig) -> list:
    """The branches of CitcomModel's step that this decomposition does
    not run."""
    out = []
    if cfg.solver_type != "cgrad":
        out.append(f"Solver={cfg.solver_type}")
    for name in ("SDEPV", "PDEPV", "ANIVISC", "lith_age", "filter_temp",
                 "tracer"):
        if getattr(cfg, name):
            out.append(name)
    if cfg.disptn_number != 0.0:
        out.append("TALA (disptn_number)")
    if cfg.Ra_410 != 0.0 or cfg.Ra_670 != 0.0 or cfg.Ra_cmb != 0.0:
        out.append("phase changes")
    if cfg.fixed_timestep != 0.0:
        out.append("fixed_timestep")
    if bc_files.uses_bc_files(cfg):
        out.append("bc files")
    return out


class _HaloPlan:
    """The block's ScatterPlan followed by the additive halo exchange: the
    one-device assembly functions take it as their plan."""

    def __init__(self, plan: asm.ScatterPlan, halo):
        self.plan = plan
        self.nno = plan.nno
        self._halo = halo

    def scatter(self, contrib):
        return self._halo(self.plan.scatter(contrib))


class DistributedCitcom:
    """This rank's brick of a regional configuration on `device` and its
    distributed step. `grid` is a RankGrid with axes ("bx", "by")."""

    def __init__(self, cfg: CitcomConfig, grid: RankGrid, *,
                 dtype=torch.float64, device="cuda"):
        if tuple(grid.names) != AXES:
            raise ValueError(f"grid axes {grid.names}, expected {AXES}")
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                "DistributedCitcom runs the regional Solver=cgrad step; "
                f"this configuration asks for {', '.join(bad)}")
        self.cfg, self.grid, self.dtype = cfg, grid, dtype
        self.device = dev = resolve_device(device)
        px, py = grid.sizes
        self.px, self.py = px, py
        bx, by = grid.index("bx"), grid.index("by")

        gmesh = build_regional_mesh(cfg)
        geo = build_geometry(gmesh)
        self.gmesh = gmesh
        nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
        self.xs = _block_slices(nox, px)
        self.ys = _block_slices(noy, py)
        nxl = self.xs[0][1] - self.xs[0][0]
        nyl = self.ys[0][1] - self.ys[0][0]
        self.nxl, self.nyl, self.noz = nxl, nyl, noz
        self.nno_loc = nxl * nyl * noz
        self.nel_loc = (nxl - 1) * (nyl - 1) * (noz - 1)
        self._grid_nodes = np.arange(gmesh.nno).reshape(noy, nox, noz)
        self._grid_elems = np.arange(gmesh.nel).reshape(noy - 1, nox - 1,
                                                        noz - 1)
        nodes, elems = self.node_ids(bx, by), self.elem_ids(bx, by)

        def to(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        # local IEN on the local grid (the same for every block)
        ien = self._local_ien(nyl, nxl, noz)
        self.ien = torch.from_numpy(ien.astype(np.int64)).to(dev)
        self.plan = _HaloPlan(asm.ScatterPlan.build(ien, self.nno_loc, dev),
                              self._halo_nodes)
        self.N = to(geo.N)
        self.gweight = to(geo.gweight)
        self.B = to(geo.B[elems])
        self.gda = to(geo.gda[elems])
        self.cc = to(geo.cc[elems])
        self.G = to(geo.G[elems])
        self.e_area = to(geo.volume[elems])
        self.total_volume = float(geo.volume.sum())
        self.mat = torch.from_numpy(element_materials(
            cfg, gmesh.e_center[elems, 2], cfg.radius_outer).astype(
                np.int64)).to(dev)
        self.r_nodes = to(gmesh.sx[nodes, 2])
        self.vbc_mask = torch.from_numpy(gmesh.vbc_mask[nodes]).to(dev)
        self.vbc_val = to(gmesh.vbc_val[nodes])
        self.tbc_mask = torch.from_numpy(gmesh.tbc_mask[nodes]).to(dev)
        self.tbc_val = to(gmesh.tbc_val[nodes])
        self.T0 = initial_temperature(gmesh)[nodes]

        # ownership weights: low-x/low-y shared planes owned by the
        # neighbour
        w = np.ones((nyl, nxl, noz))
        if bx > 0:
            w[:, 0, :] = 0.0
        if by > 0:
            w[0, :, :] = 0.0
        self.own = to(w.reshape(-1))

        # lumped mass over the whole shared node (halo-summed) and the
        # advection tensors of this block's elements (built for the whole
        # mesh in f64 on the host, then sliced and cast)
        self.tmass = asm.build_tmass(self.plan, self.N, self.gda,
                                     self.gweight)
        self.nmass = 1.0 / self.tmass
        g64 = adv_mod.build_advection_geometry(
            geo, gmesh, torch.ones(gmesh.nno, dtype=torch.float64))
        self.adv_geo = adv_mod.AdvectionGeometry(
            self.N, to(g64.N_center), self.gweight, self.gda,
            to(g64.gradN[elems]), to(g64.e_size[elems]), self.tmass,
            to(g64.diff_dt))

        # buoyancy layer sums: this block's nodes sorted by layer, shared
        # nodes counted once; the weights' all-rank sums once, here
        lw = self._layer_weights()[nodes] * w.reshape(-1)
        layer = np.arange(self.nno_loc) % noz
        order = np.argsort(layer, kind="stable")
        self._layer = torch.from_numpy(layer).to(dev)
        self._layer_order = torch.from_numpy(order.astype(np.int32)).to(dev)
        self._layer_sorted = torch.from_numpy(
            layer[order].astype(np.int32)).to(dev)
        self.layer_w = to(lw)
        self._layer_wsum = psum_scalar(self._layer_sum(self.layer_w), grid)

        self.uzawa_params = sol.UzawaParams(
            cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
            cfg.vlowstep, cfg.check_pressure_convergence)

    # ------------------------------------------------------------------
    def node_ids(self, bx: int, by: int) -> np.ndarray:
        """Global ids of block (bx, by)'s nodes, in its local order."""
        (y0, y1), (x0, x1) = self.ys[by], self.xs[bx]
        return self._grid_nodes[y0:y1, x0:x1, :].reshape(-1)

    def elem_ids(self, bx: int, by: int) -> np.ndarray:
        (y0, y1), (x0, x1) = self.ys[by], self.xs[bx]
        return self._grid_elems[y0:y1 - 1, x0:x1 - 1, :].reshape(-1)

    @staticmethod
    def _local_ien(nyl, nxl, noz):
        iy, jx, kz = np.meshgrid(np.arange(nyl - 1), np.arange(nxl - 1),
                                 np.arange(noz - 1), indexing="ij")
        corners = []
        for (dy, dx, dz) in [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0),
                             (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)]:
            corners.append((((iy + dy) * nxl + (jx + dx)) * noz + kz + dz)
                           .ravel())
        return np.stack(corners, axis=1).astype(np.int32)

    def _layer_weights(self) -> np.ndarray:
        """(nno,) surface-area lumping of every node within its layer (the
        one-device model's _build_layer_weights)."""
        m = self.gmesh
        nox, noy, noz = self.cfg.nodex, self.cfg.nodey, self.cfg.nodez
        w = np.zeros((noy, nox, noz))
        th, r = m.theta, m.r
        dphi = m.fi[1] - m.fi[0] if noy > 1 else 1.0
        for j in range(nox - 1):
            band = np.cos(th[j]) - np.cos(th[j + 1])
            for k in range(noz):
                cell = 0.25 * band * dphi * r[k] ** 2
                w[:-1, j, k] += cell
                w[1:, j, k] += cell
                w[:-1, j + 1, k] += cell
                w[1:, j + 1, k] += cell
        return w.reshape(-1)

    def _layer_sum(self, x):
        return sorted_segment_sum(x, self._layer_sorted, self.noz,
                                  order=self._layer_order)

    def _halo_nodes(self, u):
        """Additive halo over the (nyl, nxl) node grid; u: (nno_loc, ...)."""
        shp = u.shape
        g = u.reshape(self.nyl, self.nxl, self.noz, -1)
        g = halo_exchange_add(g, self.grid, [("by", 0), ("bx", 1)])
        return g.reshape(shp)

    # ------------------------------------------------------------------
    def _psum(self, x):
        return psum_scalar(x, self.grid)

    def _problem(self, ops: asm.StokesOperators) -> sol.StokesProblem:
        own = self.own
        w3 = own[:, None]
        vw = (self.nmass * own)[:, None]
        tv = self.total_volume
        return sol.local_problem(ops, self.nmass, self.e_area, tv)._replace(
            dot_v=lambda a, b: self._psum(torch.sum(a * b * w3)),
            dot_p=lambda a, b: self._psum(torch.dot(a, b)),
            v_norm2=lambda v: self._psum(torch.sum(v * v * vw)) / tv,
            p_norm2=lambda p: self._psum(torch.sum(p * p * self.e_area)) / tv,
            div_norm2=lambda p: self._psum(torch.sum(p * p / self.e_area))
            / tv)

    def buoyancy(self, T):
        """Ra * T minus its layer average over the whole region."""
        buoy = self.cfg.rayleigh * T
        bsum = self._psum(self._layer_sum(buoy * self.layer_w))
        return buoy - (bsum / self._layer_wsum)[self._layer]

    def _stokes(self, T, V, P):
        cfg = self.cfg
        evisc = viscosity_at_vpts(cfg, self.mat, T, self.ien, self.N,
                                  r_nodes=self.r_nodes)
        elt_k = asm.build_elt_k(self.B, self.gda, self.gweight, evisc)
        BI = asm.build_diag_K(elt_k, self.plan)
        BPI = asm.build_bpi(self.G, BI, self.ien, self.vbc_mask)
        ops = asm.StokesOperators(self.ien, elt_k, self.G, self.vbc_mask,
                                  self.vbc_val, BI, BPI, self.plan)
        F = asm.assemble_forces(ops, self.N, self.gda, self.gweight,
                                self.cc, self.buoyancy(T))
        prob = self._problem(ops)
        fdotf = torch.sqrt(prob.dot_v(F, F))
        V = asm.apply_vbc(V, self.vbc_mask, self.vbc_val)
        return sol.uzawa_cg(prob, V, P, F, fdotf, self.uzawa_params)

    def _cfl_dt(self, V):
        """std_timestep with the all-rank largest element rate."""
        adv = self.adv_geo
        uc = torch.einsum("eai,a->ei", V[self.ien], adv.N_center[:, 0])
        rate = (uc.abs() / adv.e_size).sum(dim=1)
        step = 0.5 / pmax(rate, self.grid)
        return 1.0e-32 + torch.minimum(self.cfg.finetunedt * step,
                                       adv.diff_dt)

    def _advect(self, T0, Tdot0, V, dt0):
        """SUPG predictor-corrector through the max-T guard
        (advection.advect_monitored) with all-rank interior maxima."""
        cfg = self.cfg

        def advect(dt):
            return adv_mod.pg_timestep(
                self.adv_geo, self.ien, self.plan, T0, Tdot0, V, dt,
                diff=cfg.inputdiffusivity, Q0=cfg.Q0, gamma=cfg.adv_gamma,
                sub_iterations=cfg.adv_sub_iterations,
                tbc_mask=self.tbc_mask, tbc_val=self.tbc_val)

        return adv_mod.advect_monitored(
            advect, T0, dt0, self.tbc_mask, cfg.monitor_max_T,
            reduce_max=lambda x: pmax(x, self.grid))

    # ------------------------------------------------------------------
    def init_state(self) -> Dict[str, torch.Tensor]:
        """This rank's block of the initial state: T, Tdot, V, P, time."""
        T = torch.as_tensor(self.T0, dtype=self.dtype, device=self.device)
        V = asm.apply_vbc(torch.zeros((self.nno_loc, 3), dtype=self.dtype,
                                      device=self.device),
                          self.vbc_mask, self.vbc_val)
        return dict(T=T, Tdot=torch.zeros_like(T), V=V,
                    P=torch.zeros(self.nel_loc, dtype=self.dtype,
                                  device=self.device),
                    time=torch.zeros((), dtype=self.dtype,
                                     device=self.device))

    def block_state(self, T, Tdot, V, P, time) -> Dict[str, torch.Tensor]:
        """This rank's block of a whole-mesh state (nodal (nno,) and
        (nno, 3), element (nel,))."""
        bx, by = self.grid.index("bx"), self.grid.index("by")
        nodes = torch.from_numpy(self.node_ids(bx, by))
        elems = torch.from_numpy(self.elem_ids(bx, by))

        def take(x, ids):
            x = torch.as_tensor(x)
            return x[ids].to(self.device, self.dtype)

        return dict(T=take(T, nodes), Tdot=take(Tdot, nodes),
                    V=take(V, nodes), P=take(P, elems),
                    time=torch.as_tensor(time).to(self.device, self.dtype))

    def gather(self, s) -> Dict[str, torch.Tensor]:
        """The whole-mesh T, Tdot, V (nodes) and P (elements) from every
        rank's block, on every rank (shared nodes take the last block's
        copy, which every block holds equal)."""
        import torch.distributed as dist
        m = self.gmesh
        out = {}
        for k, n_glob, ids_of in (("T", m.nno, self.node_ids),
                                  ("Tdot", m.nno, self.node_ids),
                                  ("V", m.nno, self.node_ids),
                                  ("P", m.nel, self.elem_ids)):
            x = s[k].contiguous()
            parts = [torch.empty_like(x) for _ in range(self.grid.world)]
            dist.all_gather(parts, x)
            g = torch.zeros((n_glob,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
            for r, part in enumerate(parts):
                bx, by = divmod(r, self.py)
                g[torch.from_numpy(ids_of(bx, by)).to(x.device)] = part
            out[k] = g
        return out

    def step(self, s):
        """One distributed timestep: (state, StepDiagnostics)."""
        dt0 = self._cfl_dt(s["V"])
        T, Tdot, dt = self._advect(s["T"], s["Tdot"], s["V"], dt0)
        V, P, mon = self._stokes(T, s["V"], s["P"])
        diag = StepDiagnostics(dt, mon.v_norm, mon.p_norm,
                               mon.incompressibility, mon.outer_iterations,
                               mon.inner_iterations)
        return dict(T=T, Tdot=Tdot, V=V, P=P, time=s["time"] + dt), diag
