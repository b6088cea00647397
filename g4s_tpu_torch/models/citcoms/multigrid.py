"""Multigrid velocity solver, the Solver=multigrid path (counterpart of
g4s_tpu/models/citcoms/multigrid.py).

Reference: citcoms/lib/General_matrix_functions.c:152-305 `multi_grid` —
full multigrid with V-cycles: project the residual down a mesh hierarchy,
smooth at each level, solve the coarsest directly, interpolate corrections
up with an optimal line-search step alpha = <Au,res>/<Au,Au> (:259-260,
two global dots per level), plus the level-transfer operators of
Solver_multigrid.c (interp_vector:187, project_vector:479) and the
gauss_seidel smoother (:606).

  - the smoother is 8-color block Gauss-Seidel on the 27-point nodal
    stencil (nodal.gauss_seidel_colored), the reference's default; its
    damped-Jacobi option has no caller in the regional model and is not
    carried;
  - the coarsest level is solved with a fixed number of CG iterations,
    run on the device with the reference's stopping test applied as a
    mask, so it reads nothing back to the host;
  - restriction = transpose of trilinear interpolation, summed in a fixed
    order (the transposed map sorted once, then sorted_segment_sum).

`solve` runs its V-cycles in a host loop that reads the residual once per
cycle (solvers.host_true), as the CG and Uzawa loops do; its first cycle
runs whatever the residual (see solve).

Each level rebuilds the same FE operators (mesh, B tensors, elt_k) at its
own resolution, as construct_stiffness_B_matrix populates all levels in
the reference (Construct_arrays.c:740).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms import assembly as asm
from g4s_tpu_torch.models.citcoms import solvers as sol
from g4s_tpu_torch.models.citcoms.config import CitcomConfig
from g4s_tpu_torch.models.citcoms.mesh import build_regional_mesh
from g4s_tpu_torch.models.citcoms.nodal import (GSColors, GSPlan,
                                                StencilPlan, build_stencil,
                                                gauss_seidel_colored,
                                                stencil_block_dinv)
from g4s_tpu_torch.models.citcoms.shapes import build_geometry
from g4s_tpu_torch.models.citcoms.viscosity import (element_materials,
                                                    viscosity_at_vpts)
from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.sparse.containers import resolve_device


def _coarsen(n_nodes: int) -> int:
    return (n_nodes - 1) // 2 + 1


class Interp(NamedTuple):
    """Coarse -> fine trilinear map and its transpose's sorted sum plan."""
    ids: torch.Tensor       # (nno_f, 8) coarse node per corner
    w: torch.Tensor         # (nno_f, 8) weights, the model dtype
    order: torch.Tensor     # (nno_f*8,) int32: slots sorted by coarse node
    seg_ids: torch.Tensor   # (nno_f*8,) int32 coarse node per sorted slot
    nno_coarse: int


class MGLevel(NamedTuple):
    cfg: CitcomConfig
    mesh: object
    geo: object
    ien: torch.Tensor
    plan: asm.ScatterPlan
    N: torch.Tensor
    gda: torch.Tensor
    gweight: torch.Tensor
    B: torch.Tensor
    G: torch.Tensor
    cc: torch.Tensor
    vbc_mask: torch.Tensor
    vbc_val: torch.Tensor
    mat: torch.Tensor
    interp: Optional[Interp]   # from this level UP to the finer one


def _interp_maps(coarse_cfg: CitcomConfig, fine_cfg: CitcomConfig):
    """Trilinear interpolation map coarse -> fine on nested grids (numpy).

    Returns (src_ids (nno_f, 8), weights (nno_f, 8)): every fine node is a
    weighted combination of up to 8 coarse nodes (exactly 1/2/4/8 active).
    """
    fnx, fny, fnz = fine_cfg.nodex, fine_cfg.nodey, fine_cfg.nodez
    cnx, cny, cnz = coarse_cfg.nodex, coarse_cfg.nodey, coarse_cfg.nodez

    iy, jx, kz = np.meshgrid(np.arange(fny), np.arange(fnx), np.arange(fnz),
                             indexing="ij")
    # fractional coarse coordinates of each fine node
    fy = iy * (cny - 1) / (fny - 1)
    fx = jx * (cnx - 1) / (fnx - 1)
    fz = kz * (cnz - 1) / (fnz - 1)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, cny - 2)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, cnx - 2)
    z0 = np.clip(np.floor(fz).astype(np.int64), 0, cnz - 2)
    wy, wx, wz = fy - y0, fx - x0, fz - z0

    ids, wts = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            for dz in (0, 1):
                node = ((y0 + dy) * cnx + (x0 + dx)) * cnz + (z0 + dz)
                w = (np.where(dy, wy, 1 - wy) * np.where(dx, wx, 1 - wx)
                     * np.where(dz, wz, 1 - wz))
                ids.append(node.reshape(-1))
                wts.append(w.reshape(-1))
    return np.stack(ids, 1), np.stack(wts, 1)


def build_interp(coarse_cfg, fine_cfg, dtype, device) -> Interp:
    ids, w = _interp_maps(coarse_cfg, fine_cfg)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    return Interp(torch.from_numpy(ids).to(device),
                  torch.as_tensor(w, dtype=dtype, device=device),
                  torch.from_numpy(order.astype(np.int32)).to(device),
                  torch.from_numpy(flat[order].astype(np.int32)).to(device),
                  coarse_cfg.nodex * coarse_cfg.nodey * coarse_cfg.nodez)


def interp_up(level_interp: Interp, u_coarse):
    """u_fine = P u_coarse (interp_vector)."""
    return torch.einsum("nk,nk...->n...", level_interp.w,
                        u_coarse[level_interp.ids])


def project_down(level_interp: Interp, r_fine):
    """r_coarse = P^T r_fine (project_vector role), summed per coarse node
    in fine-slot order."""
    contrib = level_interp.w[:, :, None] * r_fine[:, None, :]
    flat = contrib.reshape(-1, r_fine.shape[-1])
    return sorted_segment_sum(flat, level_interp.seg_ids,
                              level_interp.nno_coarse,
                              order=level_interp.order)


def conj_grad_masked(prob: sol.StokesProblem, F, acc, max_iter: int):
    """conj_grad with the reference's stopping test (run while res > acc,
    at least once, at most max_iter times) applied on the device: every
    iteration runs, and once the test fails the iterate stops changing.
    Returns (x, residual, iterations as a device tensor)."""
    d = torch.zeros_like(F)
    r = F
    p1 = torch.zeros_like(F)
    dotr0z0 = torch.ones((), dtype=F.dtype, device=F.device)
    res = torch.sqrt(prob.dot_v(r, r))
    count = torch.zeros((), dtype=torch.int32, device=F.device)
    for k in range(max_iter):
        z1 = prob.BI * r
        dotr1z1 = prob.dot_v(r, z1)
        beta = 0.0 if k == 0 else dotr1z1 / torch.where(dotr0z0 == 0, 1.0,
                                                        dotr0z0)
        p2 = z1 + beta * p1
        Ap = prob.A(p2)
        dotprod = prob.dot_v(p2, Ap)
        alpha = torch.where(dotprod == 0.0, 1.0e-3,
                            dotr1z1 / torch.where(dotprod == 0, 1.0, dotprod))
        d_n = d + alpha * p2
        r_n = r - alpha * Ap
        res_n = torch.sqrt(prob.dot_v(r_n, r_n))
        if k == 0:
            d, r, p1, dotr0z0, res = d_n, r_n, p2, dotr1z1, res_n
            count = count + 1
            continue
        on = res > acc
        d = torch.where(on, d_n, d)
        r = torch.where(on, r_n, r)
        p1 = torch.where(on, p2, p1)
        dotr0z0 = torch.where(on, dotr1z1, dotr0z0)
        res = torch.where(on, res_n, res)
        count = count + on.to(torch.int32)
    return prob.strip(d), res, count


class MGHierarchy:
    """Nested-level FE operators + the V-cycle solver."""

    def __init__(self, cfg: CitcomConfig, *, levels: int = None,
                 dtype=torch.float64, device="cuda"):
        if levels is None:
            levels = max(cfg.levels, 2)
        self.dtype = dtype
        self.device = resolve_device(device)
        cfgs = [cfg]
        for _ in range(levels - 1):
            prev = cfgs[-1]
            nxt = dataclasses.replace(prev, nodex=_coarsen(prev.nodex),
                                      nodey=_coarsen(prev.nodey),
                                      nodez=_coarsen(prev.nodez))
            if min(nxt.nodex, nxt.nodey, nxt.nodez) < 3:
                break
            cfgs.append(nxt)
        self.levels: List[MGLevel] = []
        self.stencil_plans = []
        self.gs_plans = []
        dev = self.device

        def to(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        for li, c in enumerate(cfgs):
            m = build_regional_mesh(c)
            g = build_geometry(m)
            interp = (build_interp(c, cfgs[li - 1], dtype, dev)
                      if li > 0 else None)
            self.levels.append(MGLevel(
                c, m, g, torch.from_numpy(m.ien.astype(np.int64)).to(dev),
                asm.ScatterPlan.build(m.ien, m.nno, dev), to(g.N), to(g.gda),
                to(g.gweight), to(g.B), to(g.G), to(g.cc),
                torch.from_numpy(m.vbc_mask).to(dev), to(m.vbc_val),
                torch.from_numpy(element_materials(
                    c, m.e_center[:, 2], c.radius_outer).astype(np.int64))
                .to(dev),
                interp))
            self.stencil_plans.append(StencilPlan.build(c, dev))
            self.gs_plans.append(GSPlan.build(self.stencil_plans[-1]))

    def build_ops(self, T_fine, finest=None):
        """Element stiffness at every level; coarse-level viscosity comes
        from injecting the fine temperature (visc_from_gint projections in
        the reference). `finest`, when given, is used as level 0's
        operators instead of building them from T."""
        ops = []
        T = T_fine
        for li, lv in enumerate(self.levels):
            if li > 0:
                # restrict T by sampling every other node
                pc, pf = lv.cfg, self.levels[li - 1].cfg
                grid = T.reshape(pf.nodey, pf.nodex, pf.nodez)
                sy = (pf.nodey - 1) // (pc.nodey - 1)
                sx = (pf.nodex - 1) // (pc.nodex - 1)
                sz = (pf.nodez - 1) // (pc.nodez - 1)
                T = grid[::sy, ::sx, ::sz].reshape(-1)
            elif finest is not None:
                ops.append(finest)
                continue
            evisc = viscosity_at_vpts(lv.cfg, lv.mat, T, lv.ien, lv.N)
            elt_k = asm.build_elt_k(lv.B, lv.gda, lv.gweight, evisc)
            BI = asm.build_diag_K(elt_k, lv.plan)
            BPI = asm.build_bpi(lv.G, BI, lv.ien, lv.vbc_mask)
            ops.append(asm.StokesOperators(lv.ien, elt_k, lv.G, lv.vbc_mask,
                                           lv.vbc_val, BI, BPI, lv.plan))
        return ops

    def build_smoothers(self, ops):
        """Per-level GS smoothers (stencil, 3x3 block Dinv and their
        per-color slices), built once per viscosity update like Eqn_k
        (Construct_arrays.c:740)."""
        out = []
        for li, lv in enumerate(self.levels):
            st = build_stencil(ops[li].elt_k, self.stencil_plans[li])
            out.append(GSColors.build(st, stencil_block_dinv(st, lv.vbc_mask),
                                      lv.vbc_mask, self.gs_plans[li]))
        return out

    def v_cycle(self, ops, smoothers, F, u, *, down: int = 2, up: int = 2,
                coarse_iters: int = 30):
        """One V-cycle with line-search-scaled corrections
        (mg_cycle, General_matrix_functions.c:214-280); `smoothers` from
        build_smoothers(ops)."""
        levels = self.levels
        n = len(levels)
        residuals = []
        # down-stroke
        for li in range(n - 1):
            u = gauss_seidel_colored(smoothers[li], F, u, down)
            r = asm.strip_bcs(F - asm.assemble_del2_u(ops[li], u, strip=True),
                              levels[li].vbc_mask)
            residuals.append((F, u))
            F = asm.strip_bcs(project_down(levels[li + 1].interp, r),
                              levels[li + 1].vbc_mask)
            u = torch.zeros((levels[li + 1].mesh.nno, 3), dtype=F.dtype,
                            device=F.device)
        # coarsest: CG
        last = levels[n - 1]
        prob = sol.local_problem(
            ops[n - 1], torch.ones(last.mesh.nno, dtype=F.dtype,
                                   device=F.device),
            torch.ones(last.mesh.nel, dtype=F.dtype, device=F.device), 1.0)
        u, _, _ = conj_grad_masked(prob, F, 1e-12, coarse_iters)
        # up-stroke
        for li in range(n - 2, -1, -1):
            F_f, u_f = residuals[li]
            du = asm.strip_bcs(interp_up(levels[li + 1].interp, u),
                               levels[li].vbc_mask)
            # optimal step: alpha = <A du, res> / <A du, A du>
            res = F_f - asm.assemble_del2_u(ops[li], u_f, strip=True)
            Adu = asm.assemble_del2_u(ops[li], du, strip=True)
            denom = sol._vdot(Adu, Adu)
            alpha = torch.where(denom > 0,
                                sol._vdot(Adu, res) / sol._nonzero(denom),
                                1.0)
            u = u_f + alpha * du
            u = gauss_seidel_colored(smoothers[li], F_f, u, up)
        return u

    def solve(self, ops, F, *, acc, max_cycles: int = 50, down: int = 2,
              up: int = 2, smoothers=None):
        """Repeated V-cycles until ||r|| <= acc (solve_del2_u MG branch).
        Returns (u, residual, cycles); one host read per test of the
        residual. `smoothers` takes build_smoothers(ops) built once per
        viscosity update; without it each call builds its own.

        The first cycle runs whatever the residual, as conj_grad's first
        iteration does. The reference tests first, so an F already below
        acc returns u = 0, and the Uzawa step that follows divides by
        <s, div 0> = 0: its Solver=multigrid initial solve turns NaN with
        Cookbook2's settings on a 9x9x9 mesh (ROADMAP.md section 3). Where
        the reference's solve stays finite, every inner solve ran a cycle,
        and the two agree."""
        if smoothers is None:
            smoothers = self.build_smoothers(ops)
        u = torch.zeros_like(F)
        res = torch.sqrt(sol._vdot(F, F))
        it = 0
        while it == 0 or (it < max_cycles and sol.host_true(res > acc)):
            u = self.v_cycle(ops, smoothers, F, u, down=down, up=up)
            r = F - asm.assemble_del2_u(ops[0], u, strip=True)
            r = asm.strip_bcs(r, self.levels[0].vbc_mask)
            res = torch.sqrt(sol._vdot(r, r))
            it += 1
        return u, res, it
