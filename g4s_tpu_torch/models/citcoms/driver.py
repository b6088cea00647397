"""CitcomS-equivalent regional convection driver (counterpart of
g4s_tpu/models/citcoms/driver.py).

Orchestrates the per-step pipeline of the reference's main loop
(citcoms/bin/Citcom.c:199-281):
  PG_timestep (energy advection)  ->  general_stokes_solver (momentum)
with the buoyancy construction of get_buoyancy
(Pan_problem_misc_functions.c:151-235: buoy = Ra * T, horizontal layer
average removed via surface-integral means, return_horiz_ave_f
Global_operations.c) and the solver selection of Drive_solvers.c:64.

The model holds its mesh constants as tensors on its device, built once in
f64 on the host and cast to the model dtype; a step runs eagerly, its
solver loops on the host (solvers.py).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from g4s_tpu_torch import engine
from g4s_tpu_torch.models.citcoms import advection as adv_mod
from g4s_tpu_torch.models.citcoms import assembly as asm
from g4s_tpu_torch.models.citcoms import solvers as sol
from g4s_tpu_torch.models.citcoms.config import CitcomConfig
from g4s_tpu_torch.models.citcoms.mesh import (RegionalMesh,
                                               build_regional_mesh,
                                               initial_temperature)
from g4s_tpu_torch.models.citcoms.nodal import (StencilPlan, build_stencil,
                                                nodal_matvec)
from g4s_tpu_torch.models.citcoms.observables import filter_temperature
from g4s_tpu_torch.models.citcoms.shapes import FEMGeometry, build_geometry
from g4s_tpu_torch.models.citcoms.viscosity import (element_materials,
                                                    strain_rate_2inv,
                                                    viscosity_at_vpts)
from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.sparse.containers import resolve_device

# CitcomS's two stiffness-matvec forms, registered with the engine's
# operator dispatcher (the assemble_del2_u dispatch seam)
engine.register_operator_variant(
    "stencil", lambda d, u: nodal_matvec(d["W"], u, d["mask"], strip=True))
engine.register_operator_variant(
    "eltk", lambda d, u: asm.assemble_del2_u(d["ops"], u, strip=True))


def _not_ported(what: str, where: str):
    raise NotImplementedError(
        f"{what} is not ported to g4s_tpu_torch yet ({where} of ROADMAP.md)")


_QUEUE_TAIL = "queue 1, item 4, \"The CitcomS tail\""


@dataclasses.dataclass(frozen=True)
class State:
    T: torch.Tensor       # (nno,)
    Tdot: torch.Tensor    # (nno,)
    V: torch.Tensor       # (nno, 3) spherical components (theta, fi, r)
    P: torch.Tensor       # (nel,)
    time: torch.Tensor    # scalar
    dt: torch.Tensor      # scalar (last timestep)
    step: int


class StepDiagnostics(NamedTuple):
    dt: torch.Tensor
    v_norm: torch.Tensor
    p_norm: torch.Tensor
    incompressibility: torch.Tensor
    uzawa_iterations: int
    inner_iterations: int


class CitcomModel:
    """Holds the mesh/geometry tensors of one configuration on `device`
    and runs its steps."""

    def __init__(self, cfg: CitcomConfig, *, dtype=torch.float64,
                 device="cuda"):
        _check_ported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh: RegionalMesh = build_regional_mesh(cfg)
        self.geo: FEMGeometry = build_geometry(self.mesh)
        m, g = self.mesh, self.geo
        dev = self.device

        def to(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self.ien = torch.from_numpy(m.ien.astype(np.int64)).to(dev)
        self.plan = asm.ScatterPlan.build(m.ien, m.nno, dev)
        self.N = to(g.N)
        self.gda = to(g.gda)
        self.gweight = to(g.gweight)
        self.cc = to(g.cc)
        self.B = to(g.B)
        self.G = to(g.G)
        self.vbc_mask = torch.from_numpy(m.vbc_mask).to(dev)
        self.vbc_val = to(m.vbc_val)
        self.tbc_mask = torch.from_numpy(m.tbc_mask).to(dev)
        self.tbc_val = to(m.tbc_val)
        self.e_area = to(g.volume)
        self.total_volume = float(g.volume.sum())
        self.r_nodes = to(m.sx[:, 2])
        self.mat = torch.from_numpy(element_materials(
            cfg, m.e_center[:, 2], cfg.radius_outer).astype(np.int64)).to(dev)
        # lumped nodal mass / volume weights (mass_matrix)
        self.tmass = asm.build_tmass(self.plan, self.N, self.gda, self.gweight)
        self.nmass = 1.0 / self.tmass
        self.adv_geo = adv_mod.build_advection_geometry(g, m, self.tmass)
        # per-layer surface-area weights for horizontal averaging
        self._layer_weights = to(self._build_layer_weights())
        layer = np.arange(m.nno) % cfg.nodez
        self._layer = torch.from_numpy(layer).to(dev)
        # the layer sums run sorted by layer, each layer in node order, as
        # ScatterPlan sums nodes (int32, as its plan): a fixed order of
        # addition on the card
        layer_order = np.argsort(layer, kind="stable")
        self._layer_order = torch.from_numpy(
            layer_order.astype(np.int32)).to(dev)
        self._layer_sorted = torch.from_numpy(
            layer[layer_order].astype(np.int32)).to(dev)
        self.stencil_plan = StencilPlan.build(cfg, dev)
        self.uzawa_params = sol.UzawaParams(
            cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
            cfg.vlowstep, cfg.check_pressure_convergence)

    # ---------- initialization ----------

    def init_state(self) -> State:
        T = torch.as_tensor(initial_temperature(self.mesh), dtype=self.dtype,
                            device=self.device)
        V = asm.apply_vbc(torch.zeros((self.mesh.nno, 3), dtype=self.dtype,
                                      device=self.device),
                          self.vbc_mask, self.vbc_val)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return State(T, torch.zeros_like(T), V,
                     torch.zeros((self.mesh.nel,), dtype=self.dtype,
                                 device=self.device), zero, zero.clone(), 0)

    def _build_layer_weights(self) -> np.ndarray:
        """(nno,) per-node surface-area lumping within its own z-layer
        (return_horiz_ave_f semantics: layer average = surface integral /
        surface area)."""
        m = self.mesh
        nox, noy, noz = m.cfg.nodex, m.cfg.nodey, m.cfg.nodez
        w = np.zeros((noy, nox, noz))
        th, r = m.theta, m.r
        dphi = m.fi[1] - m.fi[0] if noy > 1 else 1.0
        for j in range(nox - 1):
            band = (np.cos(th[j]) - np.cos(th[j + 1]))  # theta band area factor
            for k in range(noz):
                cell = 0.25 * band * dphi * r[k] ** 2
                w[:-1, j, k] += cell
                w[1:, j, k] += cell
                w[:-1, j + 1, k] += cell
                w[1:, j + 1, k] += cell
        return w.reshape(-1)

    # ---------- physics pieces ----------

    def buoyancy(self, T):
        """Ra * T with the per-layer horizontal average removed
        (get_buoyancy, Pan_problem_misc_functions.c:151-235)."""
        buoy = self.cfg.rayleigh * T
        noz = self.cfg.nodez
        wsum = sorted_segment_sum(self._layer_weights, self._layer_sorted,
                                  noz, order=self._layer_order)
        bsum = sorted_segment_sum(buoy * self._layer_weights,
                                  self._layer_sorted, noz,
                                  order=self._layer_order)
        return buoy - (bsum / wsum)[self._layer]

    def _build_ops(self, T, V=None) -> asm.StokesOperators:
        cfg = self.cfg
        srII = None
        if (cfg.SDEPV or cfg.PDEPV) and V is not None:
            srII = strain_rate_2inv(self.B, self.ien, V)[:, None]
        evisc = viscosity_at_vpts(cfg, self.mat, T, self.ien, self.N,
                                  strain_rate_II=srII,
                                  r_nodes=self.r_nodes)
        elt_k = asm.build_elt_k(self.B, self.gda, self.gweight, evisc)
        BI = asm.build_diag_K(elt_k, self.plan)
        BPI = asm.build_bpi(self.G, BI, self.ien, self.vbc_mask)
        return asm.StokesOperators(self.ien, elt_k, self.G, self.vbc_mask,
                                   self.vbc_val, BI, BPI, self.plan)

    def _stokes(self, T, V, P):
        """general_stokes_solver (Drive_solvers.c:64): one viscosity ->
        stiffness -> forces -> Uzawa pass, plus the nonlinear outer
        iteration for velocity-dependent viscosity (SDEPV/PDEPV,
        Drive_solvers.c:92-147): re-evaluate eta from the new V, rebuild,
        re-solve until dUdot = vnorm_nonnewt(delta_U, U) drops below
        sdepv_misfit or 50 iterations pass."""
        V1, P1, mon = self._stokes_once(T, V, P)
        if not (self.cfg.SDEPV or self.cfg.PDEPV):
            return V1, P1, mon

        def dudot(dU, U):
            # vnorm_nonnewt (Global_operations.c:771-788): element-
            # gathered dof sums (nodes weighted by element valence)
            d, u = dU[self.ien], U[self.ien]
            return torch.sqrt(torch.sum(d * d)
                              / torch.sum(u * u).clamp(min=1e-300))

        # the reference enters the loop with oldU=0, so dUdot starts at 1
        # and at least one re-solve always happens
        it = 1
        dmag = torch.ones((), dtype=V1.dtype, device=V1.device)
        while it <= 50 and sol.host_true(dmag >= self.cfg.sdepv_misfit):
            Vn, P1, mon = self._stokes_once(T, V1, P1)
            dmag = dudot(Vn - V1, Vn)
            V1 = Vn
            it += 1
        return V1, P1, mon

    def _stokes_once(self, T, V, P):
        """One viscosity -> stiffness -> forces -> Uzawa pass."""
        ops = self._build_ops(T, V)
        buoy = self.buoyancy(T)
        F = asm.assemble_forces(ops, self.N, self.gda, self.gweight,
                                self.cc, buoy)
        fdotf = torch.sqrt(torch.dot(F.reshape(-1), F.reshape(-1)))
        V = asm.apply_vbc(V, self.vbc_mask, self.vbc_val)
        prob = sol.local_problem(ops, self.nmass, self.e_area,
                                 self.total_volume)
        # the velocity stiffness matvec is an ENGINE choice between the
        # element-by-element form and the 27-point nodal stencil
        # (assemble_del2_u's dispatch, Element_calculations.c:428-443);
        # on this regular grid the dispatcher picks the stencil, built
        # once per viscosity update
        W = build_stencil(ops.elt_k, self.stencil_plan)
        og = engine.build_operator(
            {"stencil": {"W": W, "mask": self.vbc_mask},
             "eltk": {"ops": ops}},
            stats={"regular_grid": True, "nel": self.mesh.nel})
        prob = prob._replace(A=lambda u: engine.apply_operator(og, u))
        if self.cfg.solver_type in ("bicg", "bicgstab"):
            return sol.uzawa_bicgstab(prob, V, P, F, fdotf, self.uzawa_params)
        return sol.uzawa_cg(prob, V, P, F, fdotf, self.uzawa_params)

    def _timestep(self, s: State):
        cfg = self.cfg
        dt0 = adv_mod.cfl_timestep(self.adv_geo, self.ien, s.V,
                                   finetunedt=cfg.finetunedt,
                                   fixed_timestep=cfg.fixed_timestep)

        def advect(dt):
            return adv_mod.pg_timestep(
                self.adv_geo, self.ien, self.plan, s.T, s.Tdot, s.V, dt,
                diff=cfg.inputdiffusivity, Q0=cfg.Q0, gamma=cfg.adv_gamma,
                sub_iterations=cfg.adv_sub_iterations,
                tbc_mask=self.tbc_mask, tbc_val=self.tbc_val)

        # max-T guard with dt-halving subcycles (PG_timestep_solve
        # do/while, Advection_diffusion.c:234-280; T_maxvaried=1.05,
        # Convection.c:58; at most 5 retries)
        T, Tdot, dt = adv_mod.advect_monitored(advect, s.T, dt0,
                                               self.tbc_mask,
                                               cfg.monitor_max_T)
        if cfg.filter_temp:
            T = filter_temperature(T, self.tbc_mask, self.tbc_val)
        V, P, mon = self._stokes(T, s.V, s.P)
        diag = StepDiagnostics(dt, mon.v_norm, mon.p_norm,
                               mon.incompressibility, mon.outer_iterations,
                               mon.inner_iterations)
        return State(T, Tdot, V, P, s.time + dt, dt, s.step + 1), diag

    # ---------- public API ----------

    def initial_solve(self, s: State):
        """The pre-loop Stokes solve (Citcom.c:160-172 initial_conditions)."""
        V, P, mon = self._stokes(s.T, s.V, s.P)
        return dataclasses.replace(s, V=V, P=P), mon

    def stokes(self, T, V, P):
        """One general_stokes_solver pass (tests/drivers entry)."""
        return self._stokes(T, V, P)

    def step(self, s: State):
        return self._timestep(s)

    def step_with_bcs(self, s: State, bcs):
        _not_ported("time-dependent boundary-condition files (bc_files.py)",
                    _QUEUE_TAIL)

    def step_tracers(self, s: State, pos, flavors):
        _not_ported("the thermochemical step (tracers.py)", _QUEUE_TAIL)

    def run(self, n_steps: Optional[int] = None, *, verbose: bool = False,
            write_output: bool = False, checkpoint: bool = False,
            restart_from: Optional[str] = None):
        """Main loop (bin/Citcom.c:199-281): initial solve, then per step
        advection + Stokes. Returns (state, [StepDiagnostics])."""
        if write_output:
            _not_ported("output (output.py, vtk.py)", _QUEUE_TAIL)
        if checkpoint or restart_from:
            _not_ported("checkpoints (ckpt.save_citcoms)", _QUEUE_TAIL)
        n = self.cfg.maxstep if n_steps is None else n_steps
        s, _ = self.initial_solve(self.init_state())
        history = []
        for _ in range(n):
            s, diag = self.step(s)
            history.append(diag)
            if verbose:
                print(f"step {s.step}: t={float(s.time):.5e} "
                      f"dt={float(diag.dt):.4e} v={float(diag.v_norm):.6e} "
                      f"p={float(diag.p_norm):.6e} "
                      f"div/v={float(diag.incompressibility):.3e} "
                      f"uzawa={diag.uzawa_iterations} "
                      f"cg={diag.inner_iterations}")
        return s, history


def _check_ported(cfg: CitcomConfig):
    """Raise for every configuration branch whose modules are not in the
    port yet, so none is silently skipped."""
    if cfg.solver_type == "multigrid":
        _not_ported("Solver=multigrid (multigrid.py)", _QUEUE_TAIL)
    if cfg.lith_age:
        _not_ported("lith_age (lith_age.py)", _QUEUE_TAIL)
    if cfg.Ra_410 != 0.0 or cfg.Ra_670 != 0.0 or cfg.Ra_cmb != 0.0:
        _not_ported("phase changes (phase_change.py)", _QUEUE_TAIL)
    if cfg.disptn_number != 0.0:
        _not_ported("the TALA anelastic terms (disptn_number)", _QUEUE_TAIL)
    if cfg.ANIVISC and cfg.ani_vis2_factor != 0.0:
        _not_ported("anisotropic viscosity (anisotropic.py)", _QUEUE_TAIL)
    if ((cfg.vbcs_file and cfg.vel_bound_file)
            or (cfg.tbcs_file and cfg.temp_bound_file)):
        _not_ported("time-dependent boundary-condition files (bc_files.py)",
                    _QUEUE_TAIL)


def state_from_numpy(model: CitcomModel, arrays: Mapping) -> State:
    """The port's State from a State's fields as numpy arrays (T, Tdot, V,
    P, time, dt, step), e.g. the reference model's, in the model's dtype
    and on its device."""
    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=model.dtype,
                            device=model.device)

    return State(t("T"), t("Tdot"), t("V"), t("P"), t("time"), t("dt"),
                 int(arrays["step"]))
