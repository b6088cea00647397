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
solver loops on the host (solvers.py, multigrid.py). The configuration
branches of the reference's regional model all run here: Solver=cgrad,
bicgstab and multigrid, SDEPV/PDEPV, thermochemical tracers, phase
changes, TALA, anisotropic viscosity, lith_age and boundary-condition
file sequences; `run` writes output and checkpoints and restarts from one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from g4s_tpu_torch import ckpt, engine
from g4s_tpu_torch.models.citcoms import advection as adv_mod
from g4s_tpu_torch.models.citcoms import assembly as asm
from g4s_tpu_torch.models.citcoms import bc_files
from g4s_tpu_torch.models.citcoms import lith_age as la
from g4s_tpu_torch.models.citcoms import output as out_mod
from g4s_tpu_torch.models.citcoms import solvers as sol
from g4s_tpu_torch.models.citcoms.anisotropic import (build_elt_k_aniso,
                                                      constitutive_orthotropic,
                                                      constitutive_ti)
from g4s_tpu_torch.models.citcoms.config import CitcomConfig
from g4s_tpu_torch.models.citcoms.mesh import (RegionalMesh,
                                               build_regional_mesh,
                                               initial_temperature)
from g4s_tpu_torch.models.citcoms.nodal import (StencilPlan, build_stencil,
                                                nodal_matvec)
from g4s_tpu_torch.models.citcoms.multigrid import MGHierarchy
from g4s_tpu_torch.models.citcoms.observables import filter_temperature
from g4s_tpu_torch.models.citcoms.phase_change import (_transitions,
                                                       apply_phase_changes,
                                                       phase_function)
from g4s_tpu_torch.models.citcoms.shapes import FEMGeometry, build_geometry
from g4s_tpu_torch.models.citcoms.tracers import (TracerField, advect_tracers,
                                                  composition_to_nodes,
                                                  element_composition)
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
        f"{what} is not ported to g4s_tpu_torch ({where} of ROADMAP.md)")


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
                 device="cuda", df64_inner: bool = False,
                 matvec: str = "auto"):
        """matvec: the velocity stiffness product, "auto" (the engine's
        choice: the 27-point stencil on this regular grid) or "eltk" (the
        element-by-element form, the one DistributedCitcom runs)."""
        if df64_inner:
            _not_ported("the df64 inner solver (df64_solver.py), which "
                        "exists for a chip without f64", "\"Not ported\"")
        if matvec not in ("auto", "eltk"):
            raise ValueError(f"matvec {matvec!r}: expected 'auto' or 'eltk'")
        self.matvec = matvec
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
        tbc_mask, tbc_val = m.tbc_mask, m.tbc_val
        if cfg.lith_age:
            # half-space-cooling initial T + essential TBCs in the lid
            nsf = cfg.nodex * cfg.nodey
            if cfg.lith_age_file:
                ages = la.read_age_file(cfg.lith_age_file, nsf)
            else:
                ages = np.full(nsf, cfg.lith_age_uniform_myr)
            self._age_nd = la.age_to_nondim(cfg, ages)
            tbc_mask, tbc_val = la.lith_age_tbc(cfg, m, self._age_nd,
                                                tbc_mask, tbc_val)
            self.tbc_mask = torch.from_numpy(tbc_mask).to(dev)
            self.tbc_val = to(tbc_val)
        # host copies of the base boundary conditions, into which the
        # bc-file sequences stamp each step's fields (bc_files.step_bcs)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.host_bcs = (np.array(tbc_mask), np.asarray(tbc_val, np_dtype),
                         np.array(m.vbc_mask),
                         np.asarray(m.vbc_val, np_dtype))
        self.stencil_plan = StencilPlan.build(cfg, dev)
        self.uzawa_params = sol.UzawaParams(
            cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
            cfg.vlowstep, cfg.check_pressure_convergence)
        self.mg = None
        if cfg.solver_type == "multigrid":
            # Solver=multigrid: inner velocity solves run V-cycles with the
            # colored-GS smoother (General_matrix_functions.c:97-120)
            self.mg = MGHierarchy(cfg, levels=max(cfg.levels, 2),
                                  dtype=dtype, device=dev)
        self.tracer_field = TracerField.from_mesh(m)
        self._aniso_D = None
        if cfg.ANIVISC and cfg.ani_vis2_factor != 0.0:
            # the 6x6 constitutive matrix of a radial director, built once
            n_dir = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
            if cfg.anivisc_mode == "ti":
                self._aniso_D = constitutive_ti(cfg.ani_vis2_factor,
                                                cfg.anivisc_gamma, n_dir)
            else:
                self._aniso_D = constitutive_orthotropic(cfg.ani_vis2_factor,
                                                         n_dir)

    # ---------- initialization ----------

    def init_state(self) -> State:
        if self.cfg.lith_age:
            T0 = la.lith_age_tic(self.cfg, self.mesh, self._age_nd)
        else:
            T0 = initial_temperature(self.mesh)
        T = torch.as_tensor(T0, dtype=self.dtype, device=self.device)
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

    def buoyancy(self, T, C=None):
        """Ra * T minus chemical (get_buoyancy,
        Pan_problem_misc_functions.c:170-182: buoy -= Ra*ratio*C) and
        phase-change terms, with the per-layer horizontal average removed
        (Pan_problem_misc_functions.c:151-235)."""
        cfg = self.cfg
        buoy = cfg.rayleigh * T
        if C is not None:
            buoy = buoy - cfg.rayleigh * cfg.buoyancy_ratio * C
        if cfg.Ra_410 != 0.0 or cfg.Ra_670 != 0.0 or cfg.Ra_cmb != 0.0:
            buoy = apply_phase_changes(cfg, self.r_nodes, T, buoy)
        noz = self.cfg.nodez
        wsum = sorted_segment_sum(self._layer_weights, self._layer_sorted,
                                  noz, order=self._layer_order)
        bsum = sorted_segment_sum(buoy * self._layer_weights,
                                  self._layer_sorted, noz,
                                  order=self._layer_order)
        return buoy - (bsum / wsum)[self._layer]

    def _build_ops(self, T, C=None, V=None, vbc=None) -> asm.StokesOperators:
        vbc_mask, vbc_val = vbc if vbc is not None \
            else (self.vbc_mask, self.vbc_val)
        cfg = self.cfg
        srII = None
        if (cfg.SDEPV or cfg.PDEPV) and V is not None:
            srII = strain_rate_2inv(self.B, self.ien, V)[:, None]
        evisc = viscosity_at_vpts(cfg, self.mat, T, self.ien, self.N,
                                  strain_rate_II=srII, C_nodes=C,
                                  r_nodes=self.r_nodes)
        if self._aniso_D is not None:
            elt_k = build_elt_k_aniso(self.B, self.gda, self.gweight,
                                      evisc, self._aniso_D)
        else:
            elt_k = asm.build_elt_k(self.B, self.gda, self.gweight, evisc)
        BI = asm.build_diag_K(elt_k, self.plan)
        BPI = asm.build_bpi(self.G, BI, self.ien, vbc_mask)
        elt_c = None
        if cfg.disptn_number != 0.0:
            beta = -cfg.disptn_number / cfg.gruneisen
            elt_c = asm.build_elt_c(self.cc, self.e_area, beta)
        return asm.StokesOperators(self.ien, elt_k, self.G, vbc_mask,
                                   vbc_val, BI, BPI, self.plan, elt_c)

    def _stokes(self, T, V, P, C=None, vbc=None):
        """general_stokes_solver (Drive_solvers.c:64): one viscosity ->
        stiffness -> forces -> Uzawa pass, plus the nonlinear outer
        iteration for velocity-dependent viscosity (SDEPV/PDEPV,
        Drive_solvers.c:92-147): re-evaluate eta from the new V, rebuild,
        re-solve until dUdot = vnorm_nonnewt(delta_U, U) drops below
        sdepv_misfit or 50 iterations pass."""
        V1, P1, mon = self._stokes_once(T, V, P, C, vbc)
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
            Vn, P1, mon = self._stokes_once(T, V1, P1, C, vbc)
            dmag = dudot(Vn - V1, Vn)
            V1 = Vn
            it += 1
        return V1, P1, mon

    def _stokes_once(self, T, V, P, C=None, vbc=None):
        """One viscosity -> stiffness -> forces -> Uzawa pass."""
        vbc_mask, vbc_val = vbc if vbc is not None \
            else (self.vbc_mask, self.vbc_val)
        ops = self._build_ops(T, C, V, vbc=vbc)
        buoy = self.buoyancy(T, C)
        F = asm.assemble_forces(ops, self.N, self.gda, self.gweight,
                                self.cc, buoy)
        fdotf = torch.sqrt(torch.dot(F.reshape(-1), F.reshape(-1)))
        V = asm.apply_vbc(V, vbc_mask, vbc_val)
        prob = sol.local_problem(ops, self.nmass, self.e_area,
                                 self.total_volume)
        # the velocity stiffness matvec is an ENGINE choice between the
        # element-by-element form and the 27-point nodal stencil
        # (assemble_del2_u's dispatch, Element_calculations.c:428-443);
        # on this regular grid the dispatcher picks the stencil, built
        # once per viscosity update
        candidates = {"eltk": {"ops": ops}}
        if self.matvec == "auto":
            candidates["stencil"] = {
                "W": build_stencil(ops.elt_k, self.stencil_plan),
                "mask": vbc_mask}
        og = engine.build_operator(
            candidates, stats={"regular_grid": True, "nel": self.mesh.nel})
        prob = prob._replace(A=lambda u: engine.apply_operator(og, u))
        if self.cfg.solver_type in ("bicg", "bicgstab"):
            return sol.uzawa_bicgstab(prob, V, P, F, fdotf, self.uzawa_params)
        if self.cfg.solver_type == "multigrid":
            # the finest level shares the operators just built (they carry
            # the C/strain-rate/bc effects the hierarchy recomputes from T
            # alone on coarse levels); the smoothers are built once here,
            # for every inner solve of this pass
            ops_all = self.mg.build_ops(T, finest=ops)
            smooth = self.mg.build_smoothers(ops_all)

            def inner_solve(F_, acc_):
                u, res, it = self.mg.solve(ops_all, F_, acc=acc_,
                                           smoothers=smooth)
                return sol.CGResult(u, res, it)

            return sol.uzawa_cg(prob, V, P, F, fdotf, self.uzawa_params,
                                inner_solve=inner_solve)
        return sol.uzawa_cg(prob, V, P, F, fdotf, self.uzawa_params)

    def _tala_heating(self, s: State):
        """TALA heating terms (Advection_diffusion.c:617: heating = Q - adi
        + visc): adiabatic cooling Di u_r (T+Ts) and viscous dissipation
        (Di/Ra) Phi per element, with latent heating at phase transitions
        (latent_heating, Advection_diffusion.c:830-868: adds to the
        adiabatic term and scales source+diffusion by the capacity
        factor). Returns (Q_src (nel, 1), diff_eff (nel, 1))."""
        cfg = self.cfg
        Di = cfg.disptn_number
        u_el = s.V[self.ien]
        T_el = s.T[self.ien]
        adi = Di * torch.mean(u_el[:, :, 2] * (T_el + cfg.surfaceT), dim=1)
        evisc = viscosity_at_vpts(cfg, self.mat, s.T, self.ien, self.N)
        ee2 = strain_rate_2inv(self.B, self.ien, s.V, sqrt=False)
        viscH = (Di / max(abs(cfg.rayleigh), 1e-300)) \
            * 2.0 * evisc.mean(dim=1) * ee2
        lat = torch.ones(self.mesh.nel, dtype=self.dtype, device=self.device)
        for (Ra_ph, clap, depth, transT, width) in _transitions(cfg):
            B = phase_function(cfg, self.r_nodes, s.T, clap, depth, transT,
                               width)
            f_el = ((1.0 - B) * B * (s.T + cfg.surfaceT))[self.ien]
            t0 = 2.0 / width * clap * Di * Ra_ph \
                / max(abs(cfg.rayleigh), 1e-300)
            adi = adi + t0 * torch.mean(f_el * u_el[:, :, 2], dim=1)
            lat = lat + t0 * clap * torch.mean(f_el, dim=1)
        Q_src = ((cfg.Q0 - adi + viscH) * lat)[:, None]
        return Q_src, cfg.inputdiffusivity * lat[:, None]

    def _timestep(self, s: State, pos=None, flavors=None, bcs=None):
        # bcs: optional (tbc_mask, tbc_val, vbc_mask, vbc_val) override
        # (the time-dependent bc-file sequences, step_with_bcs)
        if bcs is not None:
            tbc_mask, tbc_val, vbc_mask, vbc_val = bcs
        else:
            tbc_mask, tbc_val = self.tbc_mask, self.tbc_val
            vbc_mask, vbc_val = self.vbc_mask, self.vbc_val
        cfg = self.cfg
        dt0 = adv_mod.cfl_timestep(self.adv_geo, self.ien, s.V,
                                   finetunedt=cfg.finetunedt,
                                   fixed_timestep=cfg.fixed_timestep)
        if cfg.disptn_number != 0.0:
            Q_src, diff_eff = self._tala_heating(s)
        else:
            Q_src, diff_eff = cfg.Q0, cfg.inputdiffusivity

        def advect(dt):
            return adv_mod.pg_timestep(
                self.adv_geo, self.ien, self.plan, s.T, s.Tdot, s.V, dt,
                diff=diff_eff, Q0=Q_src, gamma=cfg.adv_gamma,
                sub_iterations=cfg.adv_sub_iterations,
                tbc_mask=tbc_mask, tbc_val=tbc_val)

        # max-T guard with dt-halving subcycles (PG_timestep_solve
        # do/while, Advection_diffusion.c:234-280; T_maxvaried=1.05,
        # Convection.c:58; at most 5 retries)
        T, Tdot, dt = adv_mod.advect_monitored(advect, s.T, dt0, tbc_mask,
                                               cfg.monitor_max_T)
        if cfg.filter_temp:
            T = filter_temperature(T, tbc_mask, tbc_val)
        C = None
        if pos is not None:
            # thermochemical step: advect tracers with the same dt, map the
            # dense-flavor fraction to nodes, include chemical buoyancy
            tf = self.tracer_field
            pos = advect_tracers(tf, s.V, pos, dt)
            comp_el, _ = element_composition(tf, pos, flavors, 2)
            C = composition_to_nodes(tf, comp_el[1], self.plan, self.ien)
        V, P, mon = self._stokes(T, s.V, s.P, C=C, vbc=(vbc_mask, vbc_val))
        diag = StepDiagnostics(dt, mon.v_norm, mon.p_norm,
                               mon.incompressibility, mon.outer_iterations,
                               mon.inner_iterations)
        new_s = State(T, Tdot, V, P, s.time + dt, dt, s.step + 1)
        if pos is not None:
            return new_s, diag, pos
        return new_s, diag

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
        """Timestep with per-step boundary-condition overrides (the
        time-dependent BC file sequences of bin/Citcom.c:254-272; bcs =
        (tbc_mask, tbc_val, vbc_mask, vbc_val) on the model's device, as
        bc_files.step_bcs gives them)."""
        return self._timestep(s, bcs=bcs)

    def step_tracers(self, s: State, pos, flavors):
        """Thermochemical timestep (tracer advection + ratio-method
        composition -> chemical buoyancy). pos (n, 3) in the model's dtype
        and flavors (n,) on its device. Returns (state, diag, pos)."""
        return self._timestep(s, pos, flavors)

    def _checkpoint(self, s: State, step_no: int):
        os.makedirs(self.cfg.datadir, exist_ok=True)
        ckpt.save_citcoms(
            os.path.join(self.cfg.datadir,
                         f"{self.cfg.datafile}.chkpt.0.{step_no}"),
            s, self.cfg)

    def run(self, n_steps: Optional[int] = None, *, verbose: bool = False,
            write_output: bool = False, checkpoint: bool = False,
            restart_from: Optional[str] = None, stop_flag=None):
        """Main loop (bin/Citcom.c:199-281): initial solve (or the state
        of `restart_from`), then per step advection + Stokes, with output
        every storage_spacing steps and checkpoints every
        checkpoint_frequency steps; `stop_flag()` true after a step writes
        a checkpoint and stops. Returns (state, [StepDiagnostics])."""
        cfg = self.cfg
        n = cfg.maxstep if n_steps is None else n_steps
        if restart_from:
            s, _ = ckpt.load_citcoms(restart_from, self)
        else:
            s, _ = self.initial_solve(self.init_state())
        if write_output:
            out_mod.output(self, s, int(s.step))
        history = []
        use_bc_files = bc_files.uses_bc_files(cfg)
        for _ in range(n):
            if use_bc_files:
                bcs = bc_files.step_bcs(self, float(s.time))
                s, diag = self.step_with_bcs(s, bcs) \
                    if bcs is not None else self.step(s)
            else:
                s, diag = self.step(s)
            history.append(diag)
            step_no = int(s.step)
            if write_output and step_no % cfg.storage_spacing == 0:
                out_mod.output(self, s, step_no)
            if checkpoint and step_no % cfg.checkpoint_frequency == 0:
                self._checkpoint(s, step_no)
            if stop_flag is not None and stop_flag():
                self._checkpoint(s, step_no)
                if verbose:
                    print(f"# graceful stop at step {step_no}; "
                          f"checkpoint written")
                break
            if verbose:
                print(f"step {step_no}: t={float(s.time):.5e} "
                      f"dt={float(diag.dt):.4e} v={float(diag.v_norm):.6e} "
                      f"p={float(diag.p_norm):.6e} "
                      f"div/v={float(diag.incompressibility):.3e} "
                      f"uzawa={diag.uzawa_iterations} "
                      f"cg={diag.inner_iterations}")
        return s, history


def state_from_numpy(model, arrays: Mapping) -> State:
    """The port's State from a State's fields as numpy arrays (T, Tdot, V,
    P, time, dt, step), e.g. the reference model's, in the model's dtype
    and on its device. `model` is a CitcomModel or a FullSphereModel
    (both hold the same State)."""
    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=model.dtype,
                            device=model.device)

    return State(t("T"), t("Tdot"), t("V"), t("P"), t("time"), t("dt"),
                 int(arrays["step"]))
