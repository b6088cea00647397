"""Full-sphere convection model (counterpart of
g4s_tpu/models/citcoms/full_driver.py, the reference's CitcomSFull solver).

One global solve over the merged 12-cap mesh (the solver registry's "full"
branch, citcoms/lib/Full_solver.c). The inter-cap seams are resolved by
node identification (full_mesh merges them), so the regional model's
assembly and solver machinery runs globally, with the element-by-element
K u (the caps' elements are not a regular grid, so there is no stencil).

Free-slip top/bottom leaves the 3 rigid rotations in the operator's
nullspace; `remove_net_rotation` (Determine_net_rotation.c capability)
projects them out of a velocity field.

Mesh constants are built once in f64 on the host and cast to the model's
dtype on its device; a step runs eagerly, its solver loops on the host
(solvers.py), with no other read of the device.

Over several ranks (torch.distributed), `shard_full_sphere` and
`shard_full_step` split the ELEMENTS over one RankGrid axis
(ElementShardedFullSphere), as the reference's pjit does:
  - replicated on every rank: every nodal field (T, Tdot, V, the boundary
    masks and values, the lumped mass, the layer sums, the net-rotation
    bases) and the step's scalars;
  - sharded: every per-element tensor (ien, B, gda, cc, G, gradN, volume,
    materials, sizes and each solve's elt_k) and the pressure inside a
    solve;
  - collectives: one all-reduce (SUM) after every element-to-node scatter
    (the rank's sorted segment sum), one per pressure dot or norm and per
    velocity dot or norm (each rank sums its own range of nodes), one
    all-rank maximum for the CFL rate and for the max-T guard, and one
    all-gather of P at the end of a solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms import advection as adv_mod
from g4s_tpu_torch.models.citcoms import assembly as asm
from g4s_tpu_torch.models.citcoms import full_tracers as ft
from g4s_tpu_torch.models.citcoms import solvers as sol
from g4s_tpu_torch.models.citcoms.config import CitcomConfig
from g4s_tpu_torch.models.citcoms.driver import State, StepDiagnostics
from g4s_tpu_torch.models.citcoms.full_mesh import (FullSphereMesh,
                                                    _sph_to_xyz,
                                                    build_full_sphere_mesh)
from g4s_tpu_torch.models.citcoms.shapes import (_PPOINT,
                                                 build_geometry_general,
                                                 shape_n)
from g4s_tpu_torch.models.citcoms.viscosity import viscosity_at_vpts
from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.parallel.collectives import pmax, psum_scalar
from g4s_tpu_torch.sparse.containers import resolve_device


class FullSphereModel:
    """CitcomSFull-equivalent global solver (energy + Stokes) on
    `device`."""

    def __init__(self, cfg: CitcomConfig, *, dtype=torch.float64,
                 device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        self.mesh: FullSphereMesh = build_full_sphere_mesh(
            cfg.nodex, cfg.nodey, cfg.nodez, cfg.radius_inner,
            cfg.radius_outer)
        self.geo = build_geometry_general(self.mesh.sx, self.mesh.ien)
        m, g = self.mesh, self.geo
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype

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
        self.gradN = to(g.gradN_phys)
        self.e_area = to(g.volume)
        self.total_volume = float(g.volume.sum())
        self.mat = torch.zeros(m.nel, dtype=torch.int64, device=dev)

        # BCs: free-slip (u_r = 0) or prescribed at top/bottom
        vbc_mask = np.zeros((m.nno, 3), dtype=bool)
        vbc_val = np.zeros((m.nno, 3))
        vbc_mask[m.surf_ids, 2] = True
        vbc_mask[m.bot_ids, 2] = True
        if cfg.topvbc == 1:
            vbc_mask[m.surf_ids, :] = True
            vbc_val[m.surf_ids, 0] = cfg.topvbxval
            vbc_val[m.surf_ids, 1] = cfg.topvbyval
        tbc_mask = np.zeros(m.nno, dtype=bool)
        tbc_val = np.zeros(m.nno)
        tbc_mask[m.surf_ids] = cfg.toptbc != 0
        tbc_val[m.surf_ids] = cfg.toptbcval
        tbc_mask[m.bot_ids] = cfg.bottbc != 0
        tbc_val[m.bot_ids] = cfg.bottbcval
        self.vbc_mask = torch.from_numpy(vbc_mask).to(dev)
        self.vbc_val = to(vbc_val)
        self.tbc_mask = torch.from_numpy(tbc_mask).to(dev)
        self.tbc_val = to(tbc_val)
        self._host_tbc = (tbc_mask, tbc_val.astype(np_dtype))

        self.tmass = asm.build_tmass(self.plan, self.N, self.gda,
                                     self.gweight)
        self.nmass = 1.0 / self.tmass
        self.uzawa_params = sol.UzawaParams(
            cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
            cfg.vlowstep, cfg.check_pressure_convergence)

        # element physical sizes for CFL (Cartesian edge lengths); the
        # diffusive limit from the sizes in the model's dtype, as the
        # reference takes it
        xyz = _sph_to_xyz(m.sx[:, 0], m.sx[:, 1]) * m.sx[:, 2:3]
        exyz = xyz[m.ien]
        e_size = np.stack(
            [np.linalg.norm(exyz[:, 1] - exyz[:, 0], axis=1),
             np.linalg.norm(exyz[:, 3] - exyz[:, 0], axis=1),
             np.linalg.norm(exyz[:, 4] - exyz[:, 0], axis=1)], axis=1)
        self.e_size = to(e_size)
        self.diff_dt = 0.5 * float(e_size.astype(np_dtype).min() ** 2)
        self.N_center = to(shape_n(_PPOINT))
        self._xyz = xyz
        self.adv_geo = adv_mod.AdvectionGeometry(
            self.N, self.N_center, self.gweight, self.gda, self.gradN,
            self.e_size, self.tmass, to(self.diff_dt))

        # remove_net_rotation's node positions and spherical bases
        th, fi = m.sx[:, 0], m.sx[:, 1]
        st, ct, sf, cf = np.sin(th), np.cos(th), np.sin(fi), np.cos(fi)
        self._xyz_t = to(xyz)
        self._e_t = to(np.stack([ct * cf, ct * sf, -st], axis=1))
        self._e_f = to(np.stack([-sf, cf, np.zeros_like(sf)], axis=1))
        self._e_r = to(np.stack([st * cf, st * sf, ct], axis=1))

        # the buoyancy layer sums run sorted by layer, each layer in node
        # order (int32, as ScatterPlan): a fixed order of addition on the
        # card; the weights' sums once, here
        layer = np.arange(m.nno) % cfg.nodez
        order = np.argsort(layer, kind="stable")
        self._layer = torch.from_numpy(layer).to(dev)
        self._layer_order = torch.from_numpy(order.astype(np.int32)).to(dev)
        self._layer_sorted = torch.from_numpy(
            layer[order].astype(np.int32)).to(dev)
        self._layer_wsum = sorted_segment_sum(
            self.nmass, self._layer_sorted, cfg.nodez,
            order=self._layer_order)
        # the reciprocal of each node's element count, float32: the
        # reference's compiled tracer step folds the constant count into a
        # reciprocal, so its nodal composition is a product by it
        ones = torch.ones((m.nel, 8, 1), dtype=torch.float32, device=dev)
        self._inv_valence = 1.0 / self.plan.scatter(ones)[:, 0].clamp(
            min=1.0)
        self._tracer_field = None

    # ------------------------------------------------------------------
    def init_state(self) -> State:
        cfg = self.cfg
        r = self.mesh.sx[:, 2]
        T = cfg.bottbcval - (cfg.toptbcval + cfg.bottbcval) \
            * (r - cfg.radius_inner) / (cfg.radius_outer - cfg.radius_inner)
        T = np.where(*self._host_tbc, T)
        V = asm.apply_vbc(torch.zeros((self.mesh.nno, 3), dtype=self.dtype,
                                      device=self.device),
                          self.vbc_mask, self.vbc_val)
        T = torch.as_tensor(T, dtype=self.dtype, device=self.device)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return State(T, torch.zeros_like(T), V,
                     torch.zeros(self.mesh.nel, dtype=self.dtype,
                                 device=self.device), zero, zero.clone(), 0)

    def buoyancy(self, T, C=None):
        """Ra*T minus chemical buoyancy (get_buoyancy:
        buoy -= Ra * buoyancy_ratio * C) minus the per-radial-layer
        average (mass-weighted)."""
        buoy = self.cfg.rayleigh * T
        if C is not None:
            buoy = buoy - self.cfg.rayleigh * self.cfg.buoyancy_ratio * C
        bsum = sorted_segment_sum(buoy * self.nmass, self._layer_sorted,
                                  self.cfg.nodez, order=self._layer_order)
        return buoy - (bsum / self._layer_wsum)[self._layer]

    def _build_ops(self, T) -> asm.StokesOperators:
        evisc = viscosity_at_vpts(self.cfg, self.mat, T, self.ien, self.N)
        elt_k = asm.build_elt_k(self.B, self.gda, self.gweight, evisc)
        BI = asm.build_diag_K(elt_k, self.plan)
        BPI = asm.build_bpi(self.G, BI, self.ien, self.vbc_mask)
        return asm.StokesOperators(self.ien, elt_k, self.G, self.vbc_mask,
                                   self.vbc_val, BI, BPI, self.plan)

    def _stokes(self, T, V, P, C=None):
        ops = self._build_ops(T)
        buoy = self.buoyancy(T, C)
        F = asm.assemble_forces(ops, self.N, self.gda, self.gweight,
                                self.cc, buoy)
        prob = self._problem(ops)
        fdotf = torch.sqrt(prob.dot_v(F, F))
        V = asm.apply_vbc(V, self.vbc_mask, self.vbc_val)
        V, P, mon = sol.uzawa_cg(prob, V, P, F, fdotf, self.uzawa_params)
        return self.remove_net_rotation(V), P, mon

    def _problem(self, ops: asm.StokesOperators) -> sol.StokesProblem:
        return sol.local_problem(ops, self.nmass, self.e_area,
                                 self.total_volume)

    @staticmethod
    def _max(x):
        """The largest entry of x (a sharded model's: over every rank)."""
        return torch.amax(x)

    # ------------------------------------------------------------------
    def remove_net_rotation(self, V):
        """Project the rigid rotations out of V (remove_rigid_rot /
        Determine_net_rotation.c): omega = I^-1 L with L = int r x u dV.
        The 3x3 solve reads no error flag (solve_ex), so it does not wait
        for the device."""
        xyz, e_t, e_f, e_r = self._xyz_t, self._e_t, self._e_f, self._e_r
        # spherical components -> Cartesian velocity
        v_cart = V[:, 0:1] * e_t + V[:, 1:2] * e_f + V[:, 2:3] * e_r
        w = self.nmass[:, None]
        L = torch.sum(w * torch.linalg.cross(xyz, v_cart), dim=0)
        # inertia tensor I = int (|r|^2 delta - r r^T) dV
        r2 = torch.sum(xyz * xyz, dim=1, keepdim=True)
        eye = torch.eye(3, dtype=V.dtype, device=V.device)
        inertia = torch.sum(w * r2) * eye - (xyz * w).T @ xyz
        omega = torch.linalg.solve_ex(inertia, L)[0]
        v_rot = torch.linalg.cross(omega.expand_as(xyz), xyz)
        v_new = v_cart - v_rot
        # back to spherical components
        return torch.stack([torch.sum(v_new * e_t, dim=1),
                            torch.sum(v_new * e_f, dim=1),
                            torch.sum(v_new * e_r, dim=1)], dim=1)

    # ------------------------------------------------------------------
    def _cfl_dt(self, V):
        vv = V[self.ien]
        uc = torch.einsum("eai,a->ei", vv, self.N_center[:, 0])
        fastest = self._max(torch.sum(uc.abs() / self.e_size, dim=1))
        # a true division (a Python number over a tensor multiplies by the
        # reciprocal)
        limit = torch.full_like(fastest, self.cfg.finetunedt * 0.5) / fastest
        return 1e-32 + torch.minimum(limit, self.adv_geo.diff_dt)

    def _advect_T(self, T0, Tdot0, V, dt0):
        """SUPG predictor-corrector (the regional advection.pg_timestep on
        this mesh's physical gradients) through the max-T guard
        (advection.advect_monitored: dt-halving retries when the interior
        maximum grows past T_maxvaried=1.05). Returns (T, Tdot, dt)."""
        cfg = self.cfg

        def advect(dt):
            return adv_mod.pg_timestep(
                self.adv_geo, self.ien, self.plan, T0, Tdot0, V, dt,
                diff=cfg.inputdiffusivity, Q0=cfg.Q0, gamma=cfg.adv_gamma,
                sub_iterations=cfg.adv_sub_iterations,
                tbc_mask=self.tbc_mask, tbc_val=self.tbc_val)

        return adv_mod.advect_monitored(advect, T0, dt0, self.tbc_mask,
                                        cfg.monitor_max_T,
                                        reduce_max=self._max)

    def _timestep(self, s: State, stokes=None):
        # stokes(T, V, P) -> (V, P, monitor) replaces the model's own solve
        # (CoupledRun's coarse_stokes)
        T, Tdot, dt = self._advect_T(s.T, s.Tdot, s.V, self._cfl_dt(s.V))
        V, P, mon = (stokes or self._stokes)(T, s.V, s.P)
        diag = StepDiagnostics(dt, mon.v_norm, mon.p_norm,
                               mon.incompressibility, mon.outer_iterations,
                               mon.inner_iterations)
        return State(T, Tdot, V, P, s.time + dt, dt, s.step + 1), diag

    # ------------------------------------------------------------------
    def initial_solve(self, s: State):
        V, P, mon = self._stokes(s.T, s.V, s.P)
        return dataclasses.replace(s, V=V, P=P), mon

    def stokes(self, T, V, P):
        """One full-sphere Stokes pass (the regional CitcomModel.stokes's
        entry name)."""
        return self._stokes(T, V, P)

    def step(self, s: State):
        return self._timestep(s)

    # -------- tracers (Full_tracer_advection.c capability) --------

    @property
    def tracer_field(self) -> ft.FullTracerField:
        """The tracers' location tables, built at first use."""
        if self._tracer_field is None:
            self._tracer_field = ft.FullTracerField.build(
                self.mesh, dtype=self.dtype, device=self.device)
        return self._tracer_field

    def step_tracers(self, s: State, pos, flavors):
        """Thermochemical full-sphere timestep: advect Cartesian tracers
        with the step's dt and form the ratio-method composition
        (Full_tracer_advection.c + Composition_related.c capability).

        pos (n, 3) Cartesian in the model's dtype and flavors (n,) on its
        device. Returns (state, diag, new_pos, C_nodes); C_nodes is the
        dense flavor's nodal fraction (float32, as the reference forms
        it) for compositional buoyancy."""
        tf = self.tracer_field
        # the tracers advect with the step's final (possibly halved) dt
        T, Tdot, dt = self._advect_T(s.T, s.Tdot, s.V, self._cfl_dt(s.V))
        pos = ft.advect_tracers(tf, s.V, pos, dt)
        comp_el, _ = ft.element_composition(tf, self.mesh, pos, flavors, 2)
        # composition -> nodes (volume-agnostic average, like the
        # regional composition_to_nodes)
        contrib = comp_el[1][:, None].expand(self.mesh.nel, 8)
        num = self.plan.scatter(contrib[:, :, None])[:, 0]
        C_nodes = num * self._inv_valence
        V, P, mon = self._stokes(T, s.V, s.P, C=C_nodes)
        diag = StepDiagnostics(dt, mon.v_norm, mon.p_norm,
                               mon.incompressibility, mon.outer_iterations,
                               mon.inner_iterations)
        new_s = State(T, Tdot, V, P, s.time + dt, dt, s.step + 1)
        return new_s, diag, pos, C_nodes


# ----------------------------------------------------------------------
# element sharding over torch.distributed ranks
# ----------------------------------------------------------------------


class _AllReducePlan:
    """A rank's ScatterPlan over its own elements, its partial nodal sums
    then summed over the ranks (one all-reduce): the nodal result is the
    whole mesh's, on every rank."""

    def __init__(self, plan: asm.ScatterPlan, group):
        self.plan = plan
        self.nno = plan.nno
        self._group = group

    def scatter(self, contrib):
        import torch.distributed as dist
        out = self.plan.scatter(contrib)
        dist.all_reduce(out, group=self._group)
        return out


class ElementShardedFullSphere(FullSphereModel):
    """A FullSphereModel whose elements are split over the ranks of one
    RankGrid axis (shard_full_sphere, shard_full_step).

    Rank r owns elements [r * per, (r + 1) * per) of the mesh's element
    list padded to a multiple of the world size with zero elements (node 0,
    zero tensors, unit volume: they add nothing and their pressure stays
    0), as the reference pads them. Replicated on every rank: every nodal
    field (T, Tdot, V, masks, lumped mass, the layer sums, net rotation)
    and the step's scalars. Sharded: every per-element tensor (ien, B,
    gda, cc, G, gradN, volume, materials, sizes, elt_k) and the Uzawa
    pressure inside a solve; the solve returns the whole P, all-gathered.

    Where the collectives sit (the ones the reference's pjit inserts):
      - every element-to-node scatter (K u, G p, forces, diag(K), the SUPG
        residual) is the rank's sorted segment sum, then one all-reduce;
      - pressure dots and norms: one all-reduce each of the rank's part;
      - velocity dots and norms (replicated vectors): each rank sums a
        contiguous range of nodes (ownership weights), one all-reduce;
      - the CFL rate and the max-T guard's interior maximum: one all-rank
        maximum each;
      - the solve's P: one all-gather at its end.
    So every host decision (CG, Uzawa, the max-T guard) reads a value that
    was all-reduced. Tracer steps are not sharded (step_tracers raises)."""

    def __init__(self, model: FullSphereModel, grid, axis: str = "e"):
        self.__dict__.update(model.__dict__)
        self._tracer_field = None
        self.grid, self.axis = grid, axis
        self._group = grid.group(axis)
        world, r = grid.size(axis), grid.index(axis)
        nel, nno = model.mesh.nel, model.mesh.nno
        per = -(-nel // world)
        self.n_pad = per * world - nel
        self._per, self._lo = per, r * per
        lo, hi = min(r * per, nel), min((r + 1) * per, nel)
        dev = model.device

        def part(x, fill=0):
            blk = x[lo:hi]
            if hi - lo == per:
                return blk.contiguous()
            pad = torch.full((per - (hi - lo),) + tuple(x.shape[1:]), fill,
                             dtype=x.dtype, device=x.device)
            return torch.cat([blk, pad])

        for name in ("ien", "B", "gda", "cc", "G", "gradN", "mat",
                     "e_size"):
            setattr(self, name, part(getattr(model, name)))
        self.e_area = part(model.e_area, fill=1.0)
        ien = np.asarray(model.mesh.ien)[lo:hi]
        ien = np.concatenate([ien, np.zeros((per - (hi - lo), 8), ien.dtype)])
        self.plan = _AllReducePlan(asm.ScatterPlan.build(ien, nno, dev),
                                   self._group)
        self.adv_geo = model.adv_geo._replace(
            gda=self.gda, gradN=self.gradN, e_size=self.e_size)
        # the rank's share of the nodes for the velocity reductions
        own = np.zeros(nno)
        own[r * nno // world:(r + 1) * nno // world] = 1.0
        self._own = torch.as_tensor(own, dtype=self.dtype, device=dev)

    def _psum(self, x):
        return psum_scalar(x, self.grid, self.axis)

    def _max(self, x):
        return pmax(x, self.grid, self.axis)

    def _problem(self, ops: asm.StokesOperators) -> sol.StokesProblem:
        w3 = self._own[:, None]
        vw = (self.nmass * self._own)[:, None]
        tv, area = self.total_volume, self.e_area
        return sol.local_problem(ops, self.nmass, area, tv)._replace(
            dot_v=lambda a, b: self._psum(torch.sum(a * b * w3)),
            dot_p=lambda a, b: self._psum(torch.dot(a, b)),
            v_norm2=lambda v: self._psum(torch.sum(v * v * vw)) / tv,
            p_norm2=lambda p: self._psum(torch.sum(p * p * area)) / tv,
            div_norm2=lambda p: self._psum(torch.sum(p * p / area)) / tv)

    def _stokes(self, T, V, P, C=None):
        import torch.distributed as dist
        full = torch.cat([P, P.new_zeros(self.n_pad)]) if self.n_pad else P
        P_loc = full[self._lo:self._lo + self._per]
        V, P_loc, mon = super()._stokes(T, V, P_loc, C)
        parts = [torch.empty_like(P_loc)
                 for _ in range(self.grid.size(self.axis))]
        dist.all_gather(parts, P_loc.contiguous(), group=self._group)
        return V, torch.cat(parts)[:self.mesh.nel], mon

    def step_tracers(self, s, pos, flavors):
        raise NotImplementedError(
            "the tracer step is not element-sharded; run step_tracers on "
            "the FullSphereModel")


def shard_full_sphere(model: FullSphereModel, grid, axis: str = "e"):
    """The full-sphere Stokes solve by ELEMENT sharding over the ranks of
    `grid`'s `axis` (ElementShardedFullSphere: elements padded to a
    multiple of the axis size with zero elements). Returns
    stokes(T, V, P) -> (V, P, UzawaMonitor), its inputs and outputs whole
    on every rank."""
    return ElementShardedFullSphere(model, grid, axis).stokes


def shard_full_step(model: FullSphereModel, grid, axis: str = "e"):
    """The full-sphere TIMESTEP (SUPG advection + Stokes) by element
    sharding. Requires nel % (axis size) == 0, as the reference does (pick
    nodex so 12 (nodex-1)^2 (nodez-1) divides it). Returns
    step(state) -> (state, StepDiagnostics), whole on every rank."""
    n = grid.size(axis)
    if model.mesh.nel % n:
        raise ValueError(f"nel {model.mesh.nel} not divisible by {n} ranks")
    return ElementShardedFullSphere(model, grid, axis).step
