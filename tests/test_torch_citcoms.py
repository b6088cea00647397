"""The port's CitcomS regional model (g4s_tpu_torch/models/citcoms) against
the reference (g4s_tpu/models/citcoms) on the CPU, at the 5x5x4 mesh of
tests/test_citcoms.py's small_cfg with Ra = 1e5 and a lid moving at 100,
and for two steps at Cookbook2's full 33x33x9 (cookbook2.cfg).

Tolerances, relative to the largest magnitude of the reference result:
host geometry (numpy in both packages) 1e-12; operators and solves in f64
1e-10, with equal iteration counts; two full f64 steps 1e-9 on T, V, P and
dt, with equal Uzawa and CG counts; the same two steps in f32 1e-4."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from g4s_tpu.models.citcoms import CitcomModel as JModel
from g4s_tpu.models.citcoms import advection as jadv
from g4s_tpu.models.citcoms import assembly as jasm
from g4s_tpu.models.citcoms import config as jconfig
from g4s_tpu.models.citcoms import nodal as jnodal
from g4s_tpu.models.citcoms import observables as jobs
from g4s_tpu.models.citcoms import solvers as jsol
from g4s_tpu.models.citcoms import viscosity as jvisc
from g4s_tpu_torch import engine
from g4s_tpu_torch.drivers import citcoms_regional
from g4s_tpu_torch.models.citcoms import (CitcomModel, advection, assembly,
                                          config, nodal, observables,
                                          solvers, state_from_numpy,
                                          viscosity)
from g4s_tpu_torch.ops import segment
from test_citcoms import COOKBOOK2_SNIPPET, small_cfg

COOKBOOK2_CFG = (Path(__file__).resolve().parents[1] / "g4s_tpu_torch"
                 / "models" / "citcoms" / "cookbook2.cfg")
LID = dict(rayleigh=1e5, topvbc=1, topvbxval=100.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def models(dtype="f64", **kw):
    """(reference, port) models of small_cfg(**LID, **kw), built once per
    module."""
    key = (dtype, repr(sorted(kw.items())))
    if key not in _MODELS:
        cfg = small_cfg(**dict(LID, **kw))
        _MODELS[key] = (
            JModel(cfg, dtype=jnp.float64 if dtype == "f64" else jnp.float32),
            CitcomModel(dataclasses.replace(cfg), device="cpu",
                        dtype=torch.float64 if dtype == "f64"
                        else torch.float32))
    return _MODELS[key]


def rel(got, want) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def t64(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def j_state(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


# ---------------------------------------------------------------- config


def test_cookbook2_cfg_parses_like_the_reference():
    """The shipped cookbook2.cfg resolves to the reference's parse of the
    snippet it was copied from, and its dump round-trips."""
    cfg = config.load_config(COOKBOOK2_CFG)
    ref = jconfig.config_from_table(jconfig.parse_flat_config(
        COOKBOOK2_SNIPPET))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.nodex, cfg.nodey, cfg.nodez, cfg.maxstep) == (33, 33, 9, 10)
    assert cfg.dump() == ref.dump()
    assert config.config_from_table(config.parse_flat_config(
        cfg.dump())) == cfg


@pytest.mark.parametrize("text", [
    "a=1  ; trailing\nb=2 # c=9\nb=3\n",
    "num_mat=3 visc0=1,2 viscE=0.5\nSolver=bicg precond=off\n",
    "num_perturbations=2 perturbl=1,2 perturbmag=0.1\nSDEPV=on\n",
])
def test_parse_matches_reference(text):
    assert config.parse_flat_config(text) == jconfig.parse_flat_config(text)
    assert dataclasses.asdict(config.config_from_table(
        config.parse_flat_config(text))) == dataclasses.asdict(
        jconfig.config_from_table(jconfig.parse_flat_config(text)))


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("kw", [
    {},
    dict(nodex=7, nodey=6, nodez=5, topvbc=0, botvbc=1, botvbxval=3.0,
         num_perturbations=1, perturbl=[1], perturbm=[1], perturblayer=[3],
         perturbmag=[0.05]),
])
def test_mesh_and_geometry_match(kw):
    jm, pm = models(**kw)
    for name in ("theta", "fi", "r", "sx", "e_center", "e_size", "vbc_val",
                 "tbc_val"):
        assert rel(getattr(pm.mesh, name), getattr(jm.mesh, name)) <= 1e-12
    for name in ("ien", "vbc_mask", "tbc_mask"):
        np.testing.assert_array_equal(getattr(pm.mesh, name),
                                      getattr(jm.mesh, name))
    for name in ("N", "gda", "B", "G", "cc", "volume", "rtf"):
        assert rel(getattr(pm.geo, name), getattr(jm.geo, name)) <= 1e-12
    for name in ("N", "gda", "B", "G", "tmass", "e_area"):
        assert rel(getattr(pm, name), getattr(jm, name)) <= 1e-12, name
    assert abs(pm.total_volume - jm.total_volume) <= 1e-14
    assert rel(pm.init_state().T, jm.init_state().T) <= 1e-12
    np.testing.assert_array_equal(pm.mat.numpy(), np.asarray(jm.mat))


# ---------------------------------------------------------------- operators


@pytest.fixture(scope="module")
def ops64():
    """Both packages' StokesOperators at the initial temperature, f64."""
    jm, pm = models()
    js = jm.init_state()
    ps = pm.init_state()
    return jm, pm, jm._build_ops(js.T), pm._build_ops(ps.T), js, ps


def test_stokes_operators_match(ops64):
    jm, pm, jo, po, js, ps = ops64
    assert rel(po.elt_k, jo.elt_k) <= 1e-10
    assert rel(po.BI, jo.BI) <= 1e-10
    assert rel(po.BPI, jo.BPI) <= 1e-10
    assert rel(pm.buoyancy(ps.T), jm.buoyancy(js.T)) <= 1e-10
    F = assembly.assemble_forces(po, pm.N, pm.gda, pm.gweight, pm.cc,
                                 pm.buoyancy(ps.T))
    jF = jasm.assemble_forces(jo, jm.N, jm.gda, jm.gweight, jm.cc,
                              jm.buoyancy(js.T))
    assert rel(F, jF) <= 1e-10
    beta = -0.5 / 1.2
    assert rel(assembly.build_elt_c(pm.cc, pm.e_area, beta),
               jasm.build_elt_c(jm.cc, jm.e_area, beta)) <= 1e-12


def test_matvecs_match(ops64):
    """The stencil and element-by-element K u, the gradient and the
    divergence, against the reference's."""
    jm, pm, jo, po, js, ps = ops64
    rng = np.random.default_rng(0)
    u = rng.standard_normal((pm.mesh.nno, 3))
    p = rng.standard_normal(pm.mesh.nel)
    st = nodal.build_stencil(po.elt_k, pm.stencil_plan)
    jW = jnodal.build_stencil(jo.elt_k, jm.stencil_plan)
    noy, nox, noz = pm.stencil_plan.grid
    W6 = st.W.reshape(-1, 3, 27, 3).permute(0, 2, 1, 3).reshape(
        noy, nox, noz, 27, 3, 3)
    assert rel(W6, jW) <= 1e-10
    want = jasm.assemble_del2_u(jo, jnp.asarray(u))
    assert rel(nodal.nodal_matvec(st, t64(u), pm.vbc_mask), want) <= 1e-10
    assert rel(nodal.nodal_matvec(st, t64(u), pm.vbc_mask),
               jnodal.nodal_matvec(jW, jnp.asarray(u), jm.vbc_mask)) <= 1e-10
    assert rel(assembly.assemble_del2_u(po, t64(u)), want) <= 1e-10
    assert rel(assembly.assemble_del2_u(po, t64(u), strip=False),
               jasm.assemble_del2_u(jo, jnp.asarray(u), strip=False)) <= 1e-10
    assert rel(assembly.assemble_grad_p(po, t64(p)),
               jasm.assemble_grad_p(jo, jnp.asarray(p))) <= 1e-10
    assert rel(assembly.assemble_div_u(po, t64(u)),
               jasm.assemble_div_u(jo, jnp.asarray(u))) <= 1e-10


def test_engine_picks_the_stencil(ops64):
    _, pm, _, po, _, _ = ops64
    st = nodal.build_stencil(po.elt_k, pm.stencil_plan)
    og = engine.build_operator({"stencil": {"W": st, "mask": pm.vbc_mask},
                                "eltk": {"ops": po}},
                               stats={"regular_grid": True})
    assert og.variant == "stencil"
    u = t64(np.random.default_rng(1).standard_normal((pm.mesh.nno, 3)))
    assert rel(engine.apply_operator(og, u),
               assembly.assemble_del2_u(po, u).numpy()) <= 1e-10


def _problems(jm, pm, jo, po):
    jprob = jsol.local_problem(jo, jm.nmass, jm.e_area, jm.total_volume)
    W = jnodal.build_stencil(jo.elt_k, jm.stencil_plan)
    jprob = jprob._replace(A=lambda u: jnodal.nodal_matvec(W, u,
                                                           jm.vbc_mask))
    pprob = solvers.local_problem(po, pm.nmass, pm.e_area, pm.total_volume)
    st = nodal.build_stencil(po.elt_k, pm.stencil_plan)
    pprob = pprob._replace(A=lambda u: nodal.nodal_matvec(st, u,
                                                          pm.vbc_mask))
    return jprob, pprob


@pytest.mark.parametrize("acc_scale,max_iter", [(1e-4, 250), (1e-12, 7)])
def test_conj_grad_matches(ops64, acc_scale, max_iter):
    """Converged, and cut at max_iter: the same iterate and count."""
    jm, pm, jo, po, js, ps = ops64
    jprob, pprob = _problems(jm, pm, jo, po)
    F = assembly.assemble_forces(po, pm.N, pm.gda, pm.gweight, pm.cc,
                                 pm.buoyancy(ps.T))
    jF = jnp.asarray(F.numpy())
    acc = acc_scale * float(torch.linalg.vector_norm(F))
    want = jsol.conj_grad(jprob, jF, acc, max_iter)
    got = solvers.conj_grad(pprob, F, torch.tensor(acc, dtype=F.dtype),
                            max_iter)
    assert got.iterations == int(want.iterations)
    assert (got.iterations == max_iter) == (max_iter == 7)
    assert rel(got.x, want.x) <= 1e-10
    assert rel(got.residual, want.residual) <= 1e-10


def test_uzawa_cg_matches_initial_solve(ops64):
    """The port's uzawa_cg from the initial state against the reference's
    initial Stokes solve, with equal outer and inner counts."""
    jm, pm, jo, po, js, ps = ops64
    _, pprob = _problems(jm, pm, jo, po)
    F = assembly.assemble_forces(po, pm.N, pm.gda, pm.gweight, pm.cc,
                                 pm.buoyancy(ps.T))
    fdotf = torch.linalg.vector_norm(F)
    V, P, mon = solvers.uzawa_cg(pprob, ps.V, ps.P, F, fdotf,
                                 pm.uzawa_params)
    jV, jP, jmon = jm.stokes(js.T, js.V, js.P)
    assert (mon.outer_iterations, mon.inner_iterations) == (
        int(jmon.outer_iterations), int(jmon.inner_iterations))
    assert rel(V, jV) <= 1e-10
    assert rel(P, jP) <= 1e-10
    for name in ("v_norm", "p_norm", "dvelocity", "dpressure",
                 "incompressibility"):
        assert rel(getattr(mon, name), getattr(jmon, name)) <= 1e-9, name


# ---------------------------------------------------------------- energy


@pytest.fixture(scope="module")
def solved64():
    """The reference's f64 state after its initial Stokes solve, and the
    port's copy of it."""
    jm, pm = models()
    js, _ = jm.initial_solve(jm.init_state())
    return jm, pm, js, state_from_numpy(pm, j_state(js))


def test_cfl_and_pg_timestep_match(solved64):
    jm, pm, js, ps = solved64
    cfg = pm.cfg
    dt = advection.cfl_timestep(pm.adv_geo, pm.ien, ps.V,
                                finetunedt=cfg.finetunedt)
    jdt = jadv.cfl_timestep(jm.adv_geo, jm.ien, js.V,
                            finetunedt=cfg.finetunedt)
    assert rel(dt, jdt) <= 1e-12
    kw = dict(diff=cfg.inputdiffusivity, Q0=cfg.Q0, gamma=cfg.adv_gamma,
              sub_iterations=cfg.adv_sub_iterations)
    T, Tdot = advection.pg_timestep(
        pm.adv_geo, pm.ien, pm.plan, ps.T, ps.Tdot, ps.V, dt,
        tbc_mask=pm.tbc_mask, tbc_val=pm.tbc_val, **kw)
    jT, jTdot = jadv.pg_timestep(
        jm.adv_geo, jm.ien, jm.plan, js.T, js.Tdot, js.V, jdt,
        tbc_mask=jm.tbc_mask, tbc_val=jm.tbc_val, **kw)
    assert rel(T, jT) <= 1e-10
    assert rel(Tdot, jTdot) <= 1e-10


@pytest.mark.parametrize("dt_scale,monitor", [(1.0, True), (200.0, True),
                                              (200.0, False)])
def test_advect_monitored_matches(solved64, dt_scale, monitor):
    """The max-T guard halves dt as often as the reference's (here at the
    CFL step too, and four times at 200 times it); without the guard dt is
    kept."""
    jm, pm, js, ps = solved64
    cfg = pm.cfg
    kw = dict(diff=cfg.inputdiffusivity, Q0=cfg.Q0, gamma=cfg.adv_gamma,
              sub_iterations=cfg.adv_sub_iterations)
    dt0 = dt_scale * advection.cfl_timestep(pm.adv_geo, pm.ien, ps.V,
                                            finetunedt=cfg.finetunedt)
    T, Tdot, dt = advection.advect_monitored(
        lambda d: advection.pg_timestep(
            pm.adv_geo, pm.ien, pm.plan, ps.T, ps.Tdot, ps.V, d,
            tbc_mask=pm.tbc_mask, tbc_val=pm.tbc_val, **kw),
        ps.T, dt0, pm.tbc_mask, monitor)
    jdt0 = jnp.asarray(dt0.item())
    jT, jTdot, jdt = jadv.advect_monitored(
        lambda d: jadv.pg_timestep(
            jm.adv_geo, jm.ien, jm.plan, js.T, js.Tdot, js.V, d,
            tbc_mask=jm.tbc_mask, tbc_val=jm.tbc_val, **kw),
        js.T, jdt0, jm.tbc_mask, monitor)
    assert rel(dt, jdt) <= 1e-12
    halvings = round(np.log2(float(dt0) / float(dt)))
    assert halvings == {(1.0, True): 2, (200.0, True): 4,
                        (200.0, False): 0}[dt_scale, monitor]
    assert rel(T, jT) <= 1e-10
    assert rel(Tdot, jTdot) <= 1e-10


def test_observables_match(solved64):
    jm, pm, js, ps = solved64
    for top in (True, False):
        q, nu = observables.surface_heat_flux(pm, ps.T, top=top)
        jq, jnu = jobs.surface_heat_flux(jm, js.T, top=top)
        assert rel(q, jq) <= 1e-12 and rel(nu, jnu) <= 1e-12
    assert rel(observables.rms_velocity(pm, ps.V),
               jobs.rms_velocity(jm, js.V)) <= 1e-12
    T = ps.T * 1.3 - 0.1
    jT = jnp.asarray(T.numpy())
    assert rel(observables.filter_temperature(T, pm.tbc_mask, pm.tbc_val),
               jobs.filter_temperature(jT, jm.tbc_mask, jm.tbc_val)) <= 1e-12
    assert rel(observables.max_interior_temperature(T, pm.tbc_mask),
               jobs.max_interior_temperature(jT, jm.tbc_mask)) <= 1e-12


@pytest.mark.parametrize("kw", [
    dict(rheol=3, viscE=[3.0], viscT=[0.5]),
    dict(rheol=0, viscE=[2.0]),
    dict(rheol=1, viscE=[1.5], viscT=[0.2]),
    dict(rheol=2, viscE=[1.0]),
    dict(rheol=4, viscE=[2.0], viscZ=[1.0], viscT=[0.3]),
    dict(SDEPV=True, sdepv_expt=[2.0], VMIN=True, visc_min=0.5, VMAX=True,
         visc_max=2.0),
    dict(PDEPV=True, pdepv_a=[0.05], pdepv_b=[1.0], pdepv_y=[5.0]),
    dict(PDEPV=True, pdepv_eff=False, pdepv_a=[0.05], pdepv_b=[1.0],
         pdepv_y=[5.0]),
    dict(TDEPV=False, CDEPV=True, cdepv_ff=[1.0, 10.0]),
])
def test_viscosity_laws_match(solved64, kw):
    jm, pm, js, ps = solved64
    cfg = dataclasses.replace(pm.cfg, **kw)
    jcfg = dataclasses.replace(jm.cfg, **kw)
    sr = viscosity.strain_rate_2inv(pm.B, pm.ien, ps.V)
    jsr = jvisc.strain_rate_2inv(jm.B, jm.ien, js.V)
    assert rel(sr, jsr) <= 1e-10
    assert rel(viscosity.strain_rate_2inv(pm.B, pm.ien, ps.V, sqrt=False),
               jvisc.strain_rate_2inv(jm.B, jm.ien, js.V, sqrt=False)) <= 1e-10
    C = torch.linspace(-0.2, 1.2, pm.mesh.nno, dtype=torch.float64)
    got = viscosity.viscosity_at_vpts(cfg, pm.mat, ps.T, pm.ien, pm.N,
                                      strain_rate_II=sr[:, None],
                                      C_nodes=C, r_nodes=pm.r_nodes)
    want = jvisc.viscosity_at_vpts(jcfg, jm.mat, js.T, jm.ien, jm.N,
                                   strain_rate_II=jsr[:, None],
                                   C_nodes=jnp.asarray(C.numpy()),
                                   r_nodes=jm.mesh.sx[:, 2])
    assert rel(got, want) <= 1e-12


# ---------------------------------------------------------------- steps


@pytest.mark.parametrize("dtype,tol", [("f64", 1e-9), ("f32", 1e-4)])
def test_two_steps_match(dtype, tol):
    """Both packages start from the reference's state after its initial
    solve (carried across by state_from_numpy) and take two full steps; in
    f64 with the reference's Uzawa and CG counts."""
    jm, pm = models(dtype)
    js, jmon = jm.initial_solve(jm.init_state())
    ps, mon = pm.initial_solve(pm.init_state())
    assert rel(ps.V, js.V) <= tol and rel(ps.P, js.P) <= tol
    ps = state_from_numpy(pm, j_state(js))
    assert ps.T.dtype == pm.dtype and ps.step == 0
    for k in range(2):
        js, jd = jm.step(js)
        ps, d = pm.step(ps)
        if dtype == "f64":
            assert (mon.outer_iterations, mon.inner_iterations) == (
                int(jmon.outer_iterations), int(jmon.inner_iterations))
            assert (d.uzawa_iterations, d.inner_iterations) == (
                int(jd.uzawa_iterations), int(jd.inner_iterations)), k
            assert rel(d.incompressibility, jd.incompressibility) <= 1e-6
        for name in ("T", "Tdot", "V", "P", "dt", "time"):
            assert rel(getattr(ps, name), getattr(js, name)) <= tol, (k, name)
        assert ps.step == int(js.step) == k + 1
        for name in ("v_norm", "p_norm"):
            assert rel(getattr(d, name), getattr(jd, name)) <= tol


def test_cookbook2_steps_match_from_the_reference_state():
    """At Cookbook2's full 33x33x9 nodes (cookbook2.cfg), from the
    reference's state after its initial solve, two steps keep to 1e-9 of
    the reference with its Uzawa and CG counts (8/248, then 9/307). The
    initial solves themselves are not compared: their inner CG amplifies a
    difference of one rounding about 2.7-fold per iteration, so the two
    packages' results part by about 1e-5 there, as the reference's own do
    under a 1e-15 change of T (tests/citcoms_rounding_spread.py)."""
    cfg = config.load_config(COOKBOOK2_CFG)
    jm = JModel(jconfig.config_from_table(jconfig.parse_flat_config(
        COOKBOOK2_SNIPPET)))
    pm = CitcomModel(cfg, device="cpu")
    js, _ = jm.initial_solve(jm.init_state())
    ps = state_from_numpy(pm, j_state(js))
    for k in range(2):
        js, jd = jm.step(js)
        ps, d = pm.step(ps)
        assert (d.uzawa_iterations, d.inner_iterations) == (
            int(jd.uzawa_iterations), int(jd.inner_iterations)) == (
            (8, 248), (9, 307))[k]
        for name in ("T", "V", "P", "dt"):
            assert rel(getattr(ps, name), getattr(js, name)) <= 1e-9, name


def test_sdepv_stokes_matches(solved64):
    """The SDEPV outer loop (strain-rate weakening, n = 2), started from
    the Newtonian solution: the reference's counts and fields in f64. (From
    the initial state, where the interior strain rate is 0, the viscosity
    contrast makes the solve's result move by 1e-5 under a 1e-15 change of
    T, in either package.)"""
    _, _, js0, _ = solved64
    jm, pm = models(SDEPV=True, sdepv_expt=[2.0], VMIN=True, visc_min=1e-3,
                    VMAX=True, visc_max=1e3)
    ps0 = state_from_numpy(pm, j_state(js0))
    jV, jP, jmon = jm.stokes(js0.T, js0.V, js0.P)
    solvers.HOST_SYNCS = 0
    V, P, mon = pm.stokes(ps0.T, ps0.V, ps0.P)
    assert solvers.HOST_SYNCS >= mon.inner_iterations + 2
    assert (mon.outer_iterations, mon.inner_iterations) == (
        int(jmon.outer_iterations), int(jmon.inner_iterations))
    assert rel(V, jV) <= 1e-9 and rel(P, jP) <= 1e-9


def test_bicgstab_stokes_matches():
    """Solver=bicgstab, its initial Stokes solve cut at six BiCGstab
    iterations: the reference's counts and fields in f64. (Run on, the
    two packages' iterates part near the 20th iteration, where the
    solve's residual stalls at its 1e-4 inner tolerance.)"""
    jm, pm = models(solver_type="bicgstab", piterations=6)
    js, jmon = jm.initial_solve(jm.init_state())
    ps, mon = pm.initial_solve(pm.init_state())
    assert (mon.outer_iterations, mon.inner_iterations) == (
        int(jmon.outer_iterations), int(jmon.inner_iterations))
    assert mon.outer_iterations == 6
    assert rel(ps.V, js.V) <= 1e-9 and rel(ps.P, js.P) <= 1e-9
    for name in ("dvelocity", "dpressure", "incompressibility"):
        assert rel(getattr(mon, name), getattr(jmon, name)) <= 1e-9


# ---------------------------------------------------------------- entry


@pytest.mark.parametrize("kw,match", [
    (dict(solver_type="multigrid"), "multigrid"),
    (dict(lith_age=True), "lith_age"),
    (dict(Ra_410=1.0), "phase changes"),
    (dict(disptn_number=0.5), "TALA"),
    (dict(ANIVISC=True, ani_vis2_factor=0.5), "anisotropic"),
    (dict(vbcs_file=True, vel_bound_file="vb"), "boundary-condition"),
])
def test_unported_branches_raise(kw, match):
    """The six configuration branches the port once refused now build a
    model that takes them (tests/test_torch_citcoms_tail.py holds each to
    the reference); only the df64 tier, which is not ported, raises."""
    from g4s_tpu_torch.models.citcoms import bc_files
    m = CitcomModel(small_cfg(**dict(LID, **kw)), device="cpu")
    taken = {"multigrid": m.mg is not None,
             "lith_age": not torch.equal(m.init_state().T,
                                         models()[1].init_state().T),
             "phase changes": not torch.equal(
                 m.buoyancy(m.init_state().T),
                 models()[1].buoyancy(m.init_state().T)),
             "TALA": m._build_ops(m.init_state().T).elt_c is not None,
             "anisotropic": not torch.equal(
                 m._build_ops(m.init_state().T).elt_k,
                 models()[1]._build_ops(m.init_state().T).elt_k),
             "boundary-condition": bc_files.uses_bc_files(m.cfg)}
    assert taken[match]
    with pytest.raises(NotImplementedError, match="df64"):
        CitcomModel(small_cfg(**dict(LID, **kw)), device="cpu",
                    df64_inner=True)


def test_unported_run_options_raise(tmp_path):
    """run()'s output, checkpoint and restart options and the
    thermochemical step, once refused, now run: output files and a
    checkpoint are written, and a restart from it resumes its state."""
    cfg = small_cfg(**dict(LID, datadir=str(tmp_path), storage_spacing=1,
                           checkpoint_frequency=1))
    pm = CitcomModel(cfg, device="cpu")
    s, hist = pm.run(1, write_output=True, checkpoint=True)
    assert s.step == 1 and len(hist) == 1
    assert (tmp_path / "citcom.velo.0.1").exists()
    r, rhist = pm.run(0, restart_from=str(tmp_path / "citcom.chkpt.0.1"))
    assert r.step == 1 and rhist == [] and torch.equal(r.T, s.T)
    from g4s_tpu_torch.models.citcoms import tracers
    pos, fl = tracers.seed_tracers(pm.mesh, 2)
    s2, d, pos2 = pm.step_tracers(s, t64(pos), torch.from_numpy(fl))
    assert s2.step == 2 and pos2.shape == pos.shape


def test_sum_plans_are_int32():
    """The model's three sorted-sum plans (the stencil build, ScatterPlan
    and the layer order) hold int32 ids and order, which the card's kernel
    reads as they are; on the CPU they sum bitwise as their int64 copies."""
    _, pm = models()
    nel, nno = pm.mesh.nel, pm.mesh.nno
    rng = np.random.default_rng(6)
    for ids, order, num, shape in (
            (pm.stencil_plan.seg_ids, pm.stencil_plan.order, nno * 27,
             (nel * 64, 9)),
            (pm.plan.seg_ids, pm.plan.order, nno, (nel * 8, 3)),
            (pm._layer_sorted, pm._layer_order, pm.cfg.nodez, (nno,))):
        assert ids.dtype == order.dtype == torch.int32
        data = torch.from_numpy(rng.standard_normal(shape))
        got = segment.sorted_segment_sum(data, ids, num, order=order)
        assert torch.equal(got, segment.sorted_segment_sum(
            data, ids.long(), num, order=order.long()))


def test_model_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CitcomModel(small_cfg(**LID))


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    """The CLI on a 5x5x4 config: the initial solve and two steps, with
    the same counts as the model's run()."""
    path = tmp_path / "small.cfg"
    path.write_text("rayleigh=100000 nodex=5 nodey=5 nodez=4\n"
                    "theta_max=1.5708 theta_min=0.7854 fi_max=0.7854\n"
                    "topvbc=1 topvbxval=100 num_mat=4\n"
                    f"datadir={tmp_path}\n")
    s, hist = citcoms_regional.main([str(path), "--device", "cpu",
                                     "--steps", "2"])
    out = capsys.readouterr().out
    assert "step 2:" in out and "s/step" in out and s.step == 2
    _, pm = models()
    assert [(d.uzawa_iterations, d.inner_iterations) for d in hist] == [
        (d.uzawa_iterations, d.inner_iterations) for d in pm.run(2)[1]]
    # the CLI writes output and checkpoints as the reference's does; a
    # restart from a file that is not there fails
    assert (tmp_path / "citcom.velo.0.0").exists()
    with pytest.raises(FileNotFoundError):
        citcoms_regional.main([str(path), "--device", "cpu",
                               "--restart", str(tmp_path / "ck")])
