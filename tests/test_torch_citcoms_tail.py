"""The rest of the port's regional CitcomS (g4s_tpu_torch/models/citcoms:
the colored Gauss-Seidel smoother, multigrid, tracers, phase changes,
TALA, anisotropic viscosity, lith_age, bc-file sequences, spherical
harmonics, the geoid, output, checkpoints and the CLI's restart) against
the reference (g4s_tpu/models/citcoms) on the CPU, both in f64, at the
9x9x5 mesh of the reference's own tests (tests/test_citcoms.py
small_cfg, Ra = 1e5, lid at 100; multigrid at levels = 2), inputs made
by numpy from a seed.

Tolerances, relative to the largest magnitude of the reference result:
the GS sweep and its block inverse 1e-12; the level transfers 1e-13;
solves and steps 1e-10 with equal iteration counts; tracer positions
1e-12 with equal element compositions; the spherical harmonics and the
geoid 1e-10; output files byte for byte; checkpoints bit for bit."""

import dataclasses
import gzip
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from g4s_tpu import ckpt as jckpt
from g4s_tpu.models.citcoms import CitcomModel as JModel
from g4s_tpu.models.citcoms import assembly as jasm
from g4s_tpu.models.citcoms import bc_files as jbcf
from g4s_tpu.models.citcoms import config as jconfig
from g4s_tpu.models.citcoms import multigrid as jmg
from g4s_tpu.models.citcoms import nodal as jnodal
from g4s_tpu.models.citcoms import observables as jobs
from g4s_tpu.models.citcoms import output as jout
from g4s_tpu.models.citcoms import phase_change as jphase
from g4s_tpu.models.citcoms import sphere_harmonics as jsph
from g4s_tpu.models.citcoms import tracers as jtr
from g4s_tpu.models.citcoms import vtk as jvtk
from g4s_tpu_torch import ckpt
from g4s_tpu_torch.drivers import citcoms_regional
from g4s_tpu_torch.models.citcoms import (CitcomModel, anisotropic,
                                          bc_files, multigrid, nodal,
                                          observables, output, phase_change,
                                          sphere_harmonics, state_from_numpy,
                                          tracers, vtk)
from g4s_tpu_torch.models.citcoms.driver import State
from test_citcoms import COOKBOOK2_SNIPPET, small_cfg

janiso = importlib.import_module("g4s_tpu.models.citcoms.anisotropic")

BASE = dict(rayleigh=1e5, topvbc=1, topvbxval=100.0, nodex=9, nodey=9,
            nodez=5)
MG = dict(solver_type="multigrid", levels=2)
PHASE = dict(Ra_410=2e4, clapeyron410=0.1, transT410=0.5, z_410=0.2,
             width410=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(**kw):
    return small_cfg(**dict(BASE, **kw))


def pair(**kw):
    cfg = cfg_of(**kw)
    return JModel(cfg), CitcomModel(dataclasses.replace(cfg), device="cpu")


def rel(got, want) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def t64(x):
    return torch.from_numpy(np.array(x, np.float64))


def j_state(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def check_step(ps, pd, js, jd, tol=1e-10):
    assert (pd.uzawa_iterations, pd.inner_iterations) == (
        int(jd.uzawa_iterations), int(jd.inner_iterations))
    for name in ("T", "Tdot", "V", "P", "dt", "time"):
        assert rel(getattr(ps, name), getattr(js, name)) <= tol, name
    assert ps.step == int(js.step)


@pytest.fixture(scope="module")
def base():
    """The base models and the reference's f64 state after its initial
    Stokes solve, with the port's copy of it."""
    jm, pm = pair()
    js, _ = jm.initial_solve(jm.init_state())
    return jm, pm, js, state_from_numpy(pm, j_state(js))


# ---------------------------------------------------------------- multigrid


@pytest.fixture(scope="module")
def mg_pair():
    cfg = cfg_of(**MG)
    return (jmg.MGHierarchy(cfg, levels=2),
            multigrid.MGHierarchy(dataclasses.replace(cfg), levels=2,
                                  device="cpu"))


def test_gauss_seidel_colored_matches(base):
    """Three sweeps of the 8-color smoother and the 3x3 block inverse at
    the initial viscosity, from a random u, against the reference's."""
    jm, pm, js, ps = base
    jo, po = jm._build_ops(js.T), pm._build_ops(ps.T)
    jW = jnodal.build_stencil(jo.elt_k, jm.stencil_plan)
    st = nodal.build_stencil(po.elt_k, pm.stencil_plan)
    grid = pm.stencil_plan.grid
    jD = jnodal.stencil_block_dinv(jW, jm.vbc_mask.reshape(*grid, 3))
    D = nodal.stencil_block_dinv(st, pm.vbc_mask)
    assert rel(D.reshape(*grid, 3, 3), jD) <= 1e-12
    rng = np.random.default_rng(11)
    F = rng.standard_normal((pm.mesh.nno, 3))
    u = rng.standard_normal((pm.mesh.nno, 3))
    want = jnodal.gauss_seidel_colored(jW, jD, jnp.asarray(F),
                                       jnp.asarray(u), jm.vbc_mask, 3)
    plan = nodal.GSPlan.build(pm.stencil_plan)
    assert all(i.dtype == torch.int32 for i in plan.nodes + plan.nbr)
    u_t = t64(u)
    colors = nodal.GSColors.build(st, D, pm.vbc_mask, plan)
    got = nodal.gauss_seidel_colored(colors, t64(F), u_t, 3)
    assert rel(got, want) <= 1e-12
    assert torch.equal(u_t, t64(u))            # the input is left alone


def test_level_transfers_match(mg_pair):
    jh, ph = mg_pair
    rng = np.random.default_rng(12)
    lv_j, lv_p = jh.levels[1], ph.levels[1]
    uc = rng.standard_normal((lv_p.mesh.nno, 3))
    rf = rng.standard_normal((ph.levels[0].mesh.nno, 3))
    assert rel(multigrid.interp_up(lv_p.interp, t64(uc)),
               jmg.interp_up(lv_j.interp, jnp.asarray(uc))) <= 1e-13
    assert rel(multigrid.project_down(lv_p.interp, t64(rf)),
               jmg.project_down(lv_j.interp, jnp.asarray(rf),
                                lv_j.mesh.nno)) <= 1e-13
    ids, w = multigrid._interp_maps(lv_p.cfg, ph.levels[0].cfg)
    np.testing.assert_array_equal(ids, np.asarray(lv_j.interp[0]))
    np.testing.assert_array_equal(w, np.asarray(lv_j.interp[1]))
    assert lv_p.interp.order.dtype == lv_p.interp.seg_ids.dtype == \
        torch.int32


@pytest.mark.parametrize("sweeps", [(2, 2), (1, 3)])
def test_mg_solve_matches(base, mg_pair, sweeps):
    """MGHierarchy.solve on a random stripped F to 1e-6 of ||F||, with
    (down, up) smoothing sweeps: the reference's u and cycle count, one
    host read per residual test."""
    jm, pm, js, ps = base
    jh, ph = mg_pair
    down, up = sweeps
    jops, pops = jh.build_ops(js.T), ph.build_ops(ps.T)
    F = np.asarray(jasm.strip_bcs(jnp.asarray(np.random.default_rng(
        5).standard_normal((pm.mesh.nno, 3))), jm.vbc_mask))
    acc = 1e-6 * float(np.linalg.norm(F))
    ju, jres, jit = jh.solve(jops, jnp.asarray(F), acc=acc, max_cycles=20,
                             down=down, up=up)
    from g4s_tpu_torch.models.citcoms import solvers
    solvers.HOST_SYNCS = 0
    u, res, it = ph.solve(pops, t64(F), acc=acc, max_cycles=20, down=down,
                          up=up)
    assert it == int(jit) and solvers.HOST_SYNCS == it - 1 + (it < 20)
    assert rel(u, ju) <= 1e-10 and rel(res, jres) <= 1e-10


def test_mg_hierarchy_defaults_to_the_card():
    """MGHierarchy, like the port's other entry points, runs on the card
    unless asked for the CPU: without a card its default raises."""
    if torch.cuda.is_available():
        assert multigrid.MGHierarchy(cfg_of(**MG)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multigrid.MGHierarchy(cfg_of(**MG), levels=2)


def test_mg_solve_runs_a_cycle_below_acc(base, mg_pair):
    """An F already below acc still gets one V-cycle (the reference
    returns u = 0 there, and its Uzawa step then divides by zero: a NaN
    initial solve at Cookbook2's 9x9x9, ROADMAP.md section 3)."""
    _, pm, _, ps = base
    _, ph = mg_pair
    F = torch.where(pm.vbc_mask, 0.0, t64(np.random.default_rng(6)
                                          .standard_normal((pm.mesh.nno,
                                                            3))))
    u, res, it = ph.solve(ph.build_ops(ps.T), F, acc=10 * float(F.norm()))
    assert it == 1 and bool(u.abs().max() > 0)
    assert float(res) < float(F.norm())


def test_multigrid_model_matches():
    """Solver=multigrid: the initial solve, then two steps from the
    reference's state after it, with the reference's Uzawa and V-cycle
    counts."""
    jm, pm = pair(**MG)
    js, jmon = jm.initial_solve(jm.init_state())
    ps, mon = pm.initial_solve(pm.init_state())
    assert (mon.outer_iterations, mon.inner_iterations) == (
        int(jmon.outer_iterations), int(jmon.inner_iterations))
    assert rel(ps.V, js.V) <= 1e-10 and rel(ps.P, js.P) <= 1e-10
    ps = state_from_numpy(pm, j_state(js))
    for _ in range(2):
        js, jd = jm.step(js)
        ps, d = pm.step(ps)
        check_step(ps, d, js, jd)


def test_multigrid_repairs_the_references_nan():
    """With Cookbook2's settings on a 9x9x9 mesh (levels 2) an inner solve
    gets a right side already below its tolerance: the reference returns
    u = 0 and its Uzawa step divides by zero, so its initial solve ends at
    piterations with vrms NaN; the port's first V-cycle always runs, and
    its solve converges (ROADMAP.md section 3)."""
    cfg = dataclasses.replace(
        jconfig.config_from_table(jconfig.parse_flat_config(
            COOKBOOK2_SNIPPET)),
        nodex=9, nodey=9, nodez=9, **MG)
    jm = JModel(cfg)
    pm = CitcomModel(dataclasses.replace(cfg), device="cpu")
    _, jmon = jm.initial_solve(jm.init_state())
    ps, mon = pm.initial_solve(pm.init_state())
    assert int(jmon.outer_iterations) == cfg.piterations
    assert np.isnan(float(jmon.v_norm))
    assert mon.outer_iterations < cfg.piterations
    assert torch.isfinite(ps.V).all() and float(mon.incompressibility) < 1e-3


# ---------------------------------------------------------------- tracers


def test_tracer_functions_match(base):
    jm, pm, js, ps = base
    jtf = jtr.TracerField.from_mesh(jm.mesh)
    tf = tracers.TracerField.from_mesh(pm.mesh)
    assert tuple(tf) == tuple(jtf)
    jpos, jfl = jtr.seed_tracers(jm.mesh, 6, seed=3)
    pos, fl = tracers.seed_tracers(pm.mesh, 6, seed=3)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(fl, jfl)
    P, J = t64(pos), jnp.asarray(pos)
    (jx, iy, kz), xi = tf.locate(P)
    (jjx, jiy, jkz), jxi = jtf.locate(J)
    for a, b in ((jx, jjx), (iy, jiy), (kz, jkz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert rel(xi, jxi) <= 1e-12
    assert rel(tf.clip(P * 1.3), jtf.clip(J * 1.3)) <= 1e-15
    assert rel(tracers.interp_velocity(tf, ps.V, P),
               jtr.interp_velocity(jtf, js.V, J)) <= 1e-12
    dt = 3e-4
    assert rel(tracers.advect_tracers(tf, ps.V, P, dt),
               jtr.advect_tracers(jtf, js.V, J, dt)) <= 1e-12
    comp, total = tracers.element_composition(tf, P, torch.from_numpy(fl))
    jcomp, jtotal = jtr.element_composition(jtf, J, jnp.asarray(jfl))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    C = tracers.composition_to_nodes(tf, comp[1], pm.plan, pm.ien)
    assert rel(C, jtr.composition_to_nodes(jtf, jcomp[1], jm.plan,
                                           jm.ien)) <= 1e-12


def test_step_tracers_matches(base):
    """Two thermochemical steps (ratio 2, dense layer below z_interface)
    from the reference's state: positions within 1e-12, element
    compositions equal, fields and counts as a step's."""
    kw = dict(tracer=True, chemical_buoyancy=True, buoyancy_ratio=2.0,
              z_interface=0.7)
    jm, pm = pair(**kw)
    _, _, js, _ = base
    ps = state_from_numpy(pm, j_state(js))
    pos, fl = tracers.seed_tracers(pm.mesh, 8, flavor_boundary_r=0.7)
    jp, jf = jnp.asarray(pos), jnp.asarray(fl)
    pp, pf = t64(pos), torch.from_numpy(fl)
    for _ in range(2):
        js, jd, jp = jm.step_tracers(js, jp, jf)
        ps, d, pp = pm.step_tracers(ps, pp, pf)
        check_step(ps, d, js, jd)
        assert rel(pp, jp) <= 1e-12
    tf = tracers.TracerField.from_mesh(pm.mesh)
    np.testing.assert_array_equal(
        tracers.element_composition(tf, pp, pf)[0].numpy(),
        np.asarray(jtr.element_composition(
            jtr.TracerField.from_mesh(jm.mesh), jp, jf)[0]))


# ------------------------------------------- phase changes, TALA, anisotropy


def test_phase_function_and_boundary(base):
    jm, pm, js, ps = base
    cfg = pm.cfg
    args = (0.1, 0.2, 0.5, 0.05)
    B = phase_change.phase_function(cfg, pm.r_nodes, ps.T, *args)
    jB = jphase.phase_function(cfg, jnp.asarray(jm.mesh.sx[:, 2]), js.T,
                               *args)
    assert rel(B, jB) <= 1e-12
    assert rel(phase_change.phase_boundary(cfg, B),
               jphase.phase_boundary(cfg, jB)) <= 1e-12


@pytest.mark.parametrize("mode,gamma", [("orthotropic", 0.0), ("ti", 0.3)])
def test_constitutive_matrices_match(mode, gamma):
    n = [0.3, -0.2, 0.9]
    if mode == "ti":
        got = anisotropic.constitutive_ti(0.4, gamma, n)
        want = janiso.constitutive_ti(0.4, gamma, jnp.asarray(n))
    else:
        got = anisotropic.constitutive_orthotropic(0.4, n)
        want = janiso.constitutive_orthotropic(0.4, jnp.asarray(n))
    assert rel(got, want) <= 1e-14
    assert rel(anisotropic.orth_delta(torch.tensor(n, dtype=torch.float64)),
               janiso.orth_delta(jnp.asarray(n))) <= 1e-14


def _ages(tmp_path):
    ages = np.where(np.arange(81) % 9 < 4, 300.0, 3000.0)
    path = tmp_path / "ages.txt"
    np.savetxt(path, ages)
    return str(path)


def _vel_files(tmp_path, nsf):
    for age, mag in ((1, 0.02), (2, 0.04)):     # cm/yr: ~40-80 nondim
        vb = np.zeros((nsf, 2))
        vb[:, 0] = mag
        vb[:, 1] = -0.5 * mag
        np.savetxt(tmp_path / f"vel{age}", vb)
        np.savetxt(tmp_path / f"temp{age}", np.full(nsf, 0.01 * age))
    return dict(start_age=1.5, vbcs_file=True,
                vel_bound_file=str(tmp_path / "vel"), tbcs_file=True,
                temp_bound_file=str(tmp_path / "temp"))


@pytest.mark.parametrize("case", ["phase", "tala", "tala_latent",
                                  "aniso_orthotropic", "aniso_ti",
                                  "lith_uniform", "lith_file", "bc_files"])
def test_branch_step_matches(base, tmp_path, case):
    """One step of each configuration branch from the reference's state
    after its initial solve (lith_age also from each model's own initial
    temperature), with the reference's counts: fields within 1e-10."""
    _, _, js0, _ = base
    kw = {"phase": PHASE,
          "tala": dict(disptn_number=0.5, surfaceT=0.1),
          "tala_latent": dict(PHASE, disptn_number=0.5, surfaceT=0.1),
          "aniso_orthotropic": dict(ANIVISC=True, ani_vis2_factor=0.5),
          "aniso_ti": dict(ANIVISC=True, ani_vis2_factor=0.5,
                           anivisc_mode="ti", anivisc_gamma=0.3),
          "lith_uniform": dict(lith_age=True, lith_age_depth=0.12),
          "lith_file": dict(lith_age=True, lith_age_depth=0.12,
                            lith_age_file=_ages(tmp_path)),
          "bc_files": _vel_files(tmp_path, 81)}[case]
    jm, pm = pair(**kw)
    if case.startswith("lith"):
        assert rel(pm.init_state().T, jm.init_state().T) <= 1e-14
        np.testing.assert_array_equal(pm.tbc_mask.numpy(),
                                      np.asarray(jm.tbc_mask))
        assert rel(pm.tbc_val, jm.tbc_val) <= 1e-14
        js = jm.init_state()
        js = dataclasses.replace(js, V=js0.V, P=js0.P)
    else:
        js = js0
    ps = state_from_numpy(pm, j_state(js))
    if case == "bc_files":
        assert bc_files.uses_bc_files(pm.cfg)
        jb = jbcf.step_bcs(jm, float(js.time))
        pb = bc_files.step_bcs(pm, float(ps.time))
        for a, b in zip(pb, jb):
            assert a.dtype == (torch.bool if a.dtype == torch.bool
                               else pm.dtype)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        js1, jd = jm.step_with_bcs(js, jb)
        ps1, d = pm.step_with_bcs(ps, pb)
    else:
        js1, jd = jm.step(js)
        ps1, d = pm.step(ps)
    check_step(ps1, d, js1, jd)
    if case in ("phase", "tala_latent"):
        assert rel(pm.buoyancy(ps.T), jm.buoyancy(js.T)) <= 1e-12
    if case.startswith("tala"):
        assert rel(pm._build_ops(ps.T).elt_c,
                   jm._build_ops(js.T).elt_c) <= 1e-12


def test_bc_file_readers_match(tmp_path):
    """The epoch readers, bracketing and scalings: the reference's values
    exactly, between two epoch files, on one, and below age 0 (file 0)."""
    cfg = cfg_of(**_vel_files(tmp_path, 81))
    np.savetxt(tmp_path / "vel0", np.full((81, 2), 0.03))
    np.savetxt(tmp_path / "temp0", np.full(81, 0.02))
    for age in (1.5, 1.0, -1.0):
        assert bc_files._bracket(age) == jbcf._bracket(age)
        np.testing.assert_array_equal(
            bc_files.read_velocity_boundary(cfg, None, age),
            jbcf.read_velocity_boundary(cfg, None, age))
        np.testing.assert_array_equal(
            bc_files.read_temperature_boundary(cfg, age),
            jbcf.read_temperature_boundary(cfg, age))
        assert bc_files.find_age_in_my(cfg, age * 1e-3) == \
            jbcf.find_age_in_my(cfg, age * 1e-3)
    assert bc_files.scalet(cfg) == jbcf.scalet(cfg)
    assert bc_files.scalev(cfg) == jbcf.scalev(cfg)


# ------------------------------------------- harmonics, topography, geoid


def test_sph_expand_and_eval_match():
    rng = np.random.default_rng(13)
    th = np.linspace(0.8, 1.5, 17)
    ph = np.linspace(0.0, 0.8, 13)
    f = rng.standard_normal((17, 13))
    cc, cs = sphere_harmonics.sph_expand(f, th, ph, 6)
    jc, jsn = jsph.sph_expand(f, th, ph, 6)
    assert rel(cc, jc) <= 1e-10 and rel(cs, jsn) <= 1e-10
    assert rel(sphere_harmonics.sph_eval(cc, cs, th, ph),
               jsph.sph_eval(jc, jsn, th, ph)) <= 1e-10


def test_topography_and_geoid_match(base):
    jm, pm, js, ps = base
    Tg = np.asarray(js.T).reshape(9, 9, 5).copy()
    Tg[2:5, 2:5, 1:4] = np.clip(Tg[2:5, 2:5, 1:4] + 0.1, 0, 1)
    js = dataclasses.replace(js, T=jnp.asarray(Tg.ravel()))
    ps = state_from_numpy(pm, j_state(js))
    jo, po = jm._build_ops(js.T), pm._build_ops(ps.T)
    assert rel(observables.dynamic_topography(pm, ps, po),
               jobs.dynamic_topography(jm, js, jo)) <= 1e-10
    g, jg = observables.geoid(pm, ps, po, lmax=6), jobs.geoid(jm, js, jo,
                                                               lmax=6)
    for key in ("from_buoyancy", "from_topo", "total"):
        for a, b in zip(g[key], jg[key]):
            assert rel(a, b) <= 1e-10, key


# ---------------------------------------------------------------- output


def _read(path):
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _out_models(base, tmp_path, fmt, **kw):
    """Both base models with datadirs of their own under tmp_path."""
    jm, pm, js, ps = base
    out = []
    for tag, m in (("ref", jm), ("port", pm)):
        cfg = dataclasses.replace(m.cfg, output_format=fmt,
                                  datadir=str(tmp_path / tag), **kw)
        clone = object.__new__(type(m))
        clone.__dict__.update(m.__dict__, cfg=cfg)
        out.append(clone)
    return out


@pytest.mark.parametrize("fmt", ["ascii", "ascii-gz", "vtk", "vtk-ascii"])
def test_output_files_are_the_references(base, tmp_path, fmt):
    """output() at steps 0 and 3 and every other writer, from one state:
    the port's files are the reference's, byte for byte (gzip's after
    decompression)."""
    _, _, js, ps = base
    kw = {"vtk_format": "ascii"} if fmt == "vtk-ascii" else {}
    jm, pm = _out_models(base, tmp_path, "vtk" if fmt == "vtk-ascii"
                         else fmt, **kw)
    files, jfiles = [], []
    for step in (0, 3):
        files += output.output(pm, ps, step)
        jfiles += jout.output(jm, js, step)
    if fmt.startswith("ascii"):
        po, jo = pm._build_ops(ps.T), jm._build_ops(js.T)
        rng = np.random.default_rng(14)
        pos = rng.uniform(0.8, 0.9, (40, 3))
        fl = rng.integers(0, 2, 40)
        files += (output.output_surf_botm(pm, ps, po, 3)
                  + [output.output_horiz_avg(pm, ps, 3),
                     output.output_pressure(pm, ps, 3),
                     output.output_tracer(pm, t64(pos),
                                          torch.from_numpy(fl), 3),
                     output.output_stress(pm, ps, po, 3)])
        jfiles += (jout.output_surf_botm(jm, js, jo, 3)
                   + [jout.output_horiz_avg(jm, js, 3),
                      jout.output_pressure(jm, js, 3),
                      jout.output_tracer(jm, jnp.asarray(pos),
                                         jnp.asarray(fl), 3),
                      jout.output_stress(jm, js, jo, 3)])
    else:
        files.append(vtk.output_vtu(pm, ps, str(tmp_path / "p.vtu")))
        jfiles.append(jvtk.output_vtu(jm, js, str(tmp_path / "j.vtu")))
        d, jd = vtk.read_vts_points(files[0]), jvtk.read_vts_points(
            jfiles[0])
        assert set(d) == set(jd) == {"temperature", "velocity", "viscosity",
                                     "coordinate"}
        for key in jd:
            np.testing.assert_array_equal(d[key], jd[key])
    assert len(files) == len(jfiles) > 2
    for a, b in zip(files, jfiles):
        assert _read(a) == _read(b), a
    snap = np.load(output.output_snapshot_npz(pm, ps, 3))
    jsnap = np.load(jout.output_snapshot_npz(jm, js, 3))
    for key in jsnap.files:
        np.testing.assert_array_equal(snap[key], jsnap[key])


def test_output_h5_is_the_references(base, tmp_path):
    h5py = pytest.importorskip("h5py")
    _, _, js, ps = base
    jm, pm = _out_models(base, tmp_path, "hdf5")
    (p,), (j,) = output.output(pm, ps, 2), jout.output(jm, js, 2)
    with h5py.File(p) as f, h5py.File(j) as g:
        assert dict(f.attrs) == dict(g.attrs)
        assert set(f) == set(g)
        for key in g:
            np.testing.assert_array_equal(f[key][:], g[key][:])


# ---------------------------------------------------------------- checkpoints


def test_checkpoints_cross_both_ways(base, tmp_path):
    jm, pm, js, ps = base
    ps = dataclasses.replace(ps, step=7)
    js = dataclasses.replace(js, step=jnp.asarray(7, jnp.int32))
    ckpt.save_citcoms(tmp_path / "port.chkpt", ps, pm.cfg)
    jckpt.save_citcoms(tmp_path / "ref.chkpt", js, jm.cfg)
    got, meta = ckpt.load_citcoms(tmp_path / "ref.chkpt", pm)
    jgot, jmeta = jckpt.load_citcoms(tmp_path / "port.chkpt", jm)
    assert meta == jmeta and meta["step"] == 7
    assert got.step == int(jgot.step) == 7
    for f in dataclasses.fields(State):
        if f.name == "step":
            continue
        a, b = getattr(got, f.name), np.asarray(getattr(jgot, f.name))
        assert a.dtype == torch.float64 and b.dtype == np.float64
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(
            js, f.name)))
    with np.load(tmp_path / "port.chkpt") as z, \
            np.load(tmp_path / "ref.chkpt") as y:
        assert z.files == y.files
        for key in y.files:
            assert z[key].dtype == y[key].dtype, key


# ---------------------------------------------------------------- CLI


def test_cli_output_checkpoints_and_restart(tmp_path, capsys):
    """The CLI on a 5x5x4 config, --device cpu: 4 steps write output every
    2 steps and checkpoints every 2; a restart from the step-2 checkpoint
    reaches the step-4 state bit for bit; a stop flag writes a checkpoint
    at the step it stops."""
    path = tmp_path / "small.cfg"
    path.write_text("rayleigh=100000 nodex=5 nodey=5 nodez=4\n"
                    "theta_max=1.5708 theta_min=0.7854 fi_max=0.7854\n"
                    "topvbc=1 topvbxval=100 num_mat=4\n"
                    f"datadir={tmp_path / 'out'} datafile=cb\n"
                    "storage_spacing=2 checkpoint_frequency=2\n")
    s, hist = citcoms_regional.main([str(path), "--device", "cpu",
                                     "--steps", "4"])
    out = capsys.readouterr().out
    assert "step 4:" in out and len(hist) == 4 and s.step == 4
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["cb.chkpt.0.2", "cb.chkpt.0.4", "cb.coord.0.0",
                     "cb.velo.0.0", "cb.velo.0.2", "cb.velo.0.4",
                     "cb.visc.0.0", "cb.visc.0.2", "cb.visc.0.4"]
    r, rhist = citcoms_regional.main([
        str(path), "--device", "cpu", "--steps", "2", "--restart",
        str(tmp_path / "out" / "cb.chkpt.0.2")])
    assert r.step == 4 and len(rhist) == 2
    for f in ("T", "Tdot", "V", "P", "time", "dt"):
        assert torch.equal(getattr(r, f), getattr(s, f)), f
    pm = CitcomModel(small_cfg(rayleigh=1e5, topvbc=1, topvbxval=100.0,
                               datadir=str(tmp_path / "stop")), device="cpu")
    calls = []
    st, h = pm.run(5, checkpoint=True,
                   stop_flag=lambda: calls.append(1) or len(calls) == 3)
    assert st.step == 3 and len(h) == 3
    got, meta = ckpt.load_citcoms(tmp_path / "stop" / "citcom.chkpt.0.3", pm)
    assert meta["step"] == 3 and torch.equal(got.T, st.T)
