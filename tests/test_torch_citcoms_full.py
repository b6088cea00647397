"""The port's CitcomS full sphere (g4s_tpu_torch/models/citcoms: the 12-cap
mesh, the general geometry, FullSphereModel with its net-rotation removal
and tracers, the coupled Exchanger step, the netCDF-3 and gridded-input
readers and the mineral physics) against the reference
(g4s_tpu/models/citcoms) on the CPU, both in f64, at 5x5x4 nodes per cap
(576 elements; Ra = 1e5, radius_inner 0.55, free-slip top and bottom, the
temperature blob of tests/test_citcoms.py's full-sphere step), inputs made
by numpy from a seed.

Free slip leaves the three rigid rotations in the Stokes operator's
nullspace, and the Uzawa/CG iterates then amplify rounding: from T times
(1 + 1e-15 e) the reference's own initial solve moves V by up to 1.9e-4
and P by 2.9e-4, with 29-30 Uzawa and 516-523 CG iterations, and at a
fixed 3 x 60 iterations by about 1e-7 (tests/citcoms_full_rounding_spread.py).
So the solves, steps, the tracer step and the coupled step are held to
1e-10 with equal counts at a fixed cap of 1 Uzawa x 20 CG iterations
(accuracy 0), before rounding has grown; run to tolerance, the initial
solve and a step are held to about 3x the reference's own spread.

Tolerances, relative to the largest magnitude of the reference result:
mesh arrays, tracer location, compositions and gridded input exactly; the
general geometry and the interpolation weights 1e-13; the buoyancy, the
operators and K u across all 12 cap frames 1e-12; the net-rotation
removal 1e-12; solves, steps and the coupled step at the fixed cap 1e-10
with equal iteration counts; run to tolerance, V and P 1e-3, T 1e-4,
Uzawa counts within 1 and CG counts within 2 %; tracer positions 1e-13;
the mineral physics 1e-14; output files byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from g4s_tpu.models.citcoms import CitcomConfig as JCfg
from g4s_tpu.models.citcoms import CitcomModel as JModel
from g4s_tpu.models.citcoms import assembly as jasm
from g4s_tpu.models.citcoms import exchanger as jex
from g4s_tpu.models.citcoms import full_driver as jfd
from g4s_tpu.models.citcoms import full_mesh as jfm
from g4s_tpu.models.citcoms import full_tracers as jft
from g4s_tpu.models.citcoms import ggrd as jggrd
from g4s_tpu.models.citcoms import mineral_physics as jmp
from g4s_tpu.models.citcoms import netcdf3 as jnc
from g4s_tpu.models.citcoms import shapes as jshapes
from g4s_tpu.models.citcoms import vtk as jvtk
from g4s_tpu_torch.models.citcoms import (CitcomConfig, CitcomModel,
                                          CoupledRun, FullSphereModel,
                                          assembly, full_mesh, full_tracers,
                                          ggrd, mineral_physics, netcdf3,
                                          shapes, state_from_numpy, vtk)

FULL = dict(nodex=5, nodey=5, nodez=4, radius_inner=0.55, radius_outer=1.0,
            rayleigh=1e5, num_mat=1)
FIXED = dict(accuracy=0.0, piterations=1, vlowstep=20)
REGION = dict(nodex=5, nodey=5, nodez=4, theta_min=0.7854, theta_max=1.5708,
              fi_min=0.0, fi_max=0.7854, radius_inner=0.55, radius_outer=1.0,
              num_mat=4, rayleigh=1e4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def check_state(ps, js, tol=1e-10, names=("T", "Tdot", "V", "P", "dt",
                                          "time")):
    for name in names:
        assert rel(getattr(ps, name), getattr(js, name)) <= tol, name
    assert ps.step == int(js.step)


def counts(d):
    return int(d.uzawa_iterations), int(d.inner_iterations)


def blob_pair(**kw):
    """The reference's and the port's 5x5x4-per-cap full sphere, and the
    blob state of tests/test_citcoms.py's full-sphere step."""
    jm = jfd.FullSphereModel(JCfg(**FULL, **kw))
    pm = FullSphereModel(CitcomConfig(**FULL, **kw), device="cpu")
    T0 = np.asarray(jm.init_state().T)
    blob = np.exp(-np.sum((jm._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                          axis=1) / 0.05)
    js0 = dataclasses.replace(jm.init_state(),
                              T=jnp.asarray(np.clip(T0 + 0.3 * blob, 0, 1)))
    return jm, pm, js0


@pytest.fixture(scope="module")
def models():
    """The pair with every solver loop at the fixed cap."""
    return blob_pair(**FIXED)


@pytest.fixture(scope="module")
def solved(models):
    """The initial solve and two steps on each side, each from its own
    previous state."""
    jm, pm, js0 = models
    ps0 = state_from_numpy(pm, j_state(js0))
    js, jmon = jm.initial_solve(js0)
    ps, pmon = pm.initial_solve(ps0)
    runs = [(js, ps, (jmon.outer_iterations, jmon.inner_iterations),
             (pmon.outer_iterations, pmon.inner_iterations))]
    for _ in range(2):
        js, jd = jm.step(js)
        ps, pd = pm.step(ps)
        runs.append((js, ps, jd, pd))
    return runs


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("size", [(5, 5, 4), (9, 9, 5)])
def test_full_mesh_matches(size):
    jmesh = jfm.build_full_sphere_mesh(*size, 0.55, 1.0)
    pmesh = full_mesh.build_full_sphere_mesh(*size, 0.55, 1.0)
    for name in jmesh._fields:
        a, b = getattr(pmesh, name), getattr(jmesh, name)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    # a closed surface: 12 (n-1)^2 + 2 surface nodes
    assert pmesh.nno == (12 * (size[0] - 1) ** 2 + 2) * size[2]


def test_geometry_general_matches():
    mesh = full_mesh.build_full_sphere_mesh(5, 5, 4, 0.55, 1.0)
    pg = shapes.build_geometry_general(mesh.sx, mesh.ien)
    jg = jshapes.build_geometry_general(mesh.sx, mesh.ien)
    for f in dataclasses.fields(jg):
        assert rel(getattr(pg, f.name), getattr(jg, f.name)) <= 1e-13, \
            f.name
    analytic = 4 * np.pi / 3 * (1.0 - 0.55 ** 3)
    assert abs(pg.volume.sum() - analytic) / analytic < 1e-2


def test_buoyancy_operators_and_ku_match(models):
    """The layer-averaged buoyancy (with and without composition), the
    element stiffness, both preconditioners, the forces and K u on a random
    field, over the elements of all 12 caps."""
    jm, pm, js0 = models
    T = np.asarray(js0.T)
    C = np.random.default_rng(3).uniform(0.0, 1.0, pm.mesh.nno)
    assert rel(pm.buoyancy(t64(T)), jm.buoyancy(js0.T)) <= 1e-12
    assert rel(pm.buoyancy(t64(T), t64(C)),
               jm.buoyancy(js0.T, jnp.asarray(C))) <= 1e-12
    jo, po = jm._build_ops(js0.T), pm._build_ops(t64(T))
    for name in ("elt_k", "BI", "BPI"):
        assert rel(getattr(po, name), getattr(jo, name)) <= 1e-12, name
    u = np.random.default_rng(4).standard_normal((pm.mesh.nno, 3))
    assert rel(assembly.assemble_del2_u(po, t64(u), strip=False),
               jasm.assemble_del2_u(jo, jnp.asarray(u), strip=False)) \
        <= 1e-12
    F = assembly.assemble_forces(po, pm.N, pm.gda, pm.gweight, pm.cc,
                                 pm.buoyancy(t64(T)))
    jF = jasm.assemble_forces(jo, jm.N, jm.gda, jm.gweight, jm.cc,
                              jm.buoyancy(js0.T))
    assert rel(F, jF) <= 1e-12
    assert pm.plan.order.dtype == pm._layer_order.dtype == torch.int32


def test_initial_solve_and_two_steps_match(solved):
    """At the fixed cap: 1 Uzawa iteration, 2 CG solves of 20."""
    for i, (js, ps, jd, pd) in enumerate(solved):
        jc = jd if i == 0 else counts(jd)
        pc = pd if i == 0 else counts(pd)
        assert tuple(map(int, jc)) == tuple(pc) == (1, 40), i
        check_state(ps, js, names=("T", "Tdot", "V", "P", "dt", "time")
                    if i else ("V", "P"))
    assert solved[-1][1].step == 2 and float(solved[-1][1].time) > 0


def test_solve_and_step_to_tolerance_within_the_rounding_spread():
    """Run to the solver's tolerance, the initial solve and one step land
    within about 3x what a 1e-15 change of T moves the reference's own
    (module docstring); the flow is incompressible and carries no net
    rotation."""
    jm, pm, js0 = blob_pair()
    js, jmon = jm.initial_solve(js0)
    ps, pmon = pm.initial_solve(state_from_numpy(pm, j_state(js0)))
    js1, jd = jm.step(js)
    ps1, pd = pm.step(ps)
    for (pu, pc), (ju, jc) in (((pmon.outer_iterations,
                                 pmon.inner_iterations),
                                (jmon.outer_iterations,
                                 jmon.inner_iterations)),
                               (counts(pd), counts(jd))):
        assert abs(pu - int(ju)) <= 1 and abs(pc - int(jc)) <= 0.02 * int(jc)
    for p_, j_ in ((ps, js), (ps1, js1)):
        assert rel(p_.V, j_.V) <= 1e-3 and rel(p_.P, j_.P) <= 1e-3
    assert rel(ps1.T, js1.T) <= 1e-4 and rel(ps1.dt, js1.dt) <= 1e-3
    assert float(pmon.incompressibility) < 1e-3
    assert rel(pm.remove_net_rotation(ps1.V), ps1.V) <= 1e-10


def test_remove_net_rotation_matches(models, solved):
    """On the step's V and on a random field plus a rigid rotation: the
    reference's projection, and no angular momentum left."""
    jm, pm, _ = models
    rng = np.random.default_rng(5)
    xyz = pm._xyz
    V = rng.standard_normal((pm.mesh.nno, 3))
    rot = np.cross(np.broadcast_to([0.2, -0.4, 0.9], xyz.shape), xyz)
    V += np.stack([np.einsum("ni,ni->n", pm._e_t.numpy(), rot),
                   np.einsum("ni,ni->n", pm._e_f.numpy(), rot),
                   np.einsum("ni,ni->n", pm._e_r.numpy(), rot)], 1)
    got = pm.remove_net_rotation(t64(V))
    assert rel(got, jm.remove_net_rotation(jnp.asarray(V))) <= 1e-12
    v_cart = (got[:, 0:1] * pm._e_t + got[:, 1:2] * pm._e_f
              + got[:, 2:3] * pm._e_r)
    L = torch.sum(pm.nmass[:, None] * torch.linalg.cross(pm._xyz_t, v_cart),
                  dim=0)
    assert float(L.abs().max()) <= 1e-12 * float(got.abs().max())


# --------------------------------------------------------------- tracers


@pytest.fixture(scope="module")
def tracer_fields(models):
    jm, pm, _ = models
    return jft.FullTracerField.build(jm.mesh), pm.tracer_field


def test_tracer_location_and_weights_match(models, tracer_fields):
    """Seeded tracers and the element centers: cap and cell exactly, the
    interpolation stencil's node ids exactly and its weights within 1e-13,
    the velocity and one advection step within 1e-13; each center lies in
    its own element."""
    jm, pm, _ = models
    jtf, ptf = tracer_fields
    pos, fl = full_tracers.seed_tracers(pm.mesh, 3, seed=1)
    jpos, jfl = jft.seed_tracers(jm.mesh, 3, seed=1)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(fl, jfl)
    centers = pm._xyz[pm.mesh.ien].mean(axis=1)
    pts = np.concatenate([pos, centers])
    got = full_tracers.locate(ptf, t64(pts))
    want = jft.locate(jtf, jnp.asarray(pts))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert rel(got[4], want[4]) <= 1e-13 and rel(got[5], want[5]) <= 1e-13
    cap, iy, ix, kz = (x.numpy()[len(pos):] for x in got[:4])
    el = ((cap * 4 + iy) * 4 + ix) * 3 + kz
    np.testing.assert_array_equal(el, np.arange(pm.mesh.nel))
    ids, w = full_tracers.interp_weights(ptf, t64(pts))
    jids, jw = jft.interp_weights(jtf, jnp.asarray(pts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert rel(w, jw) <= 1e-13
    V = np.random.default_rng(6).standard_normal((pm.mesh.nno, 3))
    assert rel(full_tracers.interp_velocity(ptf, t64(V), t64(pos)),
               jft.interp_velocity(jtf, jnp.asarray(V), jnp.asarray(pos))) \
        <= 1e-13
    assert rel(full_tracers.advect_tracers(ptf, t64(V), t64(pos), 0.01),
               jft.advect_tracers(jtf, jnp.asarray(V), jnp.asarray(pos),
                                  0.01)) <= 1e-13
    comp, total = full_tracers.element_composition(ptf, pm.mesh, t64(pos),
                                                   torch.from_numpy(fl))
    jcomp, jtotal = jft.element_composition(jtf, jm.mesh, jnp.asarray(pos),
                                            jnp.asarray(fl))
    assert comp.dtype == total.dtype == torch.float32
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))


def test_step_tracers_matches(models, solved):
    """One thermochemical step (buoyancy ratio 1, 4 tracers per element)
    from the solved state: equal element and nodal compositions, positions
    within 1e-13, the state within 1e-10 with equal counts."""
    jm, pm, _ = models
    js, ps = solved[0][0], solved[0][1]
    pos, fl = full_tracers.seed_tracers(pm.mesh, 4, seed=0)
    js1, jd, jpos, jC = jm.step_tracers(js, jnp.asarray(pos),
                                        jnp.asarray(fl))
    ps1, pd, ppos, pC = pm.step_tracers(ps, t64(pos), torch.from_numpy(fl))
    assert counts(pd) == counts(jd)
    assert rel(ppos, jpos) <= 1e-13
    assert pC.dtype == torch.float32
    np.testing.assert_array_equal(pC.numpy(), np.asarray(jC))
    assert 0.0 < float(pC.max()) <= 1.0 and float(pC.min()) >= 0.0
    check_state(ps1, js1)


# -------------------------------------------------------------- exchanger


@pytest.fixture(scope="module")
def coupled_models(models):
    jm, pm, js0 = models
    return (jm, JModel(JCfg(**REGION, **FIXED)), pm,
            CitcomModel(CitcomConfig(**REGION, **FIXED), device="cpu"), js0)


@pytest.mark.parametrize("two_way", [False, True])
def test_coupled_run_matches(coupled_models, two_way):
    """One coupled step (coarse full sphere around a regional box) from
    the blob state: both models' states within 1e-10 with equal counts;
    the fine boundary T is the coarse interpolation; two-way writes the
    fine T into the coarse interior."""
    jc, jf, pc, pf, js0 = coupled_models
    jrun = jex.CoupledRun(jc, jf, two_way=two_way)
    prun = CoupledRun(pc, pf, two_way=two_way, device="cpu")
    np.testing.assert_array_equal(prun.b_nodes, jrun.b_nodes)
    np.testing.assert_array_equal(prun.b_ids.numpy(), np.asarray(jrun.b_ids))
    assert rel(prun.b_w, jrun.b_w) <= 1e-13
    np.testing.assert_array_equal(prun.interior_ids.numpy(),
                                  np.asarray(jrun.interior_ids))
    assert prun.interior_ids.numel() > 0
    jsf0 = jf.init_state()
    jsc, jsf, (jdc, jdf) = jrun.step(js0, jsf0)
    psc, psf, (pdc, pdf) = prun.step(state_from_numpy(pc, j_state(js0)),
                                     state_from_numpy(pf, j_state(jsf0)))
    assert counts(pdc) == counts(jdc) and counts(pdf) == counts(jdf)
    check_state(psc, jsc)
    check_state(psf, jsf)
    if two_way:
        inside = prun.interior_ids
        want = prun.restrict(torch.zeros_like(psc.T), psf.T)[inside]
        assert torch.equal(psc.T[inside], want)
    else:
        tbc_val, vbc_val = prun.exchange(psc.T, psc.V)
        jtbc, jvbc = jrun._exchange(jsc.T, jsc.V)
        assert rel(tbc_val, jtbc) <= 1e-10 and rel(vbc_val, jvbc) <= 1e-10
        b = prun.b_nodes
        assert float((psf.T[b] - tbc_val[b]).abs().max()) <= 1e-10


def test_entry_points_default_to_the_card(coupled_models):
    """FullSphereModel and CoupledRun, like the port's other entry points,
    run on the card unless asked for the CPU: without a card their
    defaults raise."""
    _, _, pc, pf, _ = coupled_models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FullSphereModel(CitcomConfig(**FULL))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CoupledRun(pc, pf)


# ------------------------------------------------ gridded input, physics


def _write_grd(path, lon, lat, z, *, depth=None):
    """A classic netCDF grid written by scipy: COARDS lon/lat/z, or
    lon/lat/depth/field."""
    import warnings
    from scipy.io import netcdf_file
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = netcdf_file(str(path), "w")
        f.createDimension("lon", lon.size)
        f.createDimension("lat", lat.size)
        f.createVariable("lon", "d", ("lon",))[:] = lon
        f.createVariable("lat", "d", ("lat",))[:] = lat
        if depth is None:
            f.createVariable("z", "f", ("lat", "lon"))[:] = z
        else:
            f.createDimension("depth", depth.size)
            f.createVariable("depth", "d", ("depth",))[:] = depth
            f.createVariable("field", "d", ("depth", "lat", "lon"))[:] = z
        f.close()


@pytest.fixture(scope="module")
def regional():
    return (JModel(JCfg(**dict(REGION, nodez=9))),
            CitcomModel(CitcomConfig(**dict(REGION, nodez=9)), device="cpu"))


def test_netcdf3_and_ggrd_match(regional, tmp_path):
    """netcdf3.read_netcdf3/read_grd on grids scipy writes, and ggrd's
    interpolation and temperature init from them and from the .npz layout:
    equal to the reference's arrays bit for bit."""
    jm, pm = regional
    rng = np.random.default_rng(7)
    lon = np.linspace(-20, 80, 21)
    lat = np.linspace(-30, 70, 17)
    depth = np.linspace(0, 1, 5)
    field = rng.standard_normal((depth.size, lat.size, lon.size))
    paths = []
    for k in range(depth.size):
        paths.append(tmp_path / f"layer{k}.grd")
        _write_grd(paths[-1], lon, lat, field[k].astype(np.float32))
    _write_grd(tmp_path / "cube.grd", lon, lat, field, depth=depth)
    np.savez(tmp_path / "cube.npz", lon=lon, lat=lat, depth=depth,
             field=field)
    for p in paths[:2] + [tmp_path / "cube.grd"]:
        dims, var = netcdf3.read_netcdf3(p)
        jdims, jvar = jnc.read_netcdf3(p)
        assert dims == jdims and list(var) == list(jvar)
        for name in var:
            np.testing.assert_array_equal(var[name][0], jvar[name][0])
    for a, b in zip(netcdf3.read_grd(paths[0]), jnc.read_grd(paths[0])):
        np.testing.assert_array_equal(a, b)
    grids = {"layers": ggrd.load_grd_layers(paths, depth),
             "cube": ggrd.load_grid(tmp_path / "cube.grd"),
             "npz": ggrd.load_grid(str(tmp_path / "cube.npz"))}
    jgrids = {"layers": jggrd.load_grd_layers(paths, depth),
              "cube": jggrd.load_grid(tmp_path / "cube.grd"),
              "npz": jggrd.load_grid(str(tmp_path / "cube.npz"))}
    for key, g in grids.items():
        for a, b in zip(g, jgrids[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
        np.testing.assert_array_equal(
            ggrd.interpolate_to_mesh(pm.mesh, *g, scale=0.1, offset=0.2),
            jggrd.interpolate_to_mesh(jm.mesh, *jgrids[key], scale=0.1,
                                      offset=0.2))
    for p in (tmp_path / "cube.grd", str(tmp_path / "cube.npz")):
        T = ggrd.ggrd_temp_init(pm, p, scale=0.05)
        np.testing.assert_array_equal(T, jggrd.ggrd_temp_init(jm, p,
                                                              scale=0.05))
        assert 0.0 <= T.min() and T.max() <= 1.0
    with pytest.raises(FileNotFoundError):
        ggrd.load_grid(tmp_path / "missing.grd")


def test_mineral_physics_matches(regional):
    """get_prem across every PREM layer and below the CMB, and the TVV
    seismic model of a perturbed temperature with and without a
    composition (tensors in, host arrays out)."""
    jm, pm = regional
    r = np.linspace(0.3, 1.0, 301)
    for a, b in zip(mineral_physics.get_prem(r), jmp.get_prem(r)):
        assert rel(a, b) <= 1e-14
    rng = np.random.default_rng(8)
    T = np.clip(np.asarray(jm.init_state().T)
                + 0.1 * rng.standard_normal(pm.mesh.nno), 0.0, 1.0)
    C = rng.uniform(0.0, 1.0, pm.mesh.nno)
    for c in (None, C):
        got = mineral_physics.seismic_model(
            pm, t64(T), None if c is None else t64(c))
        want = jmp.seismic_model(jm, T, c)
        for a, b in zip(got, want):
            assert isinstance(a, np.ndarray) and rel(a, b) <= 1e-14


def test_output_vtu_byte_equal(models, solved, tmp_path):
    """output_vtu of the port's full sphere writes the reference's bytes
    for the same solved state, binary and ascii."""
    jm, pm, _ = models
    js = solved[1][0]
    ps = state_from_numpy(pm, j_state(js))
    for fmt in ("binary", "ascii"):
        a = vtk.output_vtu(pm, ps, str(tmp_path / f"p_{fmt}.vtu"), fmt=fmt)
        b = jvtk.output_vtu(jm, js, str(tmp_path / f"j_{fmt}.vtu"), fmt=fmt)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), fmt
    d = vtk.read_vts_points(str(tmp_path / "p_binary.vtu"))
    assert d["temperature"].shape == (pm.mesh.nno,)
