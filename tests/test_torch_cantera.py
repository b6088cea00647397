"""The port's Cantera NonIdealShockTube path (g4s_tpu_torch/models/cantera,
g4s_tpu_torch/ops/odeint.py, g4s_tpu_torch/drivers/shock_tube.py) against
the reference (g4s_tpu/models/cantera, g4s_tpu/ops/odeint.py) on the CPU,
in f64 on both sides.

Inputs: tests/test_cantera.py's inline PLOG/Chebyshev and Peng-Robinson
mechanisms (copied here), and a small instance of chip_smoke.py's
synthetic n-dodecane-shaped mechanism (15 species, 30 reactions, 2 falloff,
2 three-body, both the Redlich-Kwong and the ideal-gas phase), which
stands in for nDodecane_Reitz.yaml (not in the repository). States are
drawn from seeded numpy generators.

Tolerances: mechanism fields equal; thermo 1e-13; the RK/PR cubic and
departures 1e-12; kf, Kc, rop and wdot 1e-12 relative (wdot and the
rates of progress to their largest entry); the BDF's y 1e-9 relative with
steps, n_fev and n_jev within 2 % of the reference's; the reactors' RHS and
Jacobians 1e-11 of their largest entry; ignition delays 1e-6 relative.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import _synthetic_mechanism_yaml  # noqa: E402
from g4s_tpu.models import cantera as J  # noqa: E402
from g4s_tpu.models.cantera import kinetics as j_kin  # noqa: E402
from g4s_tpu.models.cantera import network as j_net  # noqa: E402
from g4s_tpu.models.cantera import thermo as j_th  # noqa: E402
from g4s_tpu.ops import odeint as j_ode  # noqa: E402
from g4s_tpu_torch.drivers import shock_tube as cli  # noqa: E402
from g4s_tpu_torch.models import cantera as P  # noqa: E402
from g4s_tpu_torch.models.cantera import kinetics as p_kin  # noqa: E402
from g4s_tpu_torch.models.cantera import network as p_net  # noqa: E402
from g4s_tpu_torch.models.cantera import thermo as p_th  # noqa: E402
from g4s_tpu_torch.ops import odeint as p_ode  # noqa: E402

F64 = torch.float64
CPU = torch.device("cpu")
SMALL = {"nspec": 15, "nrxn": 30, "n_falloff": 2, "n_three_body": 2,
         "seed": 0}

_PLOG_CHEB_YAML = """
units: {length: cm, quantity: mol, activation-energy: cal/mol}
phases:
- {name: gas, thermo: ideal-gas, species: [A, B], kinetics: gas}
species:
- name: A
  composition: {H: 1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[2.5, 0., 0., 0., 0., 0., 0.], [2.5, 0., 0., 0., 0., 0., 0.]]}
- name: B
  composition: {H: 1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[2.5, 0., 0., 0., 0., 0., 0.], [2.5, 0., 0., 0., 0., 0., 0.]]}
reactions:
- equation: A => B
  type: pressure-dependent-Arrhenius
  rate-constants:
  - {P: 0.01 atm, A: 1.0e+10, b: 0.0, Ea: 0.0}
  - {P: 1.0 atm, A: 1.0e+12, b: 0.5, Ea: 1000.0}
  - {P: 100.0 atm, A: 1.0e+14, b: 1.0, Ea: 2000.0}
- equation: B => A
  type: Chebyshev
  temperature-range: [300.0, 2000.0]
  pressure-range: [0.01 atm, 100.0 atm]
  data: [[8.0, 0.5, -0.1], [0.5, 0.1, 0.05]]
"""

_PR_YAML = """
units: {length: cm, quantity: mol, activation-energy: cal/mol}
phases:
- {name: co2gas, thermo: Peng-Robinson, species: [CO2], kinetics: gas}
species:
- name: CO2
  composition: {C: 1, O: 2}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[2.35677352, 8.98459677e-03, -7.12356269e-06, 2.45919022e-09,
                   -1.43699548e-13, -4.83719697e+04, 9.90105222],
                  [3.85746029, 4.41437026e-03, -2.21481404e-06, 5.23490188e-10,
                   -4.72084164e-14, -4.8759166e+04, 2.27163806]]}
  equation-of-state:
    {model: Peng-Robinson, a: 3.958134e+11, b: 26.6644, acentric-factor: 0.228}
reactions: []
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cantera")
    out = {"plog_cheb": d / "plog_cheb.yaml", "pr": d / "pr.yaml",
           "small": d / "small.yaml"}
    out["plog_cheb"].write_text(_PLOG_CHEB_YAML)
    out["pr"].write_text(_PR_YAML)
    _synthetic_mechanism_yaml(str(out["small"]), **SMALL)
    return {k: str(v) for k, v in out.items()}


MECHS = {"plog_cheb": ("plog_cheb", None), "pr": ("pr", None),
         "small_rk": ("small", "nDodecane_RK"),
         "small_ig": ("small", "nDodecane_IG")}


@pytest.fixture(scope="module")
def mechs(files):
    return {k: (J.load_mechanism(files[f], ph), P.load_mechanism(files[f], ph))
            for k, (f, ph) in MECHS.items()}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      np.float64)


def _rel(a, b):
    """Largest difference relative to b's largest magnitude."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _elementwise(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())


def _fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


def _assert_same_fields(jm, pm):
    jf, pf = _fields(jm), _fields(pm)
    assert jf.keys() == pf.keys()
    for k, v in jf.items():
        w = pf[k]
        if isinstance(v, np.ndarray) or isinstance(w, np.ndarray):
            assert np.asarray(v).dtype == np.asarray(w).dtype, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


@pytest.mark.parametrize("key", list(MECHS))
def test_mechanism_fields_equal_and_carry_across(mechs, key):
    jm, pm = mechs[key]
    _assert_same_fields(jm, pm)
    carried = P.mechanism_from_reference(_fields(jm))
    _assert_same_fields(carried, pm)
    with pytest.raises(KeyError):
        P.mechanism_from_reference({**_fields(jm), "bogus": 1})


def test_synthetic_mechanism_holds_the_reference_checks(files):
    """The reference's own checks of the dodecane mechanism
    (tests/test_cantera.py:39-60) on the generator's small instance: the
    counts asked for, every element balanced in every reaction, n-dodecane's
    RK a and b from its critical constants, NASA7 continuous at Tmid."""
    m = P.load_mechanism(files["small"], "nDodecane_RK")
    assert (m.nspec, m.nrxn) == (SMALL["nspec"], SMALL["nrxn"])
    assert m.is_falloff.sum() == 2 and m.has_troe.sum() == 2
    assert m.is_three_body.sum() == 2
    assert np.abs((m.nu_prod - m.nu_reac) @ m.mol_weights).max() < 1e-10
    for el in ("C", "H", "O", "N"):
        n_el = np.array([c.get(el, 0.0) for c in m.compositions])
        assert np.abs((m.nu_prod - m.nu_reac) @ n_el).max() == 0.0
    i = m.species_index("c12h26")
    tc = (m.rk_a[i, 0] * 0.08664 / (0.42748 * P.R_GAS * m.rk_b[i])) \
        ** (2.0 / 3.0)
    assert 600.0 < tc < 700.0
    assert (m.rk_b > 0).all()
    for fn in (p_th.cp0_R, p_th.h0_RT, p_th.s0_R):
        lo = _np(fn(m, _t(1000.0 - 1e-7)))
        hi = _np(fn(m, _t(1000.0 + 1e-7)))
        assert np.abs(lo - hi).max() < 1e-6
    T = np.linspace(300.0, 3500.0, 65)
    cp = np.stack([_np(p_th.cp0_R(m, _t(t))) for t in T])
    assert cp.min() >= 2.5 - 1e-9 and cp.max() <= 60.0


@pytest.mark.parametrize("key", ["small_rk", "pr"])
def test_thermo_matches(mechs, key):
    jm, pm = mechs[key]
    for T in (400.0, 999.5, 1000.0, 1000.5, 2500.0):
        for name in ("cp0_R", "h0_RT", "s0_R", "u0_RT"):
            want = getattr(j_th, name)(jm, jnp.asarray(T))
            got = getattr(p_th, name)(pm, _t(T))
            assert _elementwise(got, want) <= 1e-13, (name, T)


def test_cubic_and_departures_match(mechs):
    rng = np.random.default_rng(3)
    for key, pre in (("small_rk", "rk"), ("pr", "pr")):
        jm, pm = mechs[key]
        x = rng.uniform(0.1, 1.0, jm.nspec)
        x /= x.sum()
        jvol = jax.jit(lambda T, P_, x: getattr(j_th, f"{pre}_molar_volume")(
            jm, T, P_, x))
        jdep = jax.jit(lambda T, v, x: getattr(j_th, f"{pre}_departures")(
            jm, T, v, x))
        for T, P_ in ((1000.0, 40 * 101325.0), (350.0, 100e5)):
            jv = jvol(jnp.asarray(T), jnp.asarray(P_), jnp.asarray(x))
            pv = getattr(p_th, f"{pre}_molar_volume")(pm, _t(T), _t(P_),
                                                      _t(x))
            assert _elementwise(pv, jv) <= 1e-12, (key, T)
            v = float(jv)
            jp = getattr(j_th, f"{pre}_pressure")(jm, jnp.asarray(T), v,
                                                  jnp.asarray(x))
            pp = getattr(p_th, f"{pre}_pressure")(pm, _t(T), _t(v), _t(x))
            assert _elementwise(pp, jp) <= 1e-12
            jd = jdep(jnp.asarray(T), jnp.asarray(v), jnp.asarray(x))
            pd = getattr(p_th, f"{pre}_departures")(pm, _t(T), _t(v), _t(x))
            for a, b in zip(pd, jd):
                assert _elementwise(a, b) <= 1e-12, (key, T)
        conc = rng.uniform(1.0, 50.0, jm.nspec)
        jg, pg = j_th.GasState(jm, real_gas=True), \
            p_th.GasState(pm, real_gas=True)
        for name in ("pressure", "cv_mole", "partial_molar_int_energy"):
            want = getattr(jg, name)(jnp.asarray(1200.0), jnp.asarray(conc))
            got = getattr(pg, name)(_t(1200.0), _t(conc))
            assert _rel(got, want) <= 1e-12, (key, name)


def _states(m, seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for T in (800.0, 1250.0, 2100.0)[:n]:
        conc = np.abs(rng.normal(5.0, 2.0, m.nspec))
        conc[rng.integers(0, m.nspec)] = 0.0      # a species at zero
        out.append((T, conc))
    return out


@pytest.mark.parametrize("key", ["small_rk", "small_ig", "plog_cheb"])
def test_kinetics_matches(mechs, key):
    jm, pm = mechs[key]
    jk, pk = j_kin.build_kinetics(jm), p_kin.build_kinetics(pm, device=CPU)
    assert pk.g_net.variant == jk.g_net.variant
    states = _states(jm, 11)
    if key == "plog_cheb":
        # pressures across the PLOG table and past both of its ends
        states = [(800.0, np.full(2, P_ * 101325.0 / (P.R_GAS * 800.0) / 2))
                  for P_ in (0.001, 0.01, 0.1, 1.0, 100.0, 1000.0)]
    for T, conc in states:
        jT, jc, pT, pc = jnp.asarray(T), jnp.asarray(conc), _t(T), _t(conc)
        kf = p_kin.forward_rate_constants(pk, pm, pT, pc)
        assert _elementwise(
            kf, j_kin.forward_rate_constants(jk, jm, jT, jc)) <= 1e-12
        kc = p_kin.equilibrium_constants(pk, pm, pT)
        assert _elementwise(kc, j_kin.equilibrium_constants(jk, jm, jT)) \
            <= 1e-12
        rf, rr = p_kin.rates_of_progress(pk, pm, pT, pc)
        jf, jr = j_kin.rates_of_progress(jk, jm, jT, jc)
        assert _rel(rf, jf) <= 1e-12 and _rel(rr, jr) <= 1e-12
        wdot = p_kin.net_production_rates(pk, pm, pT, pc)
        assert _rel(wdot, j_kin.net_production_rates(jk, jm, jT, jc)) \
            <= 1e-12


def _counts_close(p, j):
    for name in ("steps", "n_fev", "n_jev"):
        a, b = int(getattr(p, name)), int(getattr(j, name))
        assert abs(a - b) <= 0.02 * b, (name, a, b)


def test_bdf_linear_decay_and_recording():
    jr = j_ode.bdf_solve(lambda t, y: -y, jnp.asarray([1.0]), 0.0, 2.0,
                         rtol=1e-10, atol=1e-12)
    pr = p_ode.bdf_solve(lambda t, y: -y, _t([1.0]), 0.0, 2.0, rtol=1e-10,
                         atol=1e-12)
    assert _elementwise(pr.y, jr.y) <= 1e-9 and pr.success
    _counts_close(pr, jr)
    assert pr.host_reads >= pr.steps
    kw = dict(rtol=1e-8, atol=1e-10, record_size=256)
    jr = j_ode.bdf_solve(lambda t, y: -y, jnp.asarray([1.0]), 0.0, 1.0,
                         record_fn=lambda y: y[0], **kw)
    pr = p_ode.bdf_solve(lambda t, y: -y, _t([1.0]), 0.0, 1.0,
                         record_fn=lambda y: y[0], **kw)
    _counts_close(pr, jr)
    rec, rec_t = _np(pr.record), _np(pr.record_t)
    assert rec.shape == (256, 1) and rec_t.shape == (256,)
    written = rec[:, 0] > 0
    assert written.sum() > 5
    np.testing.assert_allclose(rec[written, 0], np.exp(-rec_t[written]),
                               rtol=1e-5)
    assert (rec_t[~written] == 0.0).all()      # unwritten slots keep t0
    assert _rel(rec, np.asarray(jr.record)) <= 1e-8
    assert _rel(rec_t, np.asarray(jr.record_t)) <= 1e-8
    # a buffer shorter than the run keeps overwriting its last slot
    short = p_ode.bdf_solve(lambda t, y: -y, _t([1.0]), 0.0, 1.0,
                            record_fn=lambda y: y[0], rtol=1e-8, atol=1e-10,
                            record_size=4)
    assert float(short.record_t[-1]) == 1.0
    assert abs(float(short.record[-1, 0]) - np.exp(-1.0)) < 1e-7
    # the banded Newton path (a band of one diagonal here)
    jr = j_ode.bdf_solve(lambda t, y: -y, jnp.asarray([1.0]), 0.0, 1.0,
                         rtol=1e-8, atol=1e-10, bandwidth=(0, 0))
    pr = p_ode.bdf_solve(lambda t, y: -y, _t([1.0]), 0.0, 1.0, rtol=1e-8,
                         atol=1e-10, bandwidth=(0, 0))
    assert _elementwise(pr.y, jr.y) <= 1e-9 and pr.success
    _counts_close(pr, jr)


def test_bdf_robertson_matches():
    def rober(stack):
        def f(t, y):
            return stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                          0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                          3e7 * y[1] ** 2])
        return f
    jr = j_ode.bdf_solve(rober(jnp.stack), jnp.asarray([1.0, 0.0, 0.0]),
                         0.0, 1e4, rtol=1e-8, atol=1e-12)
    pr = p_ode.bdf_solve(rober(torch.stack), _t([1.0, 0.0, 0.0]), 0.0, 1e4,
                         rtol=1e-8, atol=1e-12)
    assert pr.success and bool(jr.success)
    assert _elementwise(pr.y[[0, 2]], np.asarray(jr.y)[[0, 2]]) <= 1e-9
    assert _rel(pr.y, jr.y) <= 1e-9
    _counts_close(pr, jr)


@pytest.mark.parametrize("key", ["small_rk", "small_ig", "pr"])
def test_cv_reactor_rhs_and_jacobian_match(mechs, key):
    jm, pm = mechs[key]
    real = key != "small_ig"
    jr = J.IdealGasConstVolumeReactor(jm, real_gas=real)
    pr = P.IdealGasConstVolumeReactor(pm, real_gas=real, device=CPU)
    assert pr.real_gas == jr.real_gas == real
    if key == "pr":
        T_, P_, X = 350.0, 100e5, np.ones(1)
    else:
        T_, P_, X = 1000.0, 40 * 101325.0, P.stoich_mixture(pm)
    y0 = pr.initial_state(T_, P_, X)
    assert _elementwise(y0, jr.initial_state(T_, P_, X)) <= 1e-13
    rng = np.random.default_rng(5)
    ys = [_np(y0)]
    y_mid = _np(y0) * rng.uniform(0.5, 1.5, y0.shape[0])
    y_mid[0] = 1650.0
    ys.append(y_mid)
    jac_p = torch.func.jacfwd(pr.rhs, argnums=1)
    jac_j = jax.jit(jax.jacfwd(jr.rhs, argnums=1))
    for y in ys:
        assert _rel(pr.rhs(0.0, _t(y)), jax.jit(jr.rhs)(0.0, jnp.asarray(y))) \
            <= 1e-11
        assert _rel(jac_p(0.0, _t(y)), jac_j(0.0, jnp.asarray(y))) <= 1e-11


def test_jacobian_after_a_first_rhs_call_matches(files):
    """A reactor whose first use is its RHS, then its jacfwd Jacobian. The
    RHS takes dU/dT and dU/dc by torch.func.grad, and the mechanism's
    tensors are cached at first use: they must be made outside that
    transform (a tensor made inside one is wrapped at its level, and the
    cached wrapper escaped into the Jacobian, which then failed an
    internal assert, or, on the card, ran other kernels after other
    histories). The Jacobian is the reference's within 1e-11 and equal bit
    for bit to that of a reactor whose first use is the Jacobian."""
    from torch._C._functorch import is_functorch_wrapped_tensor

    def fresh():
        return P.IdealGasConstVolumeReactor(
            P.load_mechanism(files["small"], "nDodecane_RK"), real_gas=True,
            device=CPU)

    staged = fresh()
    y = staged.initial_state(1000.0, 40 * 101325.0,
                             P.stoich_mixture(staged.mech))
    pr = fresh()
    pr.rhs(0.0, y)
    assert not any(is_functorch_wrapped_tensor(t)
                   for t in pr.mech._tensor_cache.values())
    jac = torch.func.jacfwd(pr.rhs, argnums=1)(0.0, y)
    assert torch.equal(jac, torch.func.jacfwd(fresh().rhs, argnums=1)(0.0, y))
    jr = J.IdealGasConstVolumeReactor(
        J.load_mechanism(files["small"], "nDodecane_RK"), real_gas=True)
    assert _rel(jac, jax.jit(jax.jacfwd(jr.rhs, argnums=1))(
        0.0, jnp.asarray(_np(y)))) <= 1e-11


def test_cp_reactor_rhs_matches(mechs):
    jm, pm = mechs["small_ig"]
    jr = J.IdealGasConstPressureReactor(jm)
    pr = P.IdealGasConstPressureReactor(pm, device=CPU)
    X = P.stoich_mixture(pm)
    y0 = pr.initial_state(1000.0, 40 * 101325.0, X)
    assert _elementwise(y0, jr.initial_state(1000.0, 40 * 101325.0, X)) == 0
    y = _np(y0) + np.random.default_rng(2).uniform(0.0, 0.01, y0.shape[0])
    y[0] = 1400.0
    assert _rel(pr.rhs(0.0, _t(y)), jr.rhs(0.0, jnp.asarray(y))) <= 1e-11


def test_shock_tube_ignition_delay_matches(files):
    """run_single on the small mechanism: each phase's tau (the recorded
    time of peak OH) within 1e-6 of the reference's, the step counts within
    2 %; the two phases' taus differ."""
    jb = J.ShockTubeBenchmark(files["small"])
    pb = P.ShockTubeBenchmark(files["small"], device=CPU)
    kw = dict(rtol=1e-8, atol=1e-14)
    jo = jb.run_single(1000.0, **kw)
    po = pb.run_single(1000.0, **kw)
    for ph in ("RG", "IG"):
        assert abs(po[f"tau_{ph}"] - jo[f"tau_{ph}"]) \
            <= 1e-6 * jo[f"tau_{ph}"], ph
        res = po[f"result_{ph}"]
        assert res.success and 0.0 < po[f"tau_{ph}"] < 0.005
    assert po["tau_RG"] != po["tau_IG"]
    # ignition_delay alone, as the reference's run_single calls it
    X = P.stoich_mixture(pb.mech_ig)
    tau, res = P.ignition_delay(pb.r_ig, 1000.0, 40 * 101325.0, X, **kw)
    jtau, jres = J.ignition_delay(jb.r_ig, 1000.0, 40 * 101325.0, X, **kw)
    assert abs(tau - jtau) <= 1e-6 * jtau
    _counts_close(res, jres)
    # the lockstep batched sweep's lane at the same case: the same tau (the
    # steps before the OH peak do not depend on t_end)
    bo = pb.run_ntc_sweep_batched([1000.0], t_end=0.0046, **kw)
    for ph in ("RG", "IG"):
        assert abs(bo[f"tau_{ph}"][0] - po[f"tau_{ph}"]) \
            <= 1e-6 * po[f"tau_{ph}"], ph


def _net_pair(jm, pm, states, **kw):
    jkw = {k: [getattr(j_net, type(o).__name__)(*dataclasses.astuple(o))
               for o in v] for k, v in kw.items()}
    return (j_net.ReactorNet(jm, states, **jkw),
            p_net.ReactorNet(pm, states, device=CPU, **kw))


def _bath(pm):
    X = np.zeros(pm.nspec)
    X[pm.species_index("n2")] = 1.0       # inert in the synthetic mechanism
    return X


NETS = ["conducting_wall", "piston_wall", "valve_fill", "mass_flow"]


@pytest.mark.parametrize("case", NETS)
def test_reactor_net_matches(mechs, case):
    """tests/test_cantera.py:670-748's set-ups on the small mechanism, with
    its inert n2 as the bath gas: the network's RHS (at y0, at a seeded
    state and at the port's final state) and its Jacobian (at y0 and the
    seeded state) within 1e-12 and 1e-11 of the reference's, and the
    set-up's own physics on the port's integration (the BDF's
    parity is held above; the reference's compile of each network's
    while_loop would take most of this file's time)."""
    jm, pm = mechs["small_ig"]
    X = _bath(pm)
    if case == "conducting_wall":
        jn, pn = _net_pair(jm, pm, [(1000.0, 101325.0, X),
                                    (300.0, 101325.0, X)],
                           walls=[p_net.Wall(0, 1, A=1.0, U=50.0)])
        t_end = 2.0
    elif case == "piston_wall":
        jn, pn = _net_pair(jm, pm, [(500.0, 2 * 101325.0, X),
                                    (500.0, 101325.0, X)],
                           walls=[p_net.Wall(0, 1, A=1.0, K=1e-4)])
        t_end = 5.0
    elif case == "valve_fill":
        jn, pn = _net_pair(jm, pm, [(300.0, 101325.0, X)],
                           reservoirs=[p_net.Reservoir(400.0, 5 * 101325.0,
                                                       X)],
                           flows=[p_net.Valve(-1, 0, Kv=3e-6)])
        t_end = 20.0
    else:
        jn, pn = _net_pair(jm, pm, [(300.0, 101325.0, X)],
                           reservoirs=[p_net.Reservoir(300.0, 101325.0, X)],
                           flows=[p_net.MassFlowController(-1, 0,
                                                           mdot=0.01)])
        t_end = 10.0
    po = pn.advance(t_end)
    assert po.success
    jac_p = torch.func.jacfwd(pn.rhs, argnums=1)
    rhs_j = jax.jit(jn.rhs)
    jac_j = jax.jit(jax.jacfwd(jn.rhs, argnums=1))
    # the Jacobian at y0 and at a seeded state with every species present
    # (the integrated state holds denormal concentrations, which XLA on
    # the CPU flushes to zero and torch keeps)
    rng = np.random.default_rng(len(case))
    y_mid = _np(pn.y0) * rng.uniform(0.8, 1.2, pn.y0.shape[0])
    blk = y_mid.reshape(pn.nr, -1)
    blk[:, 2:] += rng.uniform(1e-3, 1e-1, blk[:, 2:].shape)
    blk[:, 0] += 50.0
    for y in (pn.y0, po.y, _t(y_mid)):
        jy = jnp.asarray(_np(y))
        assert _rel(pn.rhs(0.0, y), rhs_j(0.0, jy)) <= 1e-12
    for y in (pn.y0, _t(y_mid)):
        jy = jnp.asarray(_np(y))
        assert _rel(jac_p(0.0, y), jac_j(0.0, jy)) <= 1e-11
    T, V, n = pn._split(po.y)
    if case == "conducting_wall":
        # pure heat exchange: the gap closes and U is conserved to the
        # integration's tolerance (cv varies with T, unlike argon's)
        def U(y):
            T, _, n = pn._split(y)
            return sum(float(torch.dot(n[i], p_th.u0_RT(pm, T[i])))
                       * P.R_GAS * float(T[i]) for i in range(2))
        assert 0.0 < float(T[0] - T[1]) < 700.0
        assert abs(U(po.y) - U(pn.y0)) <= 1e-7 * abs(U(pn.y0))
    elif case == "piston_wall":
        assert abs(float(V.sum()) - 2.0) < 1e-12
        p0, p1 = float(pn.pressure(po.y, 0)), float(pn.pressure(po.y, 1))
        assert abs(p0 - p1) / p1 < 0.02
    elif case == "valve_fill":
        assert 4.9 < float(pn.pressure(po.y, 0)) / 101325.0 <= 5.01
        assert float(T[0]) > 400.0
    else:
        dn = float(torch.sum(n[0]) - torch.sum(pn._split(pn.y0)[2][0]))
        w = float(pm.mol_weights[pm.species_index("n2")])
        assert abs(dn - 0.01 * t_end / w) / dn < 1e-6


def test_reactor_net_single_reactor_matches_standalone(mechs):
    jm, pm = mechs["small_ig"]
    X = P.stoich_mixture(pm)
    pn = p_net.ReactorNet(pm, [(1000.0, 40 * 101325.0, X)], device=CPU)
    jn = j_net.ReactorNet(jm, [(1000.0, 40 * 101325.0, X)])
    assert _rel(pn.rhs(0.0, pn.y0), jax.jit(jn.rhs)(0.0, jn.y0)) <= 1e-12
    po = pn.advance(1e-4)
    r = P.IdealGasConstVolumeReactor(pm, device=CPU)
    rr = r.advance(r.initial_state(1000.0, 40 * 101325.0, X), 1e-4,
                   rtol=1e-8, atol=1e-14)
    T_net = float(pn._split(po.y)[0][0])
    assert abs(T_net - float(rr.y[0])) / float(rr.y[0]) < 1e-6


def test_cli_on_cpu_and_without_a_card(files, capsys):
    out = cli.main(["--mech", files["small"], "--device", "cpu",
                    "--rtol", "1e-6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# mechanism loaded")
    assert "15 species, 30 reactions" in lines[0]
    assert lines[1].startswith("Real-gas ignition delay:")
    assert lines[2].startswith("Ideal-gas ignition delay:")
    assert f"{out['tau_RG'] * 1e6:9.1f} us" in lines[1]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--mech", files["small"]])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.IdealGasConstVolumeReactor(P.load_mechanism(files["small"],
                                                      "nDodecane_IG"))


def test_cli_requires_a_mechanism(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu"])
    assert exc.value.code == 2 and "--mech" in capsys.readouterr().err
