"""The port's Cantera 1-D flames, equilibrium, transport, surface kinetics
and SolutionArray (g4s_tpu_torch/models/cantera/{transport,
multi_transport, transport_models, equilibrium, solution_array, surface,
flame}.py) against the reference (g4s_tpu/models/cantera) on the CPU, in
f64 on both sides.

Inputs: the 15-species, 30-reaction instance of chip_smoke.py's synthetic
n-dodecane-shaped mechanism with its transport blocks (the ideal-gas
phase; the Redlich-Kwong one for the high-pressure model), chip_smoke.py's
synthetic Pt interface on it, and inline YAML for an ion mixture and a
condensed species; states are drawn from seeded numpy generators. The
reference's eager calls cost seconds each, so its functions run under
jax.jit with host arrays closed over.

Tolerances, relative to the largest entry: transport 1e-12; equilibrium
1e-10; SolutionArray 1e-12; interface rates 1e-12 and coverages 1e-9;
flame RHS 1e-12 and Jacobians 1e-11 (the port's chunked Jacobians 1e-13
of torch.func.jacfwd); a burner march of a fixed short time 1e-9 with the
reference's step counts; damped Newton 1e-9; refine_grid and the host
Newton solve equal.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import (_synthetic_interface_yaml,  # noqa: E402
                        _synthetic_mechanism_yaml)
from g4s_tpu.models import cantera as J  # noqa: E402
from g4s_tpu.models.cantera import equilibrium as j_eq  # noqa: E402
from g4s_tpu.models.cantera import flame as j_fl  # noqa: E402
from g4s_tpu.models.cantera import multi_transport as j_mt  # noqa: E402
from g4s_tpu.models.cantera import surface as j_sf  # noqa: E402
from g4s_tpu.models.cantera import transport as j_tr  # noqa: E402
from g4s_tpu.models.cantera import transport_models as j_tm  # noqa: E402
from g4s_tpu.ops import odeint as j_ode  # noqa: E402
from g4s_tpu_torch.models import cantera as P  # noqa: E402
from g4s_tpu_torch.models.cantera import equilibrium as p_eq  # noqa: E402
from g4s_tpu_torch.models.cantera import flame as p_fl  # noqa: E402
from g4s_tpu_torch.models.cantera import multi_transport as p_mt  # noqa: E402
from g4s_tpu_torch.models.cantera import surface as p_sf  # noqa: E402
from g4s_tpu_torch.models.cantera import transport as p_tr  # noqa: E402
from g4s_tpu_torch.models.cantera import transport_models as p_tm  # noqa: E402
from g4s_tpu_torch.models.cantera.thermo import cp0_R  # noqa: E402

F64 = torch.float64
CPU = torch.device("cpu")
SMALL = {"nspec": 15, "nrxn": 30, "n_falloff": 2, "n_three_body": 2,
         "seed": 0}
IG = "nDodecane_IG"

_ION_YAML = """
units: {length: cm, quantity: mol, activation-energy: cal/mol}
phases:
- {name: ions, thermo: ideal-gas, species: [N2, O2, H2O, O2-, H3O+, E]}
species:
- name: N2
  composition: {N: 2}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[3.5, 0., 0., 0., 0., -1050., 4.0],
                  [3.5, 0., 0., 0., 0., -1050., 4.0]]}
  transport: {model: gas, geometry: linear, well-depth: 97.53,
              diameter: 3.621, polarizability: 1.76,
              rotational-relaxation: 4.0}
- name: O2
  composition: {O: 2}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[3.6, 0., 0., 0., 0., -1070., 5.0],
                  [3.6, 0., 0., 0., 0., -1070., 5.0]]}
  transport: {model: gas, geometry: linear, well-depth: 107.4,
              diameter: 3.458, polarizability: 1.6,
              rotational-relaxation: 3.8}
- name: H2O
  composition: {H: 2, O: 1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[4.0, 0., 0., 0., 0., -30000., 0.5],
                  [4.0, 0., 0., 0., 0., -30000., 0.5]]}
  transport: {model: gas, geometry: nonlinear, well-depth: 572.4,
              diameter: 2.605, dipole: 1.844, polarizability: 1.45,
              rotational-relaxation: 4.0}
- name: O2-
  composition: {O: 2, E: 1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[3.7, 0., 0., 0., 0., -6000., 5.0],
                  [3.7, 0., 0., 0., 0., -6000., 5.0]]}
  transport: {model: gas, geometry: linear, well-depth: 107.4,
              diameter: 3.458, polarizability: 1.424}
- name: H3O+
  composition: {H: 3, O: 1, E: -1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[4.5, 0., 0., 0., 0., 70000., 1.0],
                  [4.5, 0., 0., 0., 0., 70000., 1.0]]}
  transport: {model: gas, geometry: nonlinear, well-depth: 106.2,
              diameter: 3.15, polarizability: 0.897}
- name: E
  composition: {E: 1}
  thermo: {model: NASA7, temperature-ranges: [200., 1000., 3500.],
           data: [[2.5, 0., 0., 0., 0., -745., -11.7],
                  [2.5, 0., 0., 0., 0., -745., -11.7]]}
  transport: {model: gas, geometry: atom, well-depth: 850.0,
              diameter: 425.0, polarizability: 0.667}
reactions: []
"""

_GRAPHITE_YAML = """
phases:
- {name: graphite, thermo: fixed-stoichiometry, species: [C(gr)]}
species:
- name: C(gr)
  composition: {C: 1}
  thermo:
    model: NASA7
    temperature-ranges: [200.0, 1000.0, 5000.0]
    data:
    - [-0.310872072, 4.40353686e-03, 1.90394118e-06, -6.38546966e-09,
       2.98964248e-12, -108.650794, 1.11382953]
    - [1.45571829, 1.71702216e-03, -6.97562786e-07, 1.35277032e-10,
       -9.67590652e-15, -695.138814, -8.52583033]
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cantera_flame")
    out = {k: d / f"{k}.yaml" for k in ("small", "surf", "ion", "graphite")}
    _synthetic_mechanism_yaml(str(out["small"]), **SMALL)
    _synthetic_interface_yaml(str(out["surf"]), seed=0)
    out["ion"].write_text(_ION_YAML)
    out["graphite"].write_text(_GRAPHITE_YAML)
    return {k: str(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def gas(files):
    """(reference mech, reference transport, port mech, port transport)
    of the small mechanism's ideal-gas phase."""
    jm = J.load_mechanism(files["small"], IG)
    pm = P.load_mechanism(files["small"], IG)
    return (jm, j_tr.load_transport(files["small"], jm), pm,
            p_tr.load_transport(files["small"], pm))


_O0 = {"xla_backend_optimization_level": 0,
       "xla_llvm_disable_expensive_passes": True}


def _ref_jit(f):
    """jax.jit(f) compiled with XLA's backend optimisations off: the
    reference's flame and integrator graphs then compile in half the time
    or less, to the same values within rounding."""
    jitted, compiled = jax.jit(f), {}

    def call(*args):
        key = tuple((np.shape(a), np.result_type(a)) for a in args)
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(_O0)
        return compiled[key](*args)
    return call


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _rel(a, b):
    """Largest difference relative to b's largest magnitude."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _stoich_Y(m):
    """Stoichiometric n-dodecane/air mass fractions."""
    X = np.zeros(m.nspec)
    X[m.species_index("c12h26")] = 1.0
    X[m.species_index("o2")] = 18.5
    X[m.species_index("n2")] = 18.5 * 3.76
    Y = X * np.asarray(m.mol_weights)
    return Y / Y.sum()


def _states(K, seed, n=3):
    """n (T, x, grad_x, cp-free) states: T in [400, 2500] K, x strictly
    positive, grad_x summing to zero."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random(K) + 1e-3
        g = rng.standard_normal(K)
        out.append((float(rng.uniform(400.0, 2500.0)), x / x.sum(),
                    g - g.mean()))
    return out


# ---- the transport blocks of the synthetic mechanism ---------------------

def _strip_transport(src, dst):
    doc = yaml.safe_load(open(src))
    for s in doc["species"]:
        s.pop("transport", None)
    with open(dst, "w") as f:
        yaml.safe_dump(doc, f)


def _same_fields(a, b):
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, np.ndarray) or isinstance(fb[k], np.ndarray):
            assert np.array_equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_transport_blocks_leave_the_mechanism_and_load_equal(files,
                                                             tmp_path):
    """Both packages load the mechanism with its transport blocks to the
    fields of the same file without them; both load the blocks equally
    (eps/k = 0.77 Tc, sigma = 2.44 (Tc/Pc)^(1/3) A for n-dodecane's
    published Tc, Pc), and transport_from_reference carries them."""
    bare = str(tmp_path / "bare.yaml")
    _strip_transport(files["small"], bare)
    for phase in ("nDodecane_RK", IG):
        for load in (J.load_mechanism, P.load_mechanism):
            _same_fields(load(files["small"], phase), load(bare, phase))
    jm, pm = J.load_mechanism(files["small"], IG), \
        P.load_mechanism(files["small"], IG)
    jt, pt = j_tr.load_transport(files["small"], jm), \
        p_tr.load_transport(files["small"], pm)
    for f in dataclasses.fields(pt):
        assert np.array_equal(getattr(jt, f.name), getattr(pt, f.name))
    i = pm.species_index("c12h26")
    assert pt.well_depth[i] == pytest.approx(0.77 * 658.0, rel=1e-10)
    assert pt.diameter[i] == pytest.approx(
        2.44e-10 * (658.0 / (18.2e5 / 101325.0)) ** (1 / 3), rel=1e-10)
    assert pt.geometry[pm.species_index("h")] == 0
    assert pt.geometry[pm.species_index("o2")] == 1
    assert pt.geometry[i] == 2
    carried = p_tr.transport_from_reference(jt)
    for f in dataclasses.fields(pt):
        assert np.array_equal(getattr(carried, f.name), getattr(pt, f.name))
    with pytest.raises(KeyError):
        p_tr.transport_from_reference({"geometry": jt.geometry})


# ---- transport ------------------------------------------------------------

P_ATM = 101325.0

# name -> (reference fn, port fn) of (mech, tr, T, x, grad_x, cp_R)
TRANSPORT = {
    "species_viscosities": (
        lambda m, tr, T, x, g, c: j_tr.species_viscosities(m, tr, T),
        lambda m, tr, T, x, g, c: p_tr.species_viscosities(m, tr, T)),
    "mixture_viscosity": (
        lambda m, tr, T, x, g, c: j_tr.mixture_viscosity(m, tr, T, x),
        lambda m, tr, T, x, g, c: p_tr.mixture_viscosity(m, tr, T, x)),
    "binary_diffusion": (
        lambda m, tr, T, x, g, c: j_tr.binary_diffusion(m, tr, T, P_ATM),
        lambda m, tr, T, x, g, c: p_tr.binary_diffusion(m, tr, T, P_ATM)),
    "mixture_diffusion_coeffs": (
        lambda m, tr, T, x, g, c: j_tr.mixture_diffusion_coeffs(
            m, tr, T, P_ATM, x),
        lambda m, tr, T, x, g, c: p_tr.mixture_diffusion_coeffs(
            m, tr, T, P_ATM, x)),
    "thermal_conductivity": (
        lambda m, tr, T, x, g, c: j_tr.thermal_conductivity(m, tr, T, x, c),
        lambda m, tr, T, x, g, c: p_tr.thermal_conductivity(m, tr, T, x, c)),
    "stefan_maxwell_velocities": (
        lambda m, tr, T, x, g, c: j_tr.stefan_maxwell_velocities(
            m, tr, T, P_ATM, x, g),
        lambda m, tr, T, x, g, c: p_tr.stefan_maxwell_velocities(
            m, tr, T, P_ATM, x, g)),
    "multi_diff_coeffs": (
        lambda m, tr, T, x, g, c: j_tr.multi_diff_coeffs(m, tr, T, P_ATM, x),
        lambda m, tr, T, x, g, c: p_tr.multi_diff_coeffs(m, tr, T, P_ATM,
                                                         x)),
    "multicomponent_conductivity": (
        lambda m, tr, T, x, g, c: j_mt.multicomponent_conductivity(
            m, tr, T, x, c),
        lambda m, tr, T, x, g, c: p_mt.multicomponent_conductivity(
            m, tr, T, x, c)),
    "thermal_diff_coeffs": (
        lambda m, tr, T, x, g, c: j_mt.thermal_diff_coeffs(m, tr, T, x, c),
        lambda m, tr, T, x, g, c: p_mt.thermal_diff_coeffs(m, tr, T, x, c)),
    "multicomponent_diff_coeffs": (
        lambda m, tr, T, x, g, c: j_mt.multicomponent_diff_coeffs(
            m, tr, T, P_ATM, x),
        lambda m, tr, T, x, g, c: p_mt.multicomponent_diff_coeffs(
            m, tr, T, P_ATM, x)),
    "species_mass_fluxes": (
        lambda m, tr, T, x, g, c: j_mt.species_mass_fluxes(
            m, tr, T, P_ATM, x, g, 1e5, c),
        lambda m, tr, T, x, g, c: p_mt.species_mass_fluxes(
            m, tr, T, P_ATM, x, g, 1e5, c)),
    "unity_lewis_diffusion": (
        lambda m, tr, T, x, g, c: j_tm.unity_lewis_diffusion(
            m, tr, T, P_ATM, x, c),
        lambda m, tr, T, x, g, c: p_tm.unity_lewis_diffusion(
            m, tr, T, P_ATM, x, c)),
}


@pytest.mark.parametrize("name", list(TRANSPORT))
def test_transport_matches(gas, name):
    jm, jt, pm, pt = gas
    jfn, pfn = TRANSPORT[name]
    ref = _ref_jit(lambda T, x, g, c: jfn(jm, jt, T, x, g, c))
    for T, x, g in _states(pm.nspec, seed=1):
        Tt = _t(T)
        c = cp0_R(pm, Tt)
        got = pfn(pm, pt, Tt, _t(x), _t(g), c)
        want = ref(jnp.asarray(T), jnp.asarray(x), jnp.asarray(g),
                   jnp.asarray(_np(c)))
        assert _rel(got, want) <= 1e-12, name


def test_dusty_gas_matches(gas):
    jm, jt, pm, pt = gas
    kw = dict(porosity=0.3, tortuosity=2.0, pore_radius=5e-7,
              particle_diameter=2e-6)
    jd, pd = j_tm.DustyGas(jm, jt, **kw), p_tm.DustyGas(pm, pt, device=CPU,
                                                        **kw)
    rng = np.random.default_rng(2)
    Y1, Y2 = rng.random(pm.nspec) + 1e-3, rng.random(pm.nspec) + 1e-3
    Y1, Y2 = Y1 / Y1.sum(), Y2 / Y2.sum()
    T, x, _ = _states(pm.nspec, seed=3, n=1)[0]
    assert _rel(pd.multi_diff_coeffs(T, 2e5, x), jax.jit(
        jd.multi_diff_coeffs)(T, 2e5, jnp.asarray(x))) <= 1e-12
    assert _rel(pd.knudsen_diff(T), jd.knudsen_diff(T)) <= 1e-12
    args = (600.0, 650.0, 1.2, 1.0, Y1, Y2, 1e-3)
    assert _rel(pd.molar_fluxes(*args), jax.jit(
        lambda *a: jd.molar_fluxes(*a, 1e-3))(*args[:-1])) <= 1e-12
    c = np.asarray(J.cp0_R(jm, jnp.asarray(T)))
    assert _rel(pd.thermal_conductivity(T, x, c), jax.jit(
        jd.thermal_conductivity)(T, jnp.asarray(x), jnp.asarray(c))) \
        <= 1e-12
    # the reference suite's scalings: D ~ porosity / tortuosity
    wide = p_tm.DustyGas(pm, pt, device=CPU, **{**kw, "porosity": 0.6})
    assert float(wide.knudsen_diff(T)[0]) == pytest.approx(
        2.0 * float(pd.knudsen_diff(T)[0]), rel=1e-12)


def test_ion_gas_matches(files):
    jm = J.load_mechanism(files["ion"])
    pm = P.load_mechanism(files["ion"])
    jg = j_tm.IonGasTransport(jm, j_tr.load_transport(files["ion"], jm))
    pg = p_tm.IonGasTransport(pm, p_tr.load_transport(files["ion"], pm),
                              device=CPU)
    assert (pg.k_e, pg.ions, pg.neutrals) == (jg.k_e, jg.ions, jg.neutrals)
    x = np.array([0.7, 0.2, 0.09, 0.004, 0.004, 0.002])
    for T in (800.0, 1800.0):
        for name in ("binary_diff", "mix_diff_coeffs", "mobilities",
                     "electrical_conductivity"):
            got = getattr(pg, name)(T, P_ATM, *(() if name == "binary_diff"
                                                else (x,)))
            want = getattr(jg, name)(T, P_ATM, *(() if name == "binary_diff"
                                                 else (x,)))
            assert _rel(got, want) <= 1e-12, (name, T)
        assert _rel(pg.viscosity(T, x), jg.viscosity(T, x)) <= 1e-12


def _hp_pair(files, phase):
    jm = J.load_mechanism(files["small"], phase)
    pm = P.load_mechanism(files["small"], phase)
    return jm, pm, j_tm.HighPressureGasTransport(
        jm, j_tr.load_transport(files["small"], jm)), \
        p_tm.HighPressureGasTransport(
            pm, p_tr.load_transport(files["small"], pm), device=CPU)


def test_high_pressure_transport_matches(files):
    """Lucas viscosity, Takahashi-corrected diffusion and Ely-Hanley
    conductivity on the Redlich-Kwong phase (critical constants from its
    a, b). On the ideal-gas phase the loaders' default pr_Tc of 1 K sends
    every species down the Peng-Robinson branch with b = 0: Pc is
    infinite, Vc 0, and the mixture rules divide by zero, in the
    reference as in the port (ROADMAP.md section 3)."""
    jm, pm, jh, ph = _hp_pair(files, "nDodecane_RK")
    for a in ("Tc", "Pc", "Zc", "w_ac", "Vc"):
        assert np.array_equal(getattr(ph, a), getattr(jh, a)), a
    X = np.zeros(pm.nspec)
    X[pm.species_index("c12h26")] = 1.0
    X[pm.species_index("o2")] = 18.5
    X[pm.species_index("n2")] = 69.56
    x = X / X.sum()
    T, Pr = 1500.0, 40 * P_ATM
    cp = np.asarray(J.cp0_R(jm, jnp.asarray(T)))
    assert _rel(ph.binary_diff_coeffs(T, Pr, x),
                jh.binary_diff_coeffs(T, Pr, x)) <= 1e-12
    assert _rel(ph.viscosity(T, Pr, x), jh.viscosity(T, Pr, x)) <= 1e-12
    assert _rel(ph.thermal_conductivity(T, Pr, x, cp),
                jh.thermal_conductivity(T, Pr, x, cp)) <= 1e-12
    with np.errstate(divide="ignore"):
        _, _, jh, ph = _hp_pair(files, IG)
    assert np.isinf(ph.Pc).all() and np.array_equal(ph.Vc, jh.Vc)
    for h in (jh, ph):
        with pytest.raises(ZeroDivisionError):
            h.viscosity(T, Pr, x)


def test_takahashi_correction_equal():
    for Pr, Tr in ((0.05, 1.2), (0.7, 1.5), (2.2, 3.0), (6.0, 2.0)):
        assert p_tm.takahashi_correction(Pr, Tr) == \
            j_tm.takahashi_correction(Pr, Tr)


# ---- equilibrium and SolutionArray ----------------------------------------

def test_equilibrate_tp_and_hp_match(gas):
    jm, _, pm, _ = gas
    X0 = np.zeros(pm.nspec)
    X0[pm.species_index("c12h26")] = 1.0
    X0[pm.species_index("o2")] = 18.5
    X0[pm.species_index("n2")] = 69.56
    for T in (1200.0, 2600.0):
        x_p = p_eq.equilibrate_tp(pm, T, P_ATM, X0, device=CPU)
        x_j = j_eq.equilibrate_tp(jm, T, P_ATM, X0)
        assert _rel(x_p, x_j) <= 1e-10
        A, els = p_eq.element_matrix(pm)
        b0 = A.T @ (X0 / X0.sum())
        ratio = (A.T @ x_p) / np.where(b0 > 0, b0, 1.0)
        on = b0 > 0
        assert np.abs(ratio[on] / ratio[on][0] - 1.0).max() < 1e-10
    # the reactants' enthalpy at 400 K: the adiabatic flame temperature
    x0 = X0 / X0.sum()
    W = np.asarray(pm.mol_weights)
    h = float(x0 @ (np.asarray(J.h0_RT(jm, jnp.asarray(400.0)))
                    * 8.314462618 * 400.0)) / float(x0 @ W)
    T_p, x_p = p_eq.equilibrate_hp(pm, h, P_ATM, X0, device=CPU)
    T_j, x_j = j_eq.equilibrate_hp(jm, h, P_ATM, X0)
    assert abs(T_p - T_j) <= 1e-10 * T_j and _rel(x_p, x_j) <= 1e-10
    assert 1500.0 < T_p < 3000.0


def test_vcs_equilibrate_with_condensed_matches(gas, files):
    jm, _, pm, _ = gas
    jc = j_eq.CondensedSpecies.from_yaml(files["graphite"], "C(gr)")
    pc = p_eq.CondensedSpecies.from_yaml(files["graphite"], "C(gr)")
    assert pc.g_RT(700.0) == jc.g_RT(700.0)
    x0 = np.zeros(pm.nspec)
    x0[pm.species_index("co")] = 1.0
    x_p, n_p, lam_p = p_eq.vcs_equilibrate_tp(pm, [pc], 700.0, P_ATM, x0,
                                              device=CPU)
    x_j, n_j, lam_j = j_eq.vcs_equilibrate_tp(jm, [jc], 700.0, P_ATM, x0)
    assert n_p.keys() == n_j.keys() == {"C(gr)"} and n_p["C(gr)"] > 1e-3
    assert abs(n_p["C(gr)"] - n_j["C(gr)"]) <= 1e-10 * n_j["C(gr)"]
    assert _rel(x_p, x_j) <= 1e-10
    assert lam_p.keys() == lam_j.keys()
    assert _rel(list(lam_p.values()), list(lam_j.values())) <= 1e-10


def test_equilibrium_temperature_uv_matches(gas):
    jm, _, pm, _ = gas
    X = np.zeros(pm.nspec)
    X[pm.species_index("c12h26")] = 1.0
    X[pm.species_index("o2")] = 18.5
    X[pm.species_index("n2")] = 69.56
    jr = J.IdealGasConstVolumeReactor(jm)
    pr = P.IdealGasConstVolumeReactor(pm, device=CPU)
    y = _np(pr.initial_state(1500.0, 10 * P_ATM, X))
    T_p, c_p = p_eq.equilibrium_temperature_uv(pr, _t(y))
    T_j, c_j = j_eq.equilibrium_temperature_uv(jr, jnp.asarray(y))
    assert abs(T_p - T_j) <= 1e-10 * T_j and T_p > 2500.0
    assert _rel(c_p, c_j) <= 1e-10


def test_solution_array_matches(gas):
    jm, _, pm, _ = gas
    rng = np.random.default_rng(4)
    n = 5
    T = np.linspace(400.0, 2400.0, n)
    X = rng.random((n, pm.nspec))
    X[:, [0, 3]] = 0.0             # zero mole fractions: the log clamp
    Pa = rng.uniform(0.5, 5.0, n) * P_ATM
    sp = P.SolutionArray(pm, T=T, P=Pa, X=X, device=CPU)
    sj = J.SolutionArray(jm, T=T, P=Pa, X=X)
    assert len(sp) == len(sj) == n
    names = ("mean_molecular_weight", "density", "concentrations",
             "cp_mole", "enthalpy_mole", "entropy_mole",
             "net_production_rates")
    want = jax.jit(lambda: [getattr(sj, k) for k in names])()
    for name, w in zip(names, want):
        assert _rel(getattr(sp, name), w) <= 1e-12, name
    assert _rel(sp("o2"), sj("o2")) <= 1e-12
    sp.equilibrate("TP")
    sj.equilibrate("TP")
    assert _rel(sp.X, sj.X) <= 1e-10
    with pytest.raises(NotImplementedError):
        sp.equilibrate("HP")


# ---- surface ----------------------------------------------------------------

@pytest.fixture(scope="module")
def interface(gas, files):
    jm, _, pm, _ = gas
    return (jm, j_sf.load_interface(files["surf"], jm), pm,
            p_sf.load_interface(files["surf"], pm, device=CPU))


def _gas_state(m, T=900.0):
    X = np.zeros(m.nspec)
    for k, v in (("c12h26", 0.01), ("o2", 0.2), ("h2o", 0.05), ("co", 0.02),
                 ("n2", 0.72)):
        X[m.species_index(k)] = v
    return X / X.sum() * P_ATM / (8.314462618 * T)


def test_interface_loads_and_rates_match(interface):
    jm, jk, pm, pk = interface
    assert (pk.surf.nspec, pk.nrxn) == (12, 24)
    assert pk.surf.site_density == jk.surf.site_density
    carried = p_sf.interface_from_reference(jk._replace(**{
        k: np.asarray(getattr(jk, k)) for k in jk._fields[2:]}), device=CPU)
    for k in pk._fields[2:]:
        assert torch.equal(getattr(carried, k), getattr(pk, k)), k
    conc = _gas_state(pm)
    rng = np.random.default_rng(5)
    for T in (700.0, 1100.0):
        th = rng.random(pk.surf.nspec)
        th /= th.sum()
        Tj, Tp = jnp.asarray(T), _t(T)
        for jf, pf in (
                (j_sf.forward_rate_constants_interface,
                 p_sf.forward_rate_constants_interface),):
            assert _rel(pf(pk, pm, Tp, _t(th)),
                        jf(jk, jm, Tj, jnp.asarray(th))) <= 1e-12
        for got, want in zip(
                p_sf.rates_of_progress_interface(pk, pm, Tp, _t(conc),
                                                 _t(th)),
                j_sf.rates_of_progress_interface(jk, jm, Tj,
                                                 jnp.asarray(conc),
                                                 jnp.asarray(th))):
            assert _rel(got, want) <= 1e-12
        sg, dth = p_sf.net_production_rates_interface(pk, pm, Tp, _t(conc),
                                                      _t(th))
        for got, want in zip((sg, dth), j_sf.net_production_rates_interface(
                jk, jm, Tj, jnp.asarray(conc), jnp.asarray(th))):
            assert _rel(got, want) <= 1e-12
        # every reaction conserves sites
        assert abs(float(dth.sum())) <= 1e-10 * float(dth.abs().max())


def test_advance_coverages_matches(interface):
    jm, jk, pm, pk = interface
    conc = _gas_state(pm)
    th0 = np.zeros(pk.surf.nspec)
    th0[0] = th0[1] = 0.5
    th_p, res_p = p_sf.advance_coverages(pk, pm, 900.0, conc, th0, 1e-3)

    # the reference's advance_coverages, jitted whole (its eager first
    # RHS and Jacobian take seconds)
    def rhs(t, th):
        return j_sf.net_production_rates_interface(
            jk, jm, jnp.asarray(900.0), jnp.asarray(conc),
            jnp.clip(th, 0.0, 1.0))[1]

    res_j = _ref_jit(lambda y0: j_ode.bdf_solve(
        rhs, y0, 0.0, 1e-3, rtol=1e-7, atol=1e-12,
        max_steps=100000))(jnp.asarray(th0))
    th_j = jnp.clip(res_j.y, 0.0, 1.0)
    th_j = th_j / jnp.sum(th_j)
    assert res_p.success and (res_p.steps, res_p.n_fev, res_p.n_jev) == (
        int(res_j.steps), int(res_j.n_fev), int(res_j.n_jev))
    assert _rel(th_p, th_j) <= 1e-9
    assert abs(float(th_p.sum()) - 1.0) <= 1e-12


# ---- flames -------------------------------------------------------------------

def _pair(gas, kind, n, **kw):
    """(reference flame, port flame, initial state as numpy)."""
    jm, jt, pm, pt = gas
    Y = _stoich_Y(pm)
    if kind == "burner":
        args = dict(n_points=n, width=0.01, mdot=0.08, T_burner=400.0, **kw)
        jf, pf = j_fl.BurnerFlame(jm, jt, **args), \
            p_fl.BurnerFlame(pm, pt, device=CPU, **args)
        return jf, pf, _np(pf.initial_profile(Y)), jf.initial_profile(Y)
    if kind == "free":
        args = dict(n_points=n, width=0.006, T_inlet=400.0)
        jf, pf = j_fl.FreeFlame(jm, jt, **args), \
            p_fl.FreeFlame(pm, pt, device=CPU, **args)
        return jf, pf, _np(pf.initial_profile(Y, mdot_guess=0.4)), \
            jf.initial_profile(Y, mdot_guess=0.4)
    if kind == "counterflow":
        Yf = np.zeros(pm.nspec)
        Yf[pm.species_index("c12h26")] = 0.3
        Yf[pm.species_index("n2")] = 0.7
        Yo = np.zeros(pm.nspec)
        Yo[pm.species_index("o2")] = 0.233
        Yo[pm.species_index("n2")] = 0.767
        args = dict(n_points=n, width=0.02, T_fuel=400.0)
        jf, pf = j_fl.CounterflowDiffusionFlame(jm, jt, **args), \
            p_fl.CounterflowDiffusionFlame(pm, pt, device=CPU, **args)
        return jf, pf, _np(pf.initial_profile(Yf, Yo)), \
            jf.initial_profile(Yf, Yo)
    args = dict(n_points=n, width=0.01, T_inlet=400.0)
    jf, pf = j_fl.ImpingingJet(jm, jt, **args), \
        p_fl.ImpingingJet(pm, pt, device=CPU, **args)
    return jf, pf, _np(pf.initial_profile(Y)), jf.initial_profile(Y)


def _perturbed(s0, seed):
    """The initial state (its absent species at exactly 0, clip ties)
    and a seeded perturbation with every entry positive."""
    rng = np.random.default_rng(seed)
    return [s0, s0 * (1.0 + 0.05 * rng.random(s0.size))
            + 1e-4 * rng.random(s0.size)]


@pytest.fixture(scope="module")
def ref_flame():
    """The reference flame's jitted (RHS, jacfwd) per flame id, shared by
    the tests of one flame (each compile takes seconds)."""
    cache = {}

    def get(key, jf):
        if key not in cache:
            cache[key] = _ref_jit(lambda y: (
                jf.rhs(0.0, y), jax.jacfwd(lambda v: jf.rhs(0.0, v))(y)))
        return cache[key]
    return get


FLAMES = [("burner", {"transport": "mix"}),
          ("burner", {"transport": "multi", "soret": True}),
          ("free", {}), ("counterflow", {}), ("jet", {})]


@pytest.mark.parametrize("kind,kw", FLAMES,
                         ids=["burner-mix", "burner-multi-soret", "free",
                              "counterflow", "jet"])
def test_flame_rhs_and_jacobian_match(gas, ref_flame, kind, kw):
    """RHS 1e-12 and the Jacobian the port's march and Newton use (the
    coloured block-tridiagonal one for the burner, chunked columns for
    the others) 1e-13 of torch.func.jacfwd and 1e-11 of the reference's
    jax.jacfwd, at the initial profile and a perturbed state."""
    jf, pf, s0, s0_j = _pair(gas, kind, 6, **kw)
    assert _rel(s0, s0_j) == 0.0
    ref = ref_flame((kind, tuple(sorted(kw.items()))), jf)
    for y in _perturbed(s0, seed=6):
        r_j, J_j = ref(jnp.asarray(y))
        yt = _t(y)
        assert _rel(pf.rhs(0.0, yt), r_j) <= 1e-12
        jac = pf.jacobian(0.0, yt)
        assert _rel(jac, torch.func.jacfwd(
            lambda v: pf.rhs(0.0, v))(yt)) <= 1e-13
        assert _rel(jac, J_j) <= 1e-11


def test_burner_soret_flux_matches(gas):
    jf, pf, s0, _ = _pair(gas, "burner", 6, soret=True)
    T, Y = pf.unpack(_perturbed(s0, seed=7)[1])
    assert _rel(pf.soret_flux(T, Y),
                jax.jit(jf.soret_flux)(jnp.asarray(T), jnp.asarray(Y))) \
        <= 1e-12


def test_free_flame_jacobian_first_then_rhs(gas, ref_flame, files):
    """A free flame whose first use is its Jacobian (the eigenvalue is a
    tangent there), then its RHS: each the reference's. The mass flux
    goes to the core RHS as an argument and is never stored on the flame,
    and the transport and mechanism tensors cached at first use are made
    outside the transform, so nothing of the Jacobian's transform escapes
    into the RHS call."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    jm, jt, _, _ = gas
    pm = P.load_mechanism(files["small"], IG)
    pt = p_tr.load_transport(files["small"], pm)
    Y = _stoich_Y(pm)
    pf = p_fl.FreeFlame(pm, pt, n_points=6, width=0.006, T_inlet=400.0,
                        device=CPU)
    jf = j_fl.FreeFlame(jm, jt, n_points=6, width=0.006, T_inlet=400.0)
    y = _perturbed(_np(pf.initial_profile(Y, mdot_guess=0.4)), seed=8)[1]
    jf.initial_profile(Y, mdot_guess=0.4)
    assert pf.mdot == 0.0
    jac = pf.jacobian(0.0, _t(y))
    assert pf.mdot == 0.0
    assert not any(is_functorch_wrapped_tensor(t) for obj in (pm, pt)
                   for t in obj._tensor_cache.values())
    rhs = pf.rhs(0.0, _t(y))
    r_j, J_j = ref_flame(("free", ()), jf)(jnp.asarray(y))
    assert _rel(rhs, r_j) <= 1e-12 and _rel(jac, J_j) <= 1e-11
    # the burner marches of the eigenvalue solves see the float flux
    pf.mdot = 0.3
    core = _t(y[1:])
    assert torch.equal(p_fl.BurnerFlame.rhs(pf, 0.0, core),
                       pf._core(core, 0.3))


def test_burner_march_matches(gas):
    """BurnerFlame.solve on 8 points for a fixed 5e-5 s: the reference's
    BDF (jitted whole) takes the same steps, RHS and
    Jacobian calls, and ends within 1e-9; the residual reductions agree."""
    jf, pf, s0, _ = _pair(gas, "burner", 8)
    t_end, rtol, atol = 5e-5, 1e-5, 1e-8
    res, red = pf.solve(_t(s0), t_end=t_end, rtol=rtol, atol=atol)
    ref = _ref_jit(lambda y0: j_ode.bdf_solve(
        jf.rhs, y0, 0.0, t_end, rtol=rtol, atol=atol,
        max_steps=20000))(jnp.asarray(s0))
    rhs_j = _ref_jit(jf.rhs)
    assert res.success and (res.steps, res.n_fev, res.n_jev) == (
        int(ref.steps), int(ref.n_fev), int(ref.n_jev))
    assert _rel(res.y, ref.y) <= 1e-9
    r0 = float(jnp.max(jnp.abs(rhs_j(jnp.asarray(0.0), jnp.asarray(s0)))))
    r1 = float(jnp.max(jnp.abs(rhs_j(jnp.asarray(0.0), ref.y))))
    assert abs(red - r1 / r0) <= 1e-9 * (r1 / r0)


def test_damped_newton_matches(gas):
    """Two damped-Newton iterations on the anchored free-flame residual
    (its mdot column dense) from the initial profile: the reference's
    within 1e-9. (The seeded perturbation of the other tests makes this
    Jacobian's condition number 5e15, where a 1e-15 difference in its
    entries moves the step by 3e-8 in either package.)"""
    jf, pf, y0, _ = _pair(gas, "free", 6)
    w = p_fl._flame_weights(pf, y0.size)
    w[0] = 10.0
    assert np.array_equal(w, j_fl._flame_weights(jf, y0.size))
    y_p, n_p, ok_p = p_fl.damped_newton(p_fl.anchored_residual(pf), _t(y0),
                                        weights=w, max_iter=2, tol=1e-6)
    y_j, n_j, ok_j = j_fl.damped_newton(j_fl.anchored_residual(jf),
                                        jnp.asarray(y0), weights=w,
                                        max_iter=2, tol=1e-6)
    assert ok_p == ok_j and abs(n_p - n_j) <= 1e-9 * n_j
    assert _rel(y_p, y_j) <= 1e-9


def test_newton_linear_solve_and_refine_grid_equal(gas):
    """The host steps, numpy in both packages: the banded solve with an
    absent species' zero diagonal, the dense and the singular
    (least-squares) fallbacks, and one Refiner pass."""
    rng = np.random.default_rng(10)
    n, hb = 40, 3
    Jm = np.triu(np.tril(rng.standard_normal((n, n)), hb), -hb) \
        + 8.0 * np.eye(n)
    Jm[5, :] = 0.0
    Jm[:, 5] = 0.0
    b = rng.standard_normal(n)
    for bw in (hb, None):
        got = p_fl._newton_linear_solve(Jm, b, bw)
        assert np.array_equal(got, j_fl._newton_linear_solve(Jm, b, bw))
    z = np.sort(rng.random(30)) * 0.02
    comps = np.stack([np.tanh((z - 0.01) / 1e-3), rng.random(30)], axis=1)
    for kw in ({}, {"slope": 0.3, "curve": 0.4, "max_insert": 3}):
        assert np.array_equal(p_fl.refine_grid(z, comps, **kw),
                              j_fl.refine_grid(z, comps, **kw))
    jm, _, pm, _ = gas
    assert p_fl.flame_bandwidth(p_fl.BurnerFlame(
        pm, None, n_points=4, device=CPU)) == 2 * (pm.nspec + 1) - 1
