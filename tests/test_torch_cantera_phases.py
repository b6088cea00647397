"""The port's Cantera phase models (g4s_tpu_torch/models/cantera/{water,
condensed, electrolyte, hkft, hmw, purefluid, plasma, vcs_multiphase}.py)
against the reference (g4s_tpu/models/cantera) on the CPU, in f64 on both
sides.

Inputs: chip_smoke.py's synthetic HMW seawater file (_synthetic_brine_yaml,
seed 0: IAPWS-95 water, HKFT, piecewise-Gibbs and Shomate standard states,
variable A_Debye, E-theta active) and its phase-model file
(_phase_models_yaml: the five Debye-Huckel forms, one phase of each
condensed family, an oxygen-plasma-shaped phase with three electron energy
distributions, an air-water ideal gas); states come from seeded numpy
generators. Each reference result is computed once, in module fixtures:
the reference's first eager calls through its density Newton cost seconds.

Tolerances, relative to the largest entry: closed forms 1e-12 (the
condensed families, Debye-Huckel, plasma); the IAPWS properties at a
given density 1e-11, since in the cold liquid p = rho R T (1 + delta
phir_d) keeps about 6 % of its terms (compressibility factor 0.06 at
287 K and 8 MPa), and that cancellation takes the reference's pow
rounding (exp(y log x), tens of ulp at tau^50) to 1.6e-12 on p, g and
alpha there; Newton-based values 1e-10 (IAPWS density and mu0, HKFT, HMW,
pure fluids); VCS phase moles and mole fractions 1e-9, its elements
conserved within 1e-10 (see ELEMENT_TOL). The IAPWS release check values
and the liquid density maximum near 4 C are checked on the port alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # x64 and the CPU platform are set by conftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import (BRINE_NACL_SPECIES, CONDENSED_PHASES,  # noqa: E402
                        DH_PHASES, PLASMA_PHASES, _phase_models_yaml,
                        _synthetic_brine_yaml)
from g4s_tpu.models.cantera import condensed as j_cd  # noqa: E402
from g4s_tpu.models.cantera import electrolyte as j_el  # noqa: E402
from g4s_tpu.models.cantera import hkft as j_hk  # noqa: E402
from g4s_tpu.models.cantera import hmw as j_hm  # noqa: E402
from g4s_tpu.models.cantera import mech as j_mech  # noqa: E402
from g4s_tpu.models.cantera import plasma as j_pl  # noqa: E402
from g4s_tpu.models.cantera import purefluid as j_pf  # noqa: E402
from g4s_tpu.models.cantera import vcs_multiphase as j_vcs  # noqa: E402
from g4s_tpu.models.cantera import water as j_w  # noqa: E402
from g4s_tpu_torch.models import cantera as P  # noqa: E402
from g4s_tpu_torch.models.cantera import condensed as p_cd  # noqa: E402
from g4s_tpu_torch.models.cantera import electrolyte as p_el  # noqa: E402
from g4s_tpu_torch.models.cantera import hkft as p_hk  # noqa: E402
from g4s_tpu_torch.models.cantera import hmw as p_hm  # noqa: E402
from g4s_tpu_torch.models.cantera import mech as p_mech  # noqa: E402
from g4s_tpu_torch.models.cantera import plasma as p_pl  # noqa: E402
from g4s_tpu_torch.models.cantera import purefluid as p_pf  # noqa: E402
from g4s_tpu_torch.models.cantera import vcs_multiphase as p_vcs  # noqa: E402
from g4s_tpu_torch.models.cantera import water as p_w  # noqa: E402

CPU = "cpu"
CLOSED = 1e-12
IAPWS = 1e-11
NEWTON = 1e-10
VCS_TOL = 1e-9
# vcs_multiphase_tp reports x after its last damped activity refresh,
# which moves q by up to half its stopping drift (1e-10), so the reported
# phases hold the elements to about 1e-11, not to the inner Newton's 1e-11
# residual alone
ELEMENT_TOL = 1e-10
# GRI-Mech 3.0 NASA7 low-range rows, the pure fluids' ideal-gas anchors
NASA_N2 = [3.298677, 1.4082404e-3, -3.963222e-6, 5.641515e-9,
           -2.444854e-12, -1020.8999, 3.950372]
NASA_CO2 = [2.35677352, 8.98459677e-3, -7.12356269e-6, 2.45919022e-9,
            -1.43699548e-13, -48371.9697, 9.90105222]


def _rel(a, b) -> float:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("phases")
    brine, phases = str(d / "brine.yaml"), str(d / "phases.yaml")
    counts = _synthetic_brine_yaml(brine, seed=0)
    _phase_models_yaml(phases)
    return {"brine": brine, "phases": phases, "counts": counts,
            "dir": d}


# ---------------------------------------------------------------- water


WATER_STATES = [(float(T), float(Pr)) for T, Pr in zip(
    np.random.default_rng(0).uniform(280.0, 450.0, 3),
    np.random.default_rng(1).uniform(1e6, 5e7, 3))]


@pytest.fixture(scope="module")
def water_ref():
    out = []
    for T, Pr in WATER_STATES:
        rho = float(j_w.density(T, Pr))
        out.append({
            "rho": rho, "p": float(j_w.pressure(T, rho)),
            "a": float(j_w.helmholtz_mole(T, rho)),
            "s": float(j_w.entropy_mole(T, rho)),
            "h": float(j_w.enthalpy_mole(T, rho)),
            "g": float(j_w.gibbs_mole(T, rho)),
            "kappa": float(j_w.isothermal_compressibility(T, rho)),
            "alpha": float(j_w.thermal_expansion_coeff(T, rho)),
            "mu0": float(j_w.WaterStandardState().mu0(T, Pr))})
    return out


def test_water_release_values_on_the_port():
    """IAPWS-95 check point p(500 K, 838.025 kg/m^3) = 10.0003858 MPa,
    rho(298.15 K, 1 atm) = 997.0476 kg/m^3, the PDSS_Water mu0 at 423.15 K
    (-317.175792 kJ/gmol), the anchoring offsets, and liquid water's
    density maximum near 4 C: alpha < 0 at 276.15 K, > 0 at 300 K."""
    assert abs(float(p_w.pressure(500.0, 838.025, device=CPU)) / 1e6
               - 10.0003858) < 2e-5
    assert abs(float(p_w.density(298.15, 101325.0, device=CPU))
               - 997.0476) < 1e-3
    ss = p_w.WaterStandardState(device=CPU)
    assert abs(float(ss.mu0(423.15, 101325.0)) / 1e6 + 317.175792) < 2e-6
    ew, sw = ss._compute_offsets()
    assert abs(ew - ss.EW_OFFSET) < 1.0 and abs(sw - ss.SW_OFFSET) < 1e-3
    alpha = [float(p_w.thermal_expansion_coeff(
        T, p_w.density(T, 101325.0, device=CPU))) for T in (276.15, 300.0)]
    assert alpha[0] < 0.0 < alpha[1]


@pytest.mark.parametrize("i", range(len(WATER_STATES)))
def test_water_matches_reference(water_ref, i):
    T, Pr = WATER_STATES[i]
    ref = water_ref[i]
    assert _rel(p_w.density(T, Pr, device=CPU), ref["rho"]) <= NEWTON
    assert _rel(p_w.WaterStandardState(device=CPU).mu0(T, Pr),
                ref["mu0"]) <= NEWTON
    rho = ref["rho"]
    got = {"p": p_w.pressure(T, rho, device=CPU),
           "a": p_w.helmholtz_mole(T, rho, device=CPU),
           "s": p_w.entropy_mole(T, rho, device=CPU),
           "h": p_w.enthalpy_mole(T, rho, device=CPU),
           "g": p_w.gibbs_mole(T, rho, device=CPU),
           "kappa": p_w.isothermal_compressibility(T, rho, device=CPU),
           "alpha": p_w.thermal_expansion_coeff(T, rho, device=CPU)}
    for k, v in got.items():
        assert _rel(v, ref[k]) <= IAPWS, k


def test_water_steam_table_vmap(water_ref):
    """torch.func.vmap of density and the properties over a 4 x 4 grid of
    liquid states equals the one-state calls and solves p = P; one grid
    state against the reference."""
    Tg, Pg = torch.meshgrid(
        torch.linspace(275.0, 550.0, 4, dtype=torch.float64),
        torch.linspace(1e7, 1e8, 4, dtype=torch.float64), indexing="ij")
    Tg, Pg = Tg.reshape(-1), Pg.reshape(-1)
    vm = torch.func.vmap
    rho = vm(p_w.density)(Tg, Pg)
    table = {"rho": rho, "h": vm(p_w.enthalpy_mole)(Tg, rho),
             "s": vm(p_w.entropy_mole)(Tg, rho),
             "p": vm(p_w.pressure)(Tg, rho),
             "alpha": vm(p_w.thermal_expansion_coeff)(Tg, rho)}
    assert _rel(table["p"], Pg) <= NEWTON
    for j in (0, 7, 15):
        one = p_w.density(Tg[j], Pg[j])
        assert _rel(rho[j], one) <= CLOSED
        assert _rel(table["h"][j], p_w.enthalpy_mole(Tg[j], one)) <= CLOSED
        assert _rel(table["alpha"][j],
                    p_w.thermal_expansion_coeff(Tg[j], one)) <= CLOSED
    T5, P5 = float(Tg[5]), float(Pg[5])
    assert _rel(rho[5], float(j_w.density(T5, P5))) <= NEWTON


# ----------------------------------------------------------- condensed


def _cd_state(ph, seed):
    rng = np.random.default_rng(seed)
    return (float(rng.uniform(350.0, 900.0)), float(rng.uniform(1e5, 5e6)),
            rng.dirichlet(np.ones(len(ph.species))))


@pytest.mark.parametrize("name", ["ideal-solid", "lattice", "margules",
                                  "redlich-kister", "tabulated",
                                  "electron-cloud", "stoich-sub"])
def test_condensed_props_match_reference(files, name):
    """Loader fields equal; g, h, s, cp, v, mu, mean MW and density from
    the port's loaded phase and from the reference's, carried across by
    condensed_from_reference, against the reference's props (its
    density is props' mw_mean / v)."""
    jp = j_cd.load_phase(files["phases"], name)
    pp = p_cd.load_phase(files["phases"], name)
    assert p_cd.condensed_from_reference(jp) == pp
    T, Pr, X = _cd_state(jp, CONDENSED_PHASES.index(name))
    ref = jax.jit(lambda T, Pr, X: j_cd.props(jp, T, Pr, X))(T, Pr, X)
    for ph in (pp, p_cd.condensed_from_reference(jp._asdict())):
        got = p_cd.props(ph, T, Pr, X, device=CPU)
        for k in ref._fields:
            assert _rel(getattr(got, k), getattr(ref, k)) <= CLOSED, k
        assert _rel(p_cd.density(ph, T, Pr, X, device=CPU),
                    ref.mw_mean / ref.v) <= CLOSED


def test_maskell_and_ideal_molal_match_reference(files):
    y = files["phases"]
    jm, pm = j_cd.load_phase(y, "maskell"), p_cd.load_phase(y, "maskell")
    assert p_cd.condensed_from_reference(jm) == pm
    mu_ref = jax.jit(lambda X: j_cd.maskell_chem_potentials(
        jm, 450.0, 2e5, X))
    for r in (0.2, 0.65):
        X = np.array([r, 1.0 - r])
        assert _rel(p_cd.maskell_chem_potentials(pm, 450.0, 2e5, X,
                                                 device=CPU),
                    mu_ref(X)) <= CLOSED
    ji, pi = j_cd.load_phase(y, "ideal-molal"), \
        p_cd.load_phase(y, "ideal-molal")
    assert p_cd.ideal_molal_from_reference(ji) == pi
    m = np.random.default_rng(3).uniform(0.01, 2.0, 2)
    ref = jax.jit(lambda m: j_cd.ideal_molal_props(ji, 320.0, 3e5, m))(m)
    got = p_cd.ideal_molal_props(pi, 320.0, 3e5, m, device=CPU)
    for k in ref:
        assert _rel(got[k], ref[k]) <= CLOSED, k


def test_compound_lattice_and_ions_match_reference(files):
    """The compound lattice's molar properties, and the ions-from-neutral
    phase's chemical potentials, enthalpy (mu - T dmu/dT by jacfwd) and
    density. The reference's ions_props reads X on the host, so it runs
    here as its parts under jax.jit (eagerly it takes seconds):
    ions_chem_potentials, its jacfwd in T, and the neutral phase's
    density at the cation fractions."""
    y = files["phases"]
    jc = j_cd.load_phase(y, "compound-lattice")
    pc = p_cd.load_phase(y, "compound-lattice")
    assert p_cd.compound_lattice_from_reference(jc) == pc
    Xs = [np.array([0.3, 0.7]), np.array([1.0])]
    ref = jax.jit(lambda T, Pr: j_cd.compound_lattice_props(
        jc, T, Pr, Xs))(600.0, 4e6)
    got = p_cd.compound_lattice_props(pc, 600.0, 4e6, Xs, device=CPU)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= CLOSED
    ji = j_cd.load_phase(y, "ions-from-neutral")
    pi = p_cd.load_phase(y, "ions-from-neutral")
    assert p_cd.ions_from_neutral_from_reference(ji) == pi
    X = np.array([0.3, 0.2, 0.5])
    T, Pr = 800.0, 101325.0

    def ref_parts(T):
        mu_t = lambda t: j_cd.ions_chem_potentials(ji, t, Pr, X)  # noqa
        mu = mu_t(T)
        h = X @ (mu - T * jax.jacfwd(mu_t)(T))
        return mu, h, h / (X @ np.asarray(ji.ion_mws))
    mu, h, h_mass = jax.jit(ref_parts)(T)
    # the cation fractions as ions_props forms them: K+ -> KCl(L),
    # Li+ -> LiCl(L)
    Xn = np.zeros(2)
    for ci, j in enumerate(ji.cation_to_neutral):
        Xn[j] += X[[i for i in range(3) if i != ji.anion][ci]]
    rho = jax.jit(lambda T: j_cd.density(ji.neutral, T, Pr,
                                         Xn / Xn.sum()))(T)
    got = p_cd.ions_props(pi, T, Pr, X, device=CPU)
    for k, v in (("mu", mu), ("h_mole", h), ("h_mass", h_mass),
                 ("density", rho)):
        assert _rel(got[k], v) <= CLOSED, k


# ----------------------------------------------------- Debye-Huckel


DH_MOLALITIES = {
    "bdot_ak": {"Na+": 9.3549, "Cl-": 9.3549, "H+": 1.0499e-8,
                "OH-": 1.3765e-6, "NaCl(aq)": 0.98492},
    "beta_ij": {"Na+": 3.0, "Cl-": 3.0, "H+": 1.0499e-8,
                "OH-": 1.3765e-6, "NaCl(aq)": 0.98492}}


def _dh_molalities(ph, mset):
    m = np.zeros(ph.nspec)
    for k, v in DH_MOLALITIES[mset].items():
        m[ph.species_index(k)] = v
    return m


@pytest.fixture(scope="module")
def dh_ref(files):
    """The reference's gamma for each form and molality set, one jit per
    form."""
    out = {}
    for name in DH_PHASES:
        jp = j_el.load_debye_huckel(files["phases"], name)
        f = jax.jit(lambda m, jp=jp: j_el.molality_activity_coefficients(
            jp, m))
        for mset in DH_MOLALITIES:
            m = _dh_molalities(jp, mset)
            out[name, mset] = (jp, m, np.asarray(f(m)),
                               float(j_el.ionic_strength(jp, m)))
    return out


@pytest.mark.parametrize("name", DH_PHASES)
@pytest.mark.parametrize("mset", sorted(DH_MOLALITIES))
def test_debye_huckel_matches_reference(files, dh_ref, name, mset):
    jp, m, ref, I_ref = dh_ref[name, mset]
    pp = p_el.load_debye_huckel(files["phases"], name)
    back = p_el.debye_huckel_from_reference(jp)
    for k in jp._fields:
        assert np.array_equal(np.asarray(getattr(back, k)),
                              np.asarray(getattr(pp, k))), k
    for ph in (pp, back):
        assert _rel(p_el.molality_activity_coefficients(ph, m, device=CPU),
                    ref) <= CLOSED
    assert _rel(P.ionic_strength(pp, m, device=CPU), I_ref) <= CLOSED


# ------------------------------------------------------------ HMW, HKFT


HMW_STATES = [(float(T), float(f)) for T, f in zip(
    np.random.default_rng(5).uniform(285.0, 360.0, 2),
    np.random.default_rng(6).uniform(0.5, 8.0, 2))]


def _hmw_molalities(ph, scale):
    m = np.zeros(ph.nspec)
    for k, v in ph.state_molalities.items():
        m[ph.species_index(k)] = v * (scale if v > 1e-4 else 1.0)
    return m


@pytest.fixture(scope="module")
def hmw_ref(files):
    J = j_hm.load_hmw(files["brine"], "seawater")
    out = []
    for T, scale in HMW_STATES:
        m = _hmw_molalities(J, scale)
        out.append({"m": m, "act": j_hm.activity_all(J, m, T)})
    # the reference's first partial_molar_props takes about 12 s (its
    # grads through the density Newton compile): one state
    T, m = HMW_STATES[0][0], out[0]["m"]
    out[0]["pmp"] = j_hm.partial_molar_props(J, T, 101325.0, m)
    return J, out


def test_hmw_loader_and_from_reference(files, hmw_ref):
    """The seawater file has the HMW (1984) width; the port's loader and
    hmw_from_reference of the reference's phase agree field by field,
    the nested Mu0Poly and HKFTSpecies standard states included."""
    J, _ = hmw_ref
    assert files["counts"]["solutes"] == 11
    kinds = {m[0] for m in J.mu0_models}
    assert kinds == {"iapws", "hkft", "mu0poly", "shomate"}
    assert np.isnan(J.A_debye)
    pp = p_hm.load_hmw(files["brine"], "seawater")
    back = p_hm.hmw_from_reference(J._asdict())
    for ph in (pp, back):
        for k in J._fields:
            if k == "mu0_models":
                continue
            assert np.array_equal(np.asarray(getattr(ph, k)),
                                  np.asarray(getattr(J, k)),
                                  equal_nan=k == "A_debye"), k
        for a, b in zip(ph.mu0_models, J.mu0_models):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                if hasattr(y, "_fields"):
                    for f in y._fields:
                        assert np.array_equal(np.asarray(getattr(x, f)),
                                              np.asarray(getattr(y, f))), f
                else:
                    assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("i", range(len(HMW_STATES)))
def test_hmw_matches_reference(files, hmw_ref, i):
    """activity_all on the seawater phase (E-theta and psi active,
    variable A_Debye through the IAPWS density), from the port's loaded
    phase and from the reference's carried across, at two states, and
    partial_molar_props at the first."""
    J, refs = hmw_ref
    T = HMW_STATES[i][0]
    ref = refs[i]
    pp = p_hm.load_hmw(files["brine"], "seawater")
    for ph in (pp, p_hm.hmw_from_reference(J)):
        act = p_hm.activity_all(ph, ref["m"], T, device=CPU)
        for k, v in ref["act"].items():
            assert _rel(act[k], v) <= NEWTON, k
    if "pmp" in ref:
        pmp = p_hm.partial_molar_props(pp, T, 101325.0, ref["m"],
                                       device=CPU)
        for k, v in ref["pmp"].items():
            assert _rel(pmp[k], v) <= NEWTON, k


def test_hkft_matches_reference(files, hmw_ref):
    """rel_epsilon, a_debye and the g-function at two states; each HKFT
    species of the seawater file (loader fields, mu0) and the standard
    state of Cl- (V, S, H through the IAPWS density) at the second."""
    from g4s_tpu_torch.models.cantera.mech import _yaml_load
    doc = _yaml_load(files["brine"])
    entries = [s for s in doc["species-brine"]
               if s.get("equation-of-state", {}).get("model") == "HKFT"]
    assert len(entries) == 5
    for (T, _), Pr in zip(HMW_STATES, (101325.0, 2e7)):
        for f in ("rel_epsilon", "a_debye", "g_star"):
            assert _rel(getattr(p_hk, f)(T, Pr, device=CPU),
                        float(getattr(j_hk, f)(T, Pr))) <= NEWTON, f
    for e in entries:
        js, ps = j_hk.load_hkft_species(e), p_hk.load_hkft_species(e)
        assert p_hk.hkft_species_from_reference(js) == ps
        assert _rel(p_hk.mu0(ps, T, Pr, device=CPU),
                    float(j_hk.mu0(js, T, Pr))) <= NEWTON
    js = j_hk.load_hkft_species(entries[2])
    ref = j_hk.standard_state(js, T, Pr)
    got = p_hk.standard_state(p_hk.hkft_species_from_reference(js), T, Pr,
                              device=CPU)
    for a, b in zip(got, ref):
        assert _rel(a, float(b)) <= NEWTON


def test_hmw_unknown_h0_unit_raises(files, tmp_path):
    """A piecewise-Gibbs h0 in a unit outside the table: the reference
    takes a factor of 1.0 without a word; the port raises."""
    text = open(files["brine"]).read()
    assert '"-230.015 kJ/mol"' in text
    bad = tmp_path / "bad.yaml"
    bad.write_text(text.replace('"-230.015 kJ/mol"', '"-230.015 kJ/gram"'))
    J = j_hm.load_hmw(str(bad), "seawater")
    i = J.species_index("OH-")
    assert J.mu0_models[i][1].h_knots[1] == -230.015
    with pytest.raises(ValueError, match="kJ/gram"):
        p_hm.load_hmw(str(bad), "seawater")


# --------------------------------------------------------- pure fluids


PF_CASES = {"N2": (NASA_N2, 80.0, (70.0, 1e6), (300.0, 1e5)),
            "CO2": (NASA_CO2, 270.0, (250.0, 5e6), (320.0, 2e6))}


@pytest.mark.parametrize("name", sorted(PF_CASES))
def test_purefluid_matches_reference(name, monkeypatch):
    """Anchoring offsets, the saturation state (Maxwell construction), a
    liquid and a gas state through set_TP with their properties, and a
    two-phase state through set_TX; the port's equal-Gibbs residual at
    saturation within 1e-8 relative. The reference's rho_tp, g_mass,
    h_mass and s_mass run under jax.jit here: outside jit rho_tp's
    fori_loop compiles anew on every call (0.4 s each, a dozen calls per
    saturation state)."""
    monkeypatch.setattr(j_pf, "rho_tp", jax.jit(
        j_pf.rho_tp, static_argnums=(0,), static_argnames=("iters",)))
    for f in ("g_mass", "h_mass", "s_mass"):
        monkeypatch.setattr(j_pf, f, jax.jit(getattr(j_pf, f),
                                             static_argnums=(0,)))
    nasa, T_sat, liq, gas = PF_CASES[name]
    jf = j_pf.PureFluid(j_pf.SUBSTANCES[name], nasa)
    pf = p_pf.PureFluid(p_pf.SUBSTANCES[name], nasa, device=CPU)
    assert _rel([pf.h_off, pf.s_off], [jf.h_off, jf.s_off]) <= NEWTON
    sat_ref = j_pf.update_sat(j_pf.SUBSTANCES[name], T_sat)
    sat = p_pf.update_sat(p_pf.SUBSTANCES[name], T_sat, device=CPU)
    for a, b in zip(sat, sat_ref):
        assert _rel(a, b) <= NEWTON
    g = [float(p_pf.g_mass(pf.sub, r, T_sat, device=CPU))
         for r in sat[1:]]
    assert abs(g[0] - g[1]) <= 1e-8 * max(abs(g[0]), abs(g[1]))
    rho, psat = pf.set_TX(T_sat, 0.5)
    assert _rel(psat, sat_ref[0]) <= NEWTON
    assert _rel(rho, 1.0 / (0.5 / sat_ref[1] + 0.5 / sat_ref[2])) <= NEWTON
    for T, Pr in (liq, gas):
        rho_ref = jf.set_TP(T, Pr)[0]
        assert _rel(pf.set_TP(T, Pr)[0], rho_ref) <= NEWTON
        ref = jf.props(T, rho_ref)
        got = pf.props(T, rho_ref)
        for k in ref:
            assert _rel(got[k], ref[k]) <= NEWTON, k


# ------------------------------------------------------------- plasma


@pytest.mark.parametrize("name", sorted(PLASMA_PHASES))
def test_plasma_matches_reference(files, name):
    """The distribution on its 1,000 levels, Te, the mean energy, the
    species thermo with the electron at Te, the mixture enthalpy and the
    two-temperature rate, from the port's loaded phase and from the
    reference's carried across."""
    jp = j_pl.load_plasma(files["phases"], name)
    pp = p_pl.load_plasma(files["phases"], name, device=CPU)
    back = p_pl.plasma_from_reference(jp, device=CPU)
    assert back.species == pp.species and back.Te == pp.Te
    assert pp.levels.numel() == 1000
    X = np.random.default_rng(9).dirichlet(np.ones(5))
    for ph in (pp, back):
        assert _rel(ph.dist, np.asarray(jp.dist)) <= CLOSED
        assert _rel(ph.Te, jp.Te) <= CLOSED
        assert _rel(ph.mean_energy(), jp.mean_energy()) <= CLOSED
        for T in (300.0, 1200.0):
            for f in ("h0_RT", "s0_R", "cp0_R"):
                assert _rel(getattr(ph, f)(T),
                            np.asarray(getattr(jp, f)(T))) <= CLOSED, f
            assert _rel(ph.enthalpy_mole(T, X),
                        float(jp.enthalpy_mole(T, X))) <= CLOSED
    args = (3.2e-9, 0.7, 400.0, 1500.0, 500.0, pp.Te)
    assert _rel(p_pl.two_temp_plasma_rate(*args, device=CPU),
                float(j_pl.two_temp_plasma_rate(*args))) <= CLOSED


# ---------------------------------------------------------------- VCS


def _vcs_inputs():
    return [np.array([2.0, 0.0, 0.0, 0.0, 0.0]), np.array([4.0, 0.0, 0.0]),
            np.array(5.0)]


def _element_totals(res, comps):
    tot = {}
    for phase, d in res["phases"].items():
        for sp, x in d["x"].items():
            for e, v in comps[sp].items():
                tot[e] = tot.get(e, 0.0) + d["N"] * x * v
    return tot


def test_vcs_multiphase_matches_reference(files, monkeypatch):
    """The reference's NaCl_equil layout: the synthetic brine's NaCl
    phase, an N2/O2/H2O gas and NaCl(S) as a Shomate stoichiometric
    phase, 2 mol H2O(L), 4 mol N2 and 5 mol NaCl(S) at 298.15 K and 1
    atm. The port on its own loaded phases and on the reference's carried
    across, against the reference: phase moles and mole fractions within
    1e-9, the elements (charge included) conserved within ELEMENT_TOL of
    the largest total, in both packages, and NaCl(S) both dissolving and
    remaining."""
    T, Pr = 298.15, 101325.0
    brine, y = files["brine"], files["phases"]
    jmech = j_mech.load_mechanism(y, "air-water")
    ref = j_vcs.vcs_multiphase_tp(
        [j_vcs.hmw_solution_phase(brine, "NaCl-brine", T, Pr),
         j_vcs.gas_solution_phase(jmech, T, Pr),
         j_vcs.stoich_phase_from_yaml(brine, "NaCl(S)", T, Pr)],
        _vcs_inputs(), T, Pr)
    J = j_hm.load_hmw(brine, "NaCl-brine")
    assert list(J.species_names) == BRINE_NACL_SPECIES
    fields = {f: getattr(jmech, f) for f in jmech.__dataclass_fields__}
    cases = {"port": (p_vcs.hmw_solution_phase(brine, "NaCl-brine", T, Pr,
                                               device=CPU),
                      p_vcs.gas_solution_phase(
                          p_mech.load_mechanism(y, "air-water"), T, Pr,
                          device=CPU))}
    # the reference's loaded phases carried across: hmw_solution_phase
    # loads its phase through hmw.load_hmw
    monkeypatch.setattr(p_hm, "load_hmw",
                        lambda path, name: p_hm.hmw_from_reference(J))
    cases["from_reference"] = (
        p_vcs.hmw_solution_phase(brine, "NaCl-brine", T, Pr, device=CPU),
        p_vcs.gas_solution_phase(p_mech.mechanism_from_reference(fields),
                                 T, Pr, device=CPU))
    comps = {"NaCl(S)": {"NA": 1.0, "CL": 1.0}}
    for ph in cases["port"][:2]:
        comps.update(zip(ph.species_names, ph.compositions))
    b0 = {"H": 4.0, "O": 2.0, "N": 8.0, "NA": 5.0, "CL": 5.0,
          "E": 0.0}
    for name, (brine_ph, gas_ph) in cases.items():
        got = p_vcs.vcs_multiphase_tp(
            [brine_ph, gas_ph,
             p_vcs.stoich_phase_from_yaml(brine, "NaCl(S)", T, Pr)],
            _vcs_inputs(), T, Pr)
        assert got["outer"] >= 1 and got["newton"] >= 1
        for phase, d in ref["phases"].items():
            assert _rel(got["phases"][phase]["N"], d["N"]) <= VCS_TOL, \
                (name, phase)
            x_ref = np.array(list(d["x"].values()))
            x_got = np.array([got["phases"][phase]["x"][k] for k in d["x"]])
            assert _rel(x_got, x_ref) <= VCS_TOL, (name, phase)
        for res in (got, ref):
            tot = _element_totals(res, comps)
            for e, v in b0.items():
                assert abs(tot.get(e, 0.0) - v) <= ELEMENT_TOL * 8.0, \
                    (name, e)
    n_solid = got["phases"]["NaCl(S)"]["N"]
    assert 0.0 < n_solid < 5.0
