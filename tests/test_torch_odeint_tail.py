"""The port's integrator tail (g4s_tpu_torch/ops/banded.py, ops/odeint.py's
bandwidth=, dae_solve and bdf_solve_with_sensitivities, and
ShockTubeBenchmark.run_ntc_sweep_batched) against the reference
(g4s_tpu/ops/banded.py, g4s_tpu/ops/odeint.py, g4s_tpu/models/cantera/
shock_tube.py) on the CPU, in f64 on both sides.

Inputs: the Brusselator of tests/test_banded.py (states from a seeded numpy
generator), the Robertson problem and the nondiagonal mass matrix of
tests/test_cantera.py, and the small synthetic n-dodecane-shaped mechanism
of tests/test_torch_cantera.py (15 species, 30 reactions).

Tolerances: the banded Jacobian, factor and solve 1e-12; the banded BDF
1e-9 of the reference's with steps, n_fev and n_jev within 2 %, and 1e-6
of scipy's BDF; dae_solve 1e-9 of the reference's; the sensitivities 2e-6
of each column's largest entry from the reference's (the reference also
differentiates the step sizes, the port does not: 6.1e-7 measured at rtol
1e-8, see bdf_solve_with_sensitivities) and 2e-3 of central finite
differences; each batched lane's tau 1e-6 relative of the reference's batch
and of the port's in-turn sweep.
"""

import os
import sys

import numpy as np
import pytest
import scipy.integrate
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import _synthetic_mechanism_yaml  # noqa: E402
from g4s_tpu.models import cantera as J  # noqa: E402
from g4s_tpu.ops import banded as j_band  # noqa: E402
from g4s_tpu.ops import odeint as j_ode  # noqa: E402
from g4s_tpu_torch.models import cantera as P  # noqa: E402
from g4s_tpu_torch.ops import banded as p_band  # noqa: E402
from g4s_tpu_torch.ops import odeint as p_ode  # noqa: E402

F64 = torch.float64
SMALL = {"nspec": 15, "nrxn": 30, "n_falloff": 2, "n_three_body": 2,
         "seed": 0}
K1, K2, K3 = 0.04, 3e7, 1e4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _counts_close(p, j):
    for name in ("steps", "n_fev", "n_jev"):
        a, b = int(getattr(p, name)), int(getattr(j, name))
        assert abs(a - b) <= 0.02 * b, (name, a, b)


def _brusselator(n_pts, xp):
    """tests/test_banded.py's 1-D Brusselator MOL (half-bandwidth 3 in the
    interleaved (u0, v0, u1, v1, ...) ordering) for jnp or torch."""
    A, B, D = 1.0, 3.0, 0.02
    h2 = (1.0 / (n_pts + 1)) ** 2

    def rhs(t, y):
        u, v = y[0::2], y[1::2]
        if xp is jnp:
            up = jnp.pad(u, 1, constant_values=A)
            vp = jnp.pad(v, 1, constant_values=B / A)
        else:
            up = torch.nn.functional.pad(u, (1, 1), value=A)
            vp = torch.nn.functional.pad(v, (1, 1), value=B / A)
        lap_u = (up[2:] - 2 * u + up[:-2]) / h2
        lap_v = (vp[2:] - 2 * v + vp[:-2]) / h2
        du = A - (B + 1) * u + u * u * v + D * lap_u
        dv = B * u - u * u * v + D * lap_v
        return xp.stack([du, dv], axis=1).reshape(-1) if xp is jnp \
            else torch.stack([du, dv], dim=1).reshape(-1)
    return rhs


def _rand_banded(n, ml, mu, rng, dom=4.0):
    M = np.zeros((n, n))
    for d in range(-ml, mu + 1):
        M += np.diag(rng.standard_normal(n - abs(d)), d)
    return M + dom * np.eye(n)


@pytest.mark.parametrize("n,ml,mu", [(17, 2, 3), (32, 1, 1), (9, 0, 2),
                                     (9, 3, 0), (64, 5, 5)])
def test_band_factor_solve_matches(n, ml, mu):
    rng = np.random.default_rng(n * 100 + ml * 10 + mu)
    M = _rand_banded(n, ml, mu, rng)
    b = rng.standard_normal(n)
    R = p_band.dense_to_band(_t(M), ml, mu)
    Rj = j_band.dense_to_band(jnp.asarray(M), ml, mu)
    assert np.array_equal(R.numpy(), np.asarray(Rj))
    assert np.array_equal(p_band.band_to_dense(R, ml, mu).numpy(), M)
    fac = p_band.band_factor(R, ml=ml, mu=mu)
    fj = j_band.band_factor(Rj, ml=ml, mu=mu)
    assert _rel(fac[0], fj[0]) <= 1e-12
    if ml:
        assert _rel(fac[1], fj[1]) <= 1e-12
    x = p_band.band_solve(fac, _t(b), ml=ml, mu=mu)
    assert _rel(x, j_band.band_solve(fj, jnp.asarray(b), ml=ml, mu=mu)) \
        <= 1e-12
    assert _rel(x, np.linalg.solve(M, b)) <= 1e-12
    # several right-hand sides at once (the sensitivities' tangents)
    B2 = rng.standard_normal((n, 3))
    assert _rel(p_band.band_solve(fac, _t(B2), ml=ml, mu=mu),
                np.linalg.solve(M, B2)) <= 1e-12


def test_banded_jac_and_newton_factor_match():
    n_pts, ml, mu = 12, 3, 3
    y = np.random.default_rng(3).uniform(0.5, 1.5, 2 * n_pts)
    Rp = p_band.banded_jac(_brusselator(n_pts, torch), 0.0, _t(y), ml, mu)
    Rj = j_band.banded_jac(_brusselator(n_pts, jnp), 0.0, jnp.asarray(y),
                           ml, mu)
    assert _rel(Rp, Rj) <= 1e-12
    Jd = jax.jacfwd(_brusselator(n_pts, jnp), argnums=1)(0.0,
                                                          jnp.asarray(y))
    assert _rel(p_band.band_to_dense(Rp, ml, mu), Jd) <= 1e-12
    c = 0.37
    b = np.sin(np.arange(2.0 * n_pts))
    x = p_band.band_solve(p_band.newton_band_factor(Rp, c, ml=ml, mu=mu),
                          _t(b), ml=ml, mu=mu)
    xj = j_band.band_solve(j_band.newton_band_factor(Rj, c, ml=ml, mu=mu),
                           jnp.asarray(b), ml=ml, mu=mu)
    assert _rel(x, xj) <= 1e-12
    assert _rel(x, np.linalg.solve(np.eye(2 * n_pts) - c * np.asarray(Jd),
                                   b)) <= 1e-12


def test_bdf_banded_matches_reference_and_scipy():
    n_pts = 10
    y0 = np.ones(2 * n_pts)
    kw = dict(rtol=1e-9, atol=1e-11, bandwidth=(3, 3))
    pr = p_ode.bdf_solve(_brusselator(n_pts, torch), _t(y0), 0.0, 1.0, **kw)
    jr = j_ode.bdf_solve(_brusselator(n_pts, jnp), jnp.asarray(y0), 0.0, 1.0,
                         **kw)
    assert pr.success and pr.steps > 10
    assert _rel(pr.y, jr.y) <= 1e-9
    _counts_close(pr, jr)
    rhs = _brusselator(n_pts, torch)
    ref = scipy.integrate.solve_ivp(
        lambda t, y: rhs(t, _t(y)).numpy(), (0.0, 1.0), y0, method="BDF",
        rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(pr.y.numpy(), ref.y[:, -1], rtol=1e-6,
                               atol=1e-8)
    # the banded path agrees with the dense one
    dense = p_ode.bdf_solve(rhs, _t(y0), 0.0, 1.0, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(pr.y.numpy(), dense.y.numpy(), rtol=1e-6,
                               atol=1e-8)


def _rober(xp):
    stack = jnp.stack if xp is jnp else torch.stack

    def rhs(t, y):
        return stack([-K1 * y[0] + K3 * y[1] * y[2],
                      K1 * y[0] - K2 * y[1] ** 2 - K3 * y[1] * y[2],
                      K2 * y[1] ** 2])

    def F(t, y, yp):
        return stack([yp[0] + K1 * y[0] - K3 * y[1] * y[2],
                      yp[1] - K1 * y[0] + K2 * y[1] ** 2 + K3 * y[1] * y[2],
                      y[0] + y[1] + y[2] - 1.0])
    return rhs, F


def test_dae_robertson_matches():
    """The Robertson problem in its index-1 DAE form (third equation the
    conservation law) against the reference's dae_solve and the port's own
    ODE BDF, as tests/test_cantera.py's IDA verification does."""
    rhs_p, F_p = _rober(torch)
    rhs_j, F_j = _rober(jnp)
    y0 = np.array([1.0, 0.0, 0.0])
    ydot0 = np.asarray(rhs_j(0.0, jnp.asarray(y0)))
    kw = dict(rtol=1e-9, atol=1e-12)
    pr = p_ode.dae_solve(F_p, _t(y0), _t(ydot0), 0.0, 100.0, **kw)
    jr = j_ode.dae_solve(F_j, jnp.asarray(y0), jnp.asarray(ydot0), 0.0,
                         100.0, **kw)
    assert pr.success and pr.host_reads >= pr.steps
    assert _rel(pr.y, jr.y) <= 1e-9
    _counts_close(pr, jr)
    ode = p_ode.bdf_solve(rhs_p, _t(y0), 0.0, 100.0, **kw)
    np.testing.assert_allclose(pr.y.numpy(), ode.y.numpy(), rtol=1e-6,
                               atol=1e-12)
    assert abs(float(pr.y.sum()) - 1.0) < 1e-10


def test_dae_mass_matrix_matches():
    """M y' = A y with a nondiagonal nonsingular M: y = exp(M^-1 A t) y0."""
    rng = np.random.default_rng(0)
    n = 4
    M = np.eye(n) + 0.2 * rng.normal(size=(n, n))
    A = -np.eye(n) + 0.3 * rng.normal(size=(n, n))
    y0 = rng.normal(size=n)
    ydot0 = np.linalg.solve(M, A @ y0)
    Mt, At = _t(M), _t(A)
    Mj, Aj = jnp.asarray(M), jnp.asarray(A)
    kw = dict(rtol=1e-10, atol=1e-12)
    pr = p_ode.dae_solve(lambda t, y, yp: Mt @ yp - At @ y, _t(y0),
                         _t(ydot0), 0.0, 2.0, **kw)
    jr = j_ode.dae_solve(lambda t, y, yp: Mj @ yp - Aj @ y,
                         jnp.asarray(y0), jnp.asarray(ydot0), 0.0, 2.0, **kw)
    assert pr.success
    assert _rel(pr.y, jr.y) <= 1e-9
    _counts_close(pr, jr)
    exact = scipy.linalg.expm(np.linalg.solve(M, A) * 2.0) @ y0
    np.testing.assert_allclose(pr.y.numpy(), exact, rtol=1e-6, atol=1e-9)


def test_forward_sensitivities_robertson():
    """dy(t)/dk on Robertson at rtol 1e-8 (tests/test_cantera.py's CVODES
    parity case): against the reference's jvp of its whole loop, and
    against central finite differences of the port's bdf_solve."""
    def rober_p(p, t, y):
        return torch.stack([-p[0] * y[0] + p[2] * y[1] * y[2],
                            p[0] * y[0] - p[1] * y[1] ** 2
                            - p[2] * y[1] * y[2], p[1] * y[1] ** 2])

    def rober_j(p, t, y):
        return jnp.stack([-p[0] * y[0] + p[2] * y[1] * y[2],
                          p[0] * y[0] - p[1] * y[1] ** 2
                          - p[2] * y[1] * y[2], p[1] * y[1] ** 2])

    p0 = np.array([K1, K2, K3])
    y0 = np.array([1.0, 0.0, 0.0])
    kw = dict(rtol=1e-8, atol=1e-12)
    res, sens = p_ode.bdf_solve_with_sensitivities(rober_p, _t(p0), _t(y0),
                                                   0.0, 10.0, **kw)
    jres, jsens = j_ode.bdf_solve_with_sensitivities(
        rober_j, jnp.asarray(p0), jnp.asarray(y0), 0.0, 10.0, **kw)
    assert res.success and tuple(sens.shape) == (3, 3)
    assert _rel(res.y, jres.y) <= 1e-9
    _counts_close(res, jres)
    s, js = sens.numpy(), np.asarray(jsens)
    per_col = np.abs(s - js).max(0) / np.abs(js).max(0)
    assert per_col.max() <= 2e-6, per_col
    # a pytree of parameters gives the same columns
    _, sens_d = p_ode.bdf_solve_with_sensitivities(
        lambda p, t, y: rober_p(torch.stack([p["k1"], p["k2"], p["k3"]]),
                                t, y),
        {"k1": _t(K1), "k2": _t(K2), "k3": _t(K3)}, _t(y0), 0.0, 10.0, **kw)
    assert torch.equal(sens_d, sens)
    eps = 1e-6 * K1
    ys = [p_ode.bdf_solve(lambda t, y, k=k: rober_p(_t([k, K2, K3]), t, y),
                          _t(y0), 0.0, 10.0, rtol=1e-10, atol=1e-14).y
          for k in (K1 + eps, K1 - eps)]
    fd = (ys[0] - ys[1]).numpy() / (2 * eps)
    scale = np.abs(fd).max()
    np.testing.assert_allclose(s[:, 0] / scale, fd / scale, atol=2e-3)


@pytest.fixture(scope="module")
def small_mech(tmp_path_factory):
    path = tmp_path_factory.mktemp("cantera_tail") / "small.yaml"
    _synthetic_mechanism_yaml(str(path), **SMALL)
    return str(path)


NTC_TEMPS = [1000.0, 1010.0, 1020.0]
NTC_KW = dict(t_end=0.0046, rtol=1e-5, atol=1e-10)


@pytest.fixture(scope="module")
def batched(small_mech):
    """The port's run_ntc_sweep_batched on the small mechanism at three
    temperatures whose OH peaks fall before t_end."""
    pb = P.ShockTubeBenchmark(small_mech, device="cpu")
    return pb, pb.run_ntc_sweep_batched(NTC_TEMPS, **NTC_KW)


def test_ntc_sweep_batched_matches_in_turn(batched):
    """Each lane's tau within 1e-6 of the port's in-turn sweep; the lanes
    step on their own (their step counts differ)."""
    pb, po = batched
    turn = pb.run_ntc_sweep(NTC_TEMPS, **NTC_KW)
    assert po["T"] == NTC_TEMPS
    for ph in ("RG", "IG"):
        tau = np.asarray(po[f"tau_{ph}"])
        assert (tau < NTC_KW["t_end"]).all(), (ph, tau)
        np.testing.assert_allclose(tau, turn[f"tau_{ph}"], rtol=1e-6)
        res = po[f"result_{ph}"]
        assert res.success.all() and len(set(res.steps.tolist())) > 1
        assert tuple(res.y.shape) == (3, 16)


@pytest.mark.slow
def test_ntc_sweep_batched_matches_reference(batched, small_mech):
    """Each lane's tau within 1e-6 of the reference's jax.vmap batch (slow:
    the reference compiles its vmapped BDF loop for each phase, about 21 s
    on one CPU worker)."""
    _, po = batched
    jo = J.ShockTubeBenchmark(small_mech).run_ntc_sweep_batched(NTC_TEMPS,
                                                                **NTC_KW)
    for ph in ("RG", "IG"):
        np.testing.assert_allclose(po[f"tau_{ph}"], jo[f"tau_{ph}"],
                                   rtol=1e-6)
