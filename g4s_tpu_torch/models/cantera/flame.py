"""One-dimensional flames (counterpart of g4s_tpu/models/cantera/flame.py;
the reference's oneD capability).

Reference: cantera/src/oneD (Sim1D + StFlow: 1-D reacting-flow domains
solved by damped Newton with pseudo-transient continuation). Here the
burner-stabilized premixed flame is discretized method-of-lines on a fixed
grid — upwind convection at a prescribed mass flux, mixture-averaged
diffusion, full chemistry — and marched to steady state with the port's
BDF integrator (pseudo-transient continuation, which is also StFlow's
fallback strategy). The free flame, the counterflow diffusion flame and
the impinging jet follow, with the reference's steady solves.

State per grid point: [T, Y_1..Y_K]; constant pressure. The state, the
residual and the Jacobian live on the flame's device (`device=`, default
"cuda") in its dtype; the per-point properties are torch.func.vmap over
the grid points. Jacobians are built from forward-mode products in
chunks of tangents (JVP_ELEMENTS), so their memory does not grow with
the state: the burner flame's (block tridiagonal: each point couples to its
two neighbours) from 3 (K+1) stencil-coloured tangents, the others from
the identity's columns. As in the reference, the steady Newton's linear
algebra runs on the host (numpy/scipy) on the Jacobian read back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from g4s_tpu_torch.models.cantera.kinetics import (_clip, _floor,
                                                   build_kinetics,
                                                   net_production_rates)
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.multi_transport import (
    multicomponent_conductivity, multicomponent_diff_coeffs,
    thermal_diff_coeffs)
from g4s_tpu_torch.models.cantera.thermo import cp0_R, h0_RT
from g4s_tpu_torch.models.cantera.transport import (TransportData,
                                                    mixture_diffusion_coeffs,
                                                    mixture_viscosity,
                                                    thermal_conductivity)
from g4s_tpu_torch.ops.odeint import bdf_solve
from g4s_tpu_torch.sparse.containers import resolve_device

# elements of one (tangents, points, w, w) intermediate of a Jacobian's
# vmapped JVP call, w the widest per-point matrix (K species, 3K for the
# multicomponent L-matrix): the tangents go in chunks that keep it under
# 2^27 (1 GiB in f64; a full-width burner's peak is then about 4.5 GB),
# where all of a 100-species flame's tangents at once would take tens of
# GB, and one call per tangent would launch thousands of times as many
# kernels
JVP_ELEMENTS = 1 << 27


def jvp_chunk(n_points: int, width: int) -> int:
    """Tangents per vmapped JVP call for n_points points whose widest
    per-point matrix is width x width (JVP_ELEMENTS)."""
    return max(1, JVP_ELEMENTS // (n_points * width * width))


def _jvp_rows(f, y, seeds, chunk: int):
    """(m, len(f(y))): row i is the product of f's Jacobian at y with
    seeds[i], `chunk` tangents per vmapped call."""
    def one(v):
        return jvp(f, (y,), (v,))[1]
    return torch.cat([vmap(one)(seeds[i:i + chunk])
                      for i in range(0, seeds.shape[0], chunk)])


def dense_jacobian(f, y, chunk: int):
    """torch.func.jacfwd(f)(y), column by column, `chunk` at a time."""
    eye = torch.eye(y.shape[0], dtype=y.dtype, device=y.device)
    return _jvp_rows(f, y, eye, chunk).T


def block_tridiagonal_jacobian(f, y, n_points: int, block: int,
                               chunk: int):
    """The Jacobian of f at y where point p's `block` rows depend only on
    points p-1, p, p+1 (the flame's three-point stencil): 3 * block
    tangents, column (p, k) in colour (p mod 3, k). Each row meets one
    point of a colour, so every entry is read back exactly."""
    dev = y.device
    col = torch.arange(n_points * block, device=dev)
    pt = col // block
    colour = (pt % 3) * block + col % block
    seeds = (colour[None, :] == torch.arange(3 * block, device=dev)[:, None]
             ).to(y.dtype)
    comp = _jvp_rows(f, y, seeds, chunk)           # (colours, rows)
    near = torch.abs(pt[:, None] - pt[None, :]) <= 1
    return torch.where(near, comp.T[:, colour], 0.0)


def _bcast(v, f):
    return v.reshape((-1,) + (1,) * (f.ndim - 1))


def _edge(f):
    """f padded by one edge-replicated row at each end (jnp.pad "edge")."""
    return torch.cat([f[:1], f, f[-1:]])


def _d2dz2(f, coeff, dzp, dzm):
    # d/dz (coeff df/dz), conservative on non-uniform spacing:
    # (c_{i+1/2}(f_{i+1}-f_i)/dzp - c_{i-1/2}(f_i-f_{i-1})/dzm)
    #   / (0.5 (dzp + dzm)); edge padding makes the end fluxes 0
    fm = _edge(f)
    cm = _edge(coeff)
    c_half_p = 0.5 * (cm[2:] + cm[1:-1])
    c_half_m = 0.5 * (cm[1:-1] + cm[:-2])
    flux_p = c_half_p * (fm[2:] - fm[1:-1]) / _bcast(dzp, f)
    flux_m = c_half_m * (fm[1:-1] - fm[:-2]) / _bcast(dzm, f)
    return (flux_p - flux_m) / _bcast(0.5 * (dzp + dzm), f)


def _set_first(v, first):
    return torch.cat([first[None], v[1:]])


class BurnerFlame:
    def __init__(self, mech: Mechanism, tr: TransportData, *, n_points=64,
                 width=0.02, mdot=0.04, pressure=101325.0, T_burner=300.0,
                 z=None, soret=False, transport="mix", device="cuda",
                 dtype=torch.float64):
        self.mech = mech
        self.tr = tr
        # StFlow::enableSoret (m_do_soret): add the thermal-diffusion
        # species flux -D_T,k grad(ln T), with D_T,k from the
        # multicomponent Dixon-Lewis solve (multi_transport.py)
        self.soret = bool(soret)
        # transport="multi": StFlow's m_do_multicomponent fluxes
        # j_k = (W_k rho / Wbar^2) sum_m W_m D_km dX_m/dz with the exact
        # getMultiDiffCoeffs matrix and the L-matrix conductivity
        # (StFlow.cpp:491-503, 536-549); "mix" keeps the mixture-averaged
        # Fickian form.
        if transport not in ("mix", "multi"):
            raise ValueError(f"transport={transport!r}")
        self.transport = transport
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kin = build_kinetics(mech, dtype, device=self.device)
        zv = np.linspace(0.0, width, n_points) if z is None else np.asarray(z)
        self.n = int(zv.size)
        self.z = self._t(zv)
        # per-interval spacings for the non-uniform discretization
        dz = np.diff(zv)
        self._dzm = self._t(np.concatenate([[dz[0]], dz]))   # z_i - z_i-1
        self._dzp = self._t(np.concatenate([dz, [dz[-1]]]))  # z_i+1 - z_i
        self.mdot = mdot
        self.P = pressure
        self.T_burner = T_burner
        self.W = self._t(mech.mol_weights)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    def initial_profile(self, Y_in: np.ndarray, *, T_hot=2200.0,
                        ignition_pos=0.3):
        """Inlet composition everywhere + a hot downstream ramp to light
        the flame (Sim1D's initial guess role)."""
        n = self.n
        zf = np.linspace(0, 1, n)
        T = self.T_burner + (T_hot - self.T_burner) * np.clip(
            (zf - ignition_pos) / 0.15, 0.0, 1.0)
        Y_in = np.asarray(Y_in, np.float64)
        Y = np.tile(Y_in, (n, 1))
        self.Y_in = self._t(Y_in)
        return self._t(np.concatenate([T[:, None], Y], axis=1).reshape(-1))

    def _props(self, T, Y):
        """rho, cp_mass, lambda, D_mix at all points (vectorized)."""
        x = (Y / self.W[None, :])
        x = x / x.sum(dim=1, keepdim=True)
        Wmix = 1.0 / torch.sum(Y / self.W[None, :], dim=1)
        rho = self.P * Wmix / (R_GAS * T)
        cp_r = vmap(lambda t: cp0_R(self.mech, t))(T)         # (n, K)
        cp_mass = torch.sum(Y * cp_r * R_GAS / self.W[None, :], dim=1)
        if self.transport == "multi":
            lam = vmap(lambda t, xx, c: multicomponent_conductivity(
                self.mech, self.tr, t, xx, c))(T, x, cp_r)
        else:
            lam = vmap(lambda t, xx, c: thermal_conductivity(
                self.mech, self.tr, t, xx, c))(T, x, cp_r)
        D = vmap(lambda t, xx: mixture_diffusion_coeffs(
            self.mech, self.tr, t, self.P, xx))(T, x)
        return rho, cp_mass, lam, D, x

    def rhs(self, t, state):
        """Pseudo-transient residual: dT/dt, dY/dt at interior points."""
        return self._core(state, self.mdot)

    def _core(self, state, mdot):
        """rhs at mass flux mdot (a float, or the free flame's eigenvalue
        unknown: passed, never stored on the flame, so that no tensor of a
        torch.func transform outlives the call)."""
        n, K = self.n, self.mech.nspec
        s = state.reshape(n, K + 1)
        T = _clip(s[:, 0], 200.0, 4000.0)
        Y_raw = _clip(s[:, 1:], 0.0, 1.0)
        Y = Y_raw / _floor(torch.sum(Y_raw, dim=1, keepdim=True), 1e-12)
        rho, cp, lam, D, x = self._props(T, Y)
        dzm = self._dzm      # (n,) backward spacings (edge-replicated)
        dzp = self._dzp      # (n,) forward spacings

        conc = rho[:, None] * Y / self.W[None, :]
        wdot = vmap(lambda tt, cc: net_production_rates(
            self.kin, self.mech, tt, cc))(T, conc)            # mol/m^3/s

        def ddz_upwind(f):
            # first-order upwind for positive u (StFlow's convection
            # scheme) on the possibly non-uniform grid
            df = torch.cat([(f[1:2] - f[0:1]), f[1:] - f[:-1]])
            return df / _bcast(dzm, f)

        # species: rho dY/dt = -mdot dY/dz + d/dz(rho D dY/dz) + wdot W
        if self.transport == "multi":
            # StFlow multicomponent fluxes (updateDiffFluxes :538-549):
            # j_k = (W_k rho / Wbar^2) sum_m W_m D_km dX_m/dz at interval
            # midpoints (interval-averaged properties), zero end fluxes;
            # the species term is -d(j_k)/dz.
            Wmix = torch.sum(x * self.W[None, :], dim=1)
            Dm = vmap(lambda tt, xx: multicomponent_diff_coeffs(
                self.mech, self.tr, tt, self.P, xx))(T, x)   # (n, K, K)
            fac = self.W[None, :] * (rho / Wmix ** 2)[:, None]
            fac_h = 0.5 * (fac[1:] + fac[:-1])               # (n-1, K)
            Dm_h = 0.5 * (Dm[1:] + Dm[:-1])                  # (n-1, K, K)
            gx = (x[1:] - x[:-1]) / self._dzp[:-1, None]     # (n-1, K)
            j_half = fac_h * torch.einsum("ikm,im->ik", Dm_h,
                                          self.W[None, :] * gx)
            zero = torch.zeros_like(j_half[:1])
            jpad = torch.cat([zero, j_half, zero])
            diff_Y = -(jpad[1:] - jpad[:-1]) \
                / (0.5 * (self._dzp + self._dzm))[:, None]
        else:
            diff_Y = _d2dz2(Y, rho[:, None] * D, dzp, dzm)
        if self.soret:
            # Soret flux j_T,k = -(D_T,k / T) dT/dz (StFlow.cpp
            # updateDiffFluxes m_do_soret branch); its negative
            # divergence enters the species equation:
            # + d/dz((D_T,k / T) dT/dz)
            cp_r = vmap(lambda tt: cp0_R(self.mech, tt))(T)
            dt_k = vmap(lambda tt, xx, cc: thermal_diff_coeffs(
                self.mech, self.tr, tt, xx, cc))(T, x, cp_r)   # (n, K)
            K_ = dt_k.shape[1]
            Tt = torch.broadcast_to(T[:, None], (self.n, K_))
            diff_Y = diff_Y + _d2dz2(Tt, dt_k / T[:, None], dzp, dzm)
        dY = (-mdot * ddz_upwind(Y) + diff_Y
              + wdot * self.W[None, :]) / rho[:, None]

        # energy: rho cp dT/dt = -mdot cp dT/dz + d/dz(lam dT/dz)
        #         - sum h_k wdot_k
        h_mol = vmap(lambda tt: h0_RT(self.mech, tt))(T) * R_GAS * T[:, None]
        q_chem = -torch.sum(h_mol * wdot, dim=1)
        dT = (-mdot * cp * ddz_upwind(T[:, None])[:, 0]
              + _d2dz2(T[:, None], lam[:, None], dzp, dzm)[:, 0]
              + q_chem) / (rho * cp)

        # keep the raw state on the sum(Y)=1 manifold (the rhs is
        # scale-invariant in Y, so without this the raw state can drift)
        dY = dY + 1e2 * (Y - Y_raw)

        # boundary conditions: burner inlet fixed (T, Y); outlet zero-grad
        dT = _set_first(dT, (self.T_burner - T[0]) * 1e3)
        dY = _set_first(dY, (self.Y_in - s[0, 1:]) * 1e3)
        out = torch.cat([dT[:, None], dY], dim=1)
        return out.reshape(-1)

    def tangent_chunk(self) -> int:
        """Tangents per vmapped JVP call of this flame's Jacobians."""
        K = self.mech.nspec
        return jvp_chunk(self.n, 3 * K if self.transport == "multi"
                         or self.soret else K)

    def jacobian(self, t, state):
        """d rhs / d state at the current mass flux, block tridiagonal
        (each point's rows see its neighbours only)."""
        mdot = self.mdot
        return block_tridiagonal_jacobian(
            lambda v: self._core(v, mdot), state, self.n,
            self.mech.nspec + 1, self.tangent_chunk())

    def solve(self, state0, *, t_end=0.5, rtol=1e-6, atol=1e-9,
              max_steps=20000):
        """Pseudo-transient march; returns (result, residual_reduction):
        the steady-state convergence measure Sim1D reports."""
        res = bdf_solve(self.rhs, state0, 0.0, t_end, rtol=rtol, atol=atol,
                        max_steps=max_steps, jac=self.jacobian)
        r0 = float(torch.max(torch.abs(self.rhs(0.0, state0))))
        r1 = float(torch.max(torch.abs(self.rhs(0.0, res.y))))
        return res, r1 / max(r0, 1e-300)

    def unpack(self, state):
        s = _host(state).reshape(self.n, self.mech.nspec + 1)
        return s[:, 0], s[:, 1:]

    def soret_flux(self, T, Y):
        """Per-point Soret mass fluxes j_T,k = -(D_T,k / T) dT/dz
        [kg/m^2/s] for a (n,) T and (n, K) Y profile (diagnostic)."""
        T, Y = self._t(_host(T)), self._t(_host(Y))
        x = Y / self.W[None, :]
        x = x / x.sum(dim=1, keepdim=True)
        cp_r = vmap(lambda tt: cp0_R(self.mech, tt))(T)
        dt_k = vmap(lambda tt, xx, cc: thermal_diff_coeffs(
            self.mech, self.tr, tt, xx, cc))(T, x, cp_r)
        dTdz = torch.gradient(T, spacing=(self.z,))[0]
        return -(dt_k / T[:, None]) * dTdz[:, None]


def _host(a) -> np.ndarray:
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a,
                      np.float64)


class FreeFlame(BurnerFlame):
    """Freely-propagating adiabatic premixed flame.

    Reference: Cantera's FreeFlame (src/oneD/StFlow.cpp, m_dovisc=false
    free-flow domain): the mass flux mdot is an EIGENVALUE fixed by
    anchoring the temperature at one interior grid point. Here the
    eigenvalue joins the pseudo-transient state vector with relaxation
        d(mdot)/dt = kappa * (T[i_fix] - T_fixed)
    (flame drifting upstream raises T at the anchor -> mdot grows and
    pushes it back). The laminar flame speed is Su = mdot / rho_unburned.
    """

    def __init__(self, mech: Mechanism, tr: TransportData, *, n_points=64,
                 width=0.02, pressure=101325.0, T_inlet=300.0,
                 anchor_frac=0.35, kappa=200.0, z=None, device="cuda",
                 dtype=torch.float64):
        super().__init__(mech, tr, n_points=n_points, width=width,
                         mdot=0.0, pressure=pressure, T_burner=T_inlet, z=z,
                         device=device, dtype=dtype)
        zv = _host(self.z)
        self.i_fix = int(np.argmin(np.abs(zv - (zv[0] + anchor_frac
                                                * (zv[-1] - zv[0])))))
        self.kappa = kappa
        self.T_fixed = None

    def initial_profile(self, Y_in, *, T_hot=2400.0, mdot_guess=0.5,
                        ignition_pos=None):
        # place the ignition ramp so the anchor node sits halfway up it,
        # then pin exactly the anchor's initial temperature (Sim1D
        # setFixedTemperature semantics)
        pos = (self.i_fix / self.n - 0.075) if ignition_pos is None \
            else ignition_pos
        core = super().initial_profile(Y_in, T_hot=T_hot, ignition_pos=pos)
        Tprof = _host(core).reshape(self.n, -1)[:, 0]
        self.T_fixed = float(Tprof[self.i_fix])
        return torch.cat([self._t([mdot_guess]), core])

    def rhs(self, t, state):
        mdot = state[0]
        core = self._core(state[1:], mdot)
        T_at_fix = state[1:].reshape(self.n, -1)[self.i_fix, 0]
        dmdot = self.kappa * (T_at_fix - self.T_fixed) / self.T_fixed
        return torch.cat([dmdot[None], core])

    def jacobian(self, t, state):
        """Dense: the mass flux's column reaches every row."""
        return dense_jacobian(lambda v: self.rhs(t, v), state,
                              self.tangent_chunk())

    def flame_speed(self, state):
        """Su = mdot / rho_u with the unburned (inlet) density."""
        state = _host(state)
        mdot = float(state[0])
        s = state[1:].reshape(self.n, -1)
        Y0 = s[0, 1:]
        Wmix = 1.0 / np.sum(Y0 / np.asarray(self.mech.mol_weights))
        rho_u = self.P * Wmix / (R_GAS * self.T_burner)
        return mdot / rho_u


def damped_newton(residual_fn, y0, *, weights=None, max_iter=60, tol=1e-4,
                  min_lambda=1e-4, bandwidth=None, chunk=None):
    """Sim1D's damped-Newton steady solve (cantera/src/oneD/MultiNewton.cpp):
    full Jacobian by forward-mode products (dense_jacobian), step damping
    by WEIGHTED residual reduction (MultiNewton uses per-component error
    weights the same way). Returns (y, ||F||_w, converged).

    The residual and the Jacobian are computed on y0's device; the
    Jacobian is read back and the step solved on the host. `chunk`:
    tangents per vmapped JVP call of the Jacobian (a flame's
    `tangent_chunk()`; None takes every column in one call).
    `bandwidth` (half-bandwidth) switches the linear solve to LAPACK's
    banded factorization — the reference uses a banded Jacobian for all
    1-D domains (OneDim::jacobian is a BandMatrix, src/oneD/OneDim.cpp);
    the flame system couples only nearest-neighbor points, so the half-
    bandwidth is 2*(nspec+1)-1 and the solve drops from O(n^3) to
    O(n*hb^2)."""
    def res(y):
        return residual_fn(0.0, y)

    y = torch.as_tensor(y0)
    chunk = chunk or y.shape[0]
    if weights is None:
        weights = np.ones(y.shape[0])
    w = np.asarray(weights)

    def wnorm(f):
        return float(np.sqrt(np.mean((_host(f) / w) ** 2)))

    f = res(y)
    nrm = wnorm(f)
    for _ in range(max_iter):
        if nrm < tol:
            return y, nrm, True
        J = _host(dense_jacobian(res, y, chunk))
        d = _newton_linear_solve(J, -_host(f), bandwidth)
        if d is None or not np.all(np.isfinite(d)):
            return y, nrm, False
        d = torch.as_tensor(d, dtype=y.dtype, device=y.device)
        lam = 1.0
        while lam >= min_lambda:
            y_new = y + lam * d
            f_new = res(y_new)
            n_new = wnorm(f_new)
            if np.isfinite(n_new) and n_new < nrm * (1.0 - 0.2 * lam) + 1e-30:
                break
            lam *= 0.5
        else:
            return y, nrm, False
        y, f, nrm = y_new, f_new, n_new
    return y, nrm, nrm < tol


def _newton_linear_solve(J, rhs, bandwidth):
    """Dense LU with lstsq fallback, or LAPACK banded when the structure
    is declared (zero rows/columns from species absent everywhere make
    the dense system singular; the minimum-norm step leaves them
    untouched). Host numpy: torch's CUDA lstsq assumes full rank."""
    n = J.shape[0]
    if bandwidth is not None and bandwidth < n - 1:
        import scipy.linalg
        hb = int(bandwidth)
        ab = np.zeros((2 * hb + 1, n))
        for i in range(-hb, hb + 1):
            ab[hb - i, max(i, 0): n + min(i, 0)] = np.diagonal(J, i)
        # regularize exact-zero diagonal entries (absent species)
        zero_diag = np.abs(np.diagonal(J)) == 0.0
        if zero_diag.any():
            ab[hb, zero_diag] = 1.0
            rhs = np.where(zero_diag, 0.0, rhs)
        try:
            return scipy.linalg.solve_banded((hb, hb), ab, rhs)
        except (np.linalg.LinAlgError, ValueError):
            pass     # fall through to dense
    try:
        return np.linalg.solve(J, rhs)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(J, rhs, rcond=None)[0]


def flame_bandwidth(flame) -> int:
    """Half-bandwidth of the (core) flame Jacobian: nearest-neighbor
    coupling of (nspec+1)-wide point blocks."""
    return 2 * (flame.mech.nspec + 1) - 1


def _flame_weights(flame, n_state):
    """Characteristic d/dt scales per component: T rows ~1e5 K/s, Y rows
    ~1e2 /s, the mdot/anchor row set by the caller — equalizes the Newton
    norm."""
    K = flame.mech.nspec
    w_core = np.tile(np.concatenate([[1e5], 1e2 * np.ones(K)]), flame.n)
    if n_state == flame.n * (K + 1) + 1:
        return np.concatenate([[1e1], w_core])
    return w_core


def anchored_residual(flame):
    """The steady free-flame system in Cantera's exact formulation: the
    mdot unknown is closed by the ALGEBRAIC anchor equation
    T(z_fix) = T_fixed (StFlow replaces the continuity residual at the
    fixed point, src/oneD/StFlow.cpp), not a relaxation ODE — relaxation
    drifts (measured: Su grows without settling) because once the front
    sharpens the anchor node sits in the burned plateau where T is
    insensitive to mdot."""
    def residual(t, y):
        core = FreeFlame.rhs(flame, t, y)[1:]
        T_fix = y[1:].reshape(flame.n, -1)[flame.i_fix, 0]
        row0 = (T_fix - flame.T_fixed)[None]
        return torch.cat([row0, core])
    return residual


def solve_free_flame(flame, state0, *, t_ignite=0.004, rtol=1e-5,
                     atol=1e-8, newton_tol=1e-6, bisect_iters=6):
    """Sim1D solve(): globalize by positioning the front at the anchor
    (warm-started pseudo-transient marches + flame-position bisection),
    then damped Newton on the steady system with the algebraic anchor
    equation closing the mdot eigenvalue."""
    y_core, mdot, err_cells = solve_flame_speed(
        flame, state0, iters=bisect_iters, t_ignite=t_ignite,
        t_inner=3 * t_ignite, rtol=rtol, atol=atol)
    y0 = torch.cat([flame._t([mdot]), y_core])
    w = _flame_weights(flame, int(y0.shape[0]))
    w[0] = 10.0     # anchor equation in Kelvin / this weight
    y, nrm, ok = damped_newton(anchored_residual(flame), y0, weights=w,
                               tol=newton_tol, chunk=flame.tangent_chunk())
    return y, nrm, ok


def _core_fns(flame):
    """The burner (core) RHS and its Jacobian at flame.mdot, the marches
    of the eigenvalue solves."""
    return (lambda t, y: BurnerFlame.rhs(flame, t, y),
            lambda t, y: BurnerFlame.jacobian(flame, t, y))


def solve_flame_speed(flame, state0, *, iters=10, t_ignite=0.006,
                      t_inner=0.015, rtol=1e-5, atol=1e-8):
    """Eigenvalue solve by bisection on the FLAME POSITION.

    NOTE: with the first-order upwind convection used here, numerical
    diffusion (u dz / 2) is comparable to the physical diffusivity at the
    default grids, so the eigenvalue carries O(1) discretization error —
    refine n_points (and use the returned position error, in cells) when
    the flame speed itself is the quantity of interest.

    The front position z_f(mdot) — where T crosses T_fixed — increases
    monotonically with the mass flux (low flux: flashback toward the
    inlet; high flux: blow-off downstream), so bracketing the anchor node
    and bisecting is robust where an anchor-temperature secant saturates.
    Inner steady solves are warm-started pseudo-transient burner marches
    (Sim1D's timestepping globalization). Returns (core_state, mdot,
    position_error_in_cells).
    """
    core_rhs, core_jac = _core_fns(flame)
    z = _host(flame.z)
    z_anchor = z[flame.i_fix]

    def temps(yv):
        return _host(yv.reshape(flame.n, -1)[:, 0])

    def front(yv):
        T = temps(yv)
        above = T >= flame.T_fixed
        if above.all():
            return z[0]
        if not above.any():
            return z[-1]
        k = int(np.argmax(above))
        if k == 0:
            return z[0]
        fr = (flame.T_fixed - T[k - 1]) / (T[k] - T[k - 1] + 1e-300)
        return z[k - 1] + fr * (z[k] - z[k - 1])

    def inner(m, y_start, t_end):
        flame.mdot = m
        r = bdf_solve(core_rhs, y_start, 0.0, t_end, rtol=rtol, atol=atol,
                      max_steps=60000, jac=core_jac)
        return r.y, front(r.y)

    m = float(state0[0])
    y, zf = inner(m, state0[1:], t_ignite)
    y_burn = y           # last profile with a live flame (warm-start source)
    m_lo = m_hi = None
    for _ in range(iters):
        Tmax = float(temps(y).max())
        if Tmax < flame.T_fixed:
            zf = z[-1]   # extinguished == blown off: flux too high
        else:
            y_burn = y
        if zf < z_anchor:      # flame too far upstream -> raise flux
            m_lo = m
            m = m * 1.5 if m_hi is None else 0.5 * (m + m_hi)
        else:
            m_hi = m
            m = m / 1.5 if m_lo is None else 0.5 * (m + m_lo)
        y, zf = inner(m, y_burn, t_inner)
        if m_lo is not None and m_hi is not None and \
                (m_hi - m_lo) < 0.02 * m_hi:
            break
    if float(temps(y).max()) < flame.T_fixed:
        y, zf = y_burn, front(y_burn)
    dz = z[1] - z[0]
    return y, m, abs(zf - z_anchor) / dz


# ---------------------------------------------------------------------------
# Adaptive regridding (Sim1D/Refiner, cantera/src/oneD/refine.cpp):
# intervals are split where a component's jump exceeds `slope` x its total
# range or its gradient jump exceeds `curve` x the gradient range, and
# where adjacent spacings violate the `ratio` bound. Each refinement round
# re-solves on the new grid (Sim1D::solve's refine loop).
# ---------------------------------------------------------------------------

def refine_grid(z, comps, *, ratio=8.0, slope=0.5, curve=0.6,
                max_insert=40, min_range_frac=1e-3):
    """One Refiner pass. comps: (n, m) profiles (T + species columns).

    Returns the refined grid (numpy, includes all old points)."""
    z = _host(z)
    c = _host(comps)
    n = z.size
    need = np.zeros(n - 1, bool)
    for j in range(c.shape[1]):
        f = c[:, j]
        rng = f.max() - f.min()
        if rng <= min_range_frac * max(abs(f).max(), 1e-300):
            continue
        jump = np.abs(np.diff(f))
        need |= jump > slope * rng                      # slope criterion
        g = np.diff(f) / np.diff(z)
        grng = g.max() - g.min()
        if grng > 0:
            gjump = np.abs(np.diff(g))
            mid = gjump > curve * grng                  # curve criterion
            need[:-1] |= mid
            need[1:] |= mid
    dz = np.diff(z)
    # ratio criterion: split intervals much larger than a neighbor
    big = np.zeros(n - 1, bool)
    big[:-1] |= dz[:-1] > ratio * dz[1:]
    big[1:] |= dz[1:] > ratio * dz[:-1]
    need |= big
    if need.sum() > max_insert:       # largest-error intervals first
        keep = np.argsort(-dz * need)[:max_insert]
        mask = np.zeros_like(need)
        mask[keep] = need[keep]
        need = mask
    mids = 0.5 * (z[:-1] + z[1:])[need]
    return np.sort(np.concatenate([z, mids]))


def solve_flame_speed_shift(flame, state0, *, iters=12,
                            t_probe=0.003, rtol=1e-5, atol=1e-8,
                            tol_frac=0.01, verbose=False):
    """Mass-flux eigenvalue by front-tracking with profile re-centering.

    March the CORE equations a short window, measure the front's drift
    velocity v_f, correct the eigenvalue by the continuity relation
    mdot <- mdot - rho_u * v_f (a front drifting downstream means the
    imposed flux exceeds rho_u * Su), then SHIFT the whole profile so the
    front returns to the anchor before the next probe. The shift removes
    the translational nullspace each iteration, so the flame can neither
    attach to the inlet nor blow off — the failure modes of plain
    position/drift bisection on coarse first-order-upwind grids.
    Returns (core_state, mdot, |v_f| / (mdot/rho_u) relative residual)."""
    core_rhs, core_jac = _core_fns(flame)
    z = _host(flame.z)
    z_anchor = float(z[flame.i_fix])
    T_mark = flame.T_fixed
    Y0 = _host(state0[1:]).reshape(flame.n, -1)[0, 1:]
    Wmix = 1.0 / np.sum(Y0 / np.asarray(flame.mech.mol_weights))
    rho_u = flame.P * Wmix / (R_GAS * flame.T_burner)

    def front(yv):
        T = _host(yv).reshape(flame.n, -1)[:, 0]
        above = T >= T_mark
        if above.all() or not above.any():
            return None
        k = int(np.argmax(above))
        if k == 0:
            return float(z[0])
        fr = (T_mark - T[k - 1]) / (T[k] - T[k - 1] + 1e-300)
        return float(z[k - 1] + fr * (z[k] - z[k - 1]))

    def shift_to_anchor(yv, zf):
        """Translate the profile so the front lands on the anchor;
        upstream fills with inlet state, downstream extends the last
        value (zero-gradient outlet)."""
        s = _host(yv).reshape(flame.n, -1)
        dzs = zf - z_anchor
        out = np.empty_like(s)
        zq = z + dzs
        for j in range(s.shape[1]):
            out[:, j] = np.interp(zq, z, s[:, j])
        # re-impose inlet
        out[0, 0] = flame.T_burner
        out[0, 1:] = _host(flame.Y_in)
        return flame._t(out.reshape(-1))

    m = float(state0[0])
    y = torch.as_tensor(state0[1:])
    rel = float("inf")
    for it in range(iters):
        flame.mdot = m
        r = bdf_solve(core_rhs, y, 0.0, t_probe, rtol=rtol, atol=atol,
                      max_steps=60000, jac=core_jac)
        z0 = front(y)
        z1 = front(r.y)
        if z1 is None or z0 is None:
            # flame lost: rebuild the ignition ramp around the anchor
            y = flame.initial_profile(_host(flame.Y_in),
                                      mdot_guess=m)[1:]
            continue
        v_f = (z1 - z0) / t_probe
        dm = rho_u * v_f
        # under-relax large corrections (far from the eigenvalue the
        # front speed is nonlinear in mdot)
        dm = np.clip(dm, -0.5 * m, 0.5 * max(m, 1e-3))
        m = max(m - dm, 1e-3)
        rel = abs(v_f) / max(m / rho_u, 1e-12)
        if verbose:
            print(f"#  it{it}: front {z0:.5f}->{z1:.5f} v_f={v_f:.3f} "
                  f"mdot={m:.4f} rel={rel:.3f}")
        y = shift_to_anchor(r.y, z1)
        if rel < tol_frac:
            break
    return y, m, rel


def solve_free_flame_adaptive(mech, tr, Y_in, *, n0=48, width=0.02,
                              pressure=101325.0, T_inlet=300.0,
                              rounds=3, max_points=220,
                              newton_tol=1e-6, verbose=False,
                              device="cuda"):
    """Sim1D::solve with grid refinement: find the flame-speed eigenvalue
    on a coarse grid (front-drift bisection as the marching globalizer,
    then a damped-Newton polish on the anchored steady system), refine
    where the Refiner criteria fire, interpolate, re-solve.

    Returns (flame, state, flame_speed_m_s, converged). `converged` means
    the final grid's eigenvalue bracket closed (Newton polish success is
    opportunistic — the bisected eigenvalue already satisfies the
    stationary-front criterion)."""
    flame = FreeFlame(mech, tr, n_points=n0, width=width,
                      pressure=pressure, T_inlet=T_inlet, device=device)
    state = flame.initial_profile(_host(Y_in))
    y_core, mdot, rel = solve_flame_speed_shift(flame, state,
                                                verbose=verbose)
    ok = rel < 0.05
    for r in range(rounds):
        z_old = _host(flame.z)
        core = _host(y_core).reshape(flame.n, -1)
        z_new = refine_grid(z_old, core, slope=0.3, curve=0.4)
        if z_new.size == z_old.size or z_new.size > max_points:
            break
        if verbose:
            print(f"# refine round {r}: {z_old.size} -> {z_new.size} points")
        core_new = np.stack([np.interp(z_new, z_old, core[:, j])
                             for j in range(core.shape[1])], axis=1)
        anchor_z = z_old[flame.i_fix]
        nf = FreeFlame(mech, tr, z=z_new, pressure=pressure,
                       T_inlet=T_inlet, kappa=flame.kappa, device=device)
        nf.i_fix = int(np.argmin(np.abs(z_new - anchor_z)))
        nf.T_fixed = flame.T_fixed
        nf.Y_in = flame.Y_in
        flame = nf
        s2 = flame._t(np.concatenate([[mdot], core_new.reshape(-1)]))
        y_core, mdot, rel = solve_flame_speed_shift(flame, s2,
                                                    verbose=verbose)
        ok = rel < 0.05
    # opportunistic Newton polish on the anchored steady system: a host
    # solve that fails leaves the bisected state (a device error or an
    # out-of-memory error stops the run)
    y = torch.cat([flame._t([mdot]), y_core])
    try:
        w = _flame_weights(flame, int(y.shape[0]))
        w[0] = 10.0
        yn, nrm, nok = damped_newton(anchored_residual(flame), y,
                                     weights=w, tol=newton_tol, max_iter=25,
                                     chunk=flame.tangent_chunk())
        if nok and float(yn[0]) > 0:
            y = yn
    except (np.linalg.LinAlgError, ValueError):
        pass
    su = flame.flame_speed(y)
    return flame, y, su, bool(ok)


class CounterflowDiffusionFlame:
    """Opposed-jet diffusion flame in similarity form (the reference's
    CounterflowDiffusionFlame on the AxiStagnFlow domain,
    src/oneD/StFlow.cpp m_dovisc=true).

    Axisymmetric stagnation similarity variables: axial mass flux
    rho*u(z) and spreading rate V = v/r, with the radial pressure
    eigenvalue Lambda = (1/r) dp/dr constant across the layer:

      continuity : d(rho u)/dz + 2 rho V = 0          (integrated exactly)
      radial mom.: rho u dV/dz + rho V^2 = -Lambda + d/dz(mu dV/dz)
      species    : rho u dY/dz = d/dz(rho D dY/dz) + wdot W
      energy     : rho u cp dT/dz = d/dz(lam dT/dz) - sum h wdot

    Fuel enters at z=0 (mdot_f > 0), oxidizer at z=L (mdot_o < 0;
    both V=0). rho*u comes from integrating continuity from the fuel
    inlet; Lambda joins the pseudo-transient state with the feedback
      dLambda/dt = -kappa_L (rho u(L) - mdot_o)
    (larger Lambda damps V, reducing the radial mass sink and raising
    rho u(L)) — the same eigenvalue-relaxation device the FreeFlame
    uses for its mdot. State: [Lambda, (V, T, Y_k) x n]. Each point
    couples to every upstream one through the integrated continuity, so
    the Jacobian is dense (dense_jacobian).
    """

    def __init__(self, mech: Mechanism, tr: TransportData, *, n_points=64,
                 width=0.02, pressure=101325.0,
                 mdot_fuel=0.05, mdot_ox=0.05,
                 T_fuel=300.0, T_ox=300.0, kappa_L=5e5, z=None,
                 device="cuda", dtype=torch.float64):
        self.mech = mech
        self.tr = tr
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kin = build_kinetics(mech, dtype, device=self.device)
        zv = np.linspace(0.0, width, n_points) if z is None else np.asarray(z)
        self.n = int(zv.size)
        self.z = self._t(zv)
        dz = np.diff(zv)
        self._dzm = self._t(np.concatenate([[dz[0]], dz]))
        self._dzp = self._t(np.concatenate([dz, [dz[-1]]]))
        self.P = pressure
        self.mdot_f = float(mdot_fuel)          # > 0 (into the domain)
        self.mdot_o = -abs(float(mdot_ox))      # < 0 at z = L
        self.T_fuel = T_fuel
        self.T_ox = T_ox
        self.kappa_L = kappa_L
        self.W = self._t(mech.mol_weights)

    _t = BurnerFlame._t

    def initial_profile(self, Y_fuel, Y_ox, *, T_hot=2000.0):
        """Linear blend of the two inlet streams with a hot bump at the
        middle to light the flame (CounterflowDiffusionFlame's default
        initial guess role)."""
        n = self.n
        zf = np.linspace(0.0, 1.0, n)
        Y = (1 - zf)[:, None] * _host(Y_fuel)[None, :] \
            + zf[:, None] * _host(Y_ox)[None, :]
        T = (1 - zf) * self.T_fuel + zf * self.T_ox \
            + (T_hot - 300.0) * np.exp(-((zf - 0.5) / 0.15) ** 2)
        V = np.zeros(n)
        self.Y_fuel = self._t(_host(Y_fuel))
        self.Y_ox = self._t(_host(Y_ox))
        core = np.concatenate([V[:, None], T[:, None], Y], axis=1)
        return self._t(np.concatenate([[0.0], core.reshape(-1)]))

    def _props(self, T, Y):
        x = (Y / self.W[None, :])
        x = x / x.sum(dim=1, keepdim=True)
        Wmix = 1.0 / torch.sum(Y / self.W[None, :], dim=1)
        rho = self.P * Wmix / (R_GAS * T)
        cp_r = vmap(lambda t: cp0_R(self.mech, t))(T)
        cp_mass = torch.sum(Y * cp_r * R_GAS / self.W[None, :], dim=1)
        lam = vmap(lambda t, xx, c: thermal_conductivity(
            self.mech, self.tr, t, xx, c))(T, x, cp_r)
        D = vmap(lambda t, xx: mixture_diffusion_coeffs(
            self.mech, self.tr, t, self.P, xx))(T, x)
        mu = vmap(lambda t, xx: mixture_viscosity(
            self.mech, self.tr, t, xx))(T, x)
        return rho, cp_mass, lam, D, mu, x

    def rhs(self, t, state):
        n, K = self.n, self.mech.nspec
        Lam = state[0]
        s = state[1:].reshape(n, K + 2)
        V = s[:, 0]
        T = _clip(s[:, 1], 200.0, 4000.0)
        Y_raw = _clip(s[:, 2:], 0.0, 1.0)
        Y = Y_raw / _floor(torch.sum(Y_raw, dim=1, keepdim=True), 1e-12)
        rho, cp, lam, D, mu, x = self._props(T, Y)
        dzm, dzp = self._dzm, self._dzp

        # continuity: rho u(z) = mdot_f - 2 int_0^z rho V dz' (trapezoid)
        rv = rho * V
        seg = 0.5 * (rv[1:] + rv[:-1]) * (self.z[1:] - self.z[:-1])
        m = self.mdot_f - 2.0 * torch.cat(
            [torch.zeros_like(seg[:1]), torch.cumsum(seg, dim=0)])  # rho*u

        def ddz_signed(f):
            # upwind by the local flow direction (u changes sign at the
            # stagnation plane)
            fw = torch.cat([(f[1:2] - f[0:1]), f[1:] - f[:-1]]) \
                / _bcast(dzm, f)
            bw = torch.cat([f[1:] - f[:-1], (f[-1:] - f[-2:-1])]) \
                / _bcast(dzp, f)
            up = _bcast(m, f) >= 0
            return torch.where(up, fw, bw)

        conc = rho[:, None] * Y / self.W[None, :]
        wdot = vmap(lambda tt, cc: net_production_rates(
            self.kin, self.mech, tt, cc))(T, conc)

        # radial momentum
        dV = (-m * ddz_signed(V[:, None])[:, 0] - rho * V * V - Lam
              + _d2dz2(V[:, None], mu[:, None], dzp, dzm)[:, 0]) / rho
        # species
        dY = (-_bcast(m, Y) * ddz_signed(Y)
              + _d2dz2(Y, rho[:, None] * D, dzp, dzm)
              + wdot * self.W[None, :]) / rho[:, None]
        dY = dY + 1e2 * (Y - Y_raw)
        # energy
        h_mol = vmap(lambda tt: h0_RT(self.mech, tt))(T) \
            * R_GAS * T[:, None]
        q_chem = -torch.sum(h_mol * wdot, dim=1)
        dT = (-m * cp * ddz_signed(T[:, None])[:, 0]
              + _d2dz2(T[:, None], lam[:, None], dzp, dzm)[:, 0]
              + q_chem) / (rho * cp)

        # inlet BCs: fixed T/Y/V at both ends
        relax = 1e3
        dV = torch.cat([(-V[0] * relax)[None], dV[1:-1],
                        (-V[-1] * relax)[None]])
        dT = torch.cat([((self.T_fuel - T[0]) * relax)[None], dT[1:-1],
                        ((self.T_ox - T[-1]) * relax)[None]])
        dY = torch.cat([((self.Y_fuel - s[0, 2:]) * relax)[None], dY[1:-1],
                        ((self.Y_ox - s[-1, 2:]) * relax)[None]])
        # Lambda feedback on the far-end mass flux
        dLam = -self.kappa_L * (m[-1] - self.mdot_o)
        core = torch.cat([dV[:, None], dT[:, None], dY], dim=1)
        return torch.cat([dLam[None], core.reshape(-1)])

    def jacobian(self, t, state):
        return dense_jacobian(lambda v: self.rhs(t, v), state,
                              jvp_chunk(self.n, self.mech.nspec))

    def solve(self, state0, *, t_end=0.2, rtol=1e-5, atol=1e-8,
              max_steps=40000):
        res = bdf_solve(self.rhs, state0, 0.0, t_end, rtol=rtol, atol=atol,
                        max_steps=max_steps, jac=self.jacobian)
        r1 = float(torch.max(torch.abs(self.rhs(0.0, res.y))))
        return res, r1

    def unpack(self, state):
        """(Lambda, V, T, Y) from the flat state."""
        state = _host(state)
        s = state[1:].reshape(self.n, self.mech.nspec + 2)
        return float(state[0]), s[:, 0], s[:, 1], s[:, 2:]


class ImpingingJet(CounterflowDiffusionFlame):
    """Premixed jet against a stagnation wall (the reference's
    ImpingingJet: AxiStagnFlow + Surf1D wall domain).

    Same similarity equations as the counterflow flame; the far boundary
    is a solid wall instead of a second inlet: u(L) = 0 (the Lambda
    feedback target becomes zero mass flux), V(L) = 0, T(L) = T_wall,
    and zero species flux (dY/dz = 0)."""

    def __init__(self, mech: Mechanism, tr: TransportData, *, n_points=64,
                 width=0.01, pressure=101325.0, mdot=0.1,
                 T_inlet=300.0, T_wall=600.0, kappa_L=5e5, z=None,
                 device="cuda", dtype=torch.float64):
        super().__init__(mech, tr, n_points=n_points, width=width,
                         pressure=pressure, mdot_fuel=mdot, mdot_ox=0.0,
                         T_fuel=T_inlet, T_ox=T_wall, kappa_L=kappa_L, z=z,
                         device=device, dtype=dtype)
        self.mdot_o = 0.0               # stagnation wall: u(L) = 0

    def initial_profile(self, Y_in, *, T_hot=2000.0):
        """Premixed inlet everywhere + a hot layer near the wall to
        ignite the stagnation flame."""
        n = self.n
        zf = np.linspace(0.0, 1.0, n)
        Y_in = _host(Y_in)
        Y = np.tile(Y_in, (n, 1))
        T = self.T_fuel + (T_hot - self.T_fuel) * np.clip(
            (zf - 0.55) / 0.2, 0.0, 1.0)
        T[-1] = self.T_ox               # wall temperature
        self.Y_fuel = self._t(Y_in)
        self.Y_ox = self._t(Y_in)       # placeholder; wall is zero-flux
        core = np.concatenate([np.zeros((n, 1)), T[:, None], Y], axis=1)
        return self._t(np.concatenate([[0.0], core.reshape(-1)]))

    def rhs(self, t, state):
        out = super().rhs(t, state)
        # replace the far-end species BC: zero flux (dY/dz = 0) instead
        # of a prescribed oxidizer composition
        n, K = self.n, self.mech.nspec
        core = out[1:].reshape(n, K + 2)
        s = state[1:].reshape(n, K + 2)
        relax = 1e3
        last = torch.cat([core[-1, :2], (s[-2, 2:] - s[-1, 2:]) * relax])
        core = torch.cat([core[:-1], last[None]])
        return torch.cat([out[:1], core.reshape(-1)])
