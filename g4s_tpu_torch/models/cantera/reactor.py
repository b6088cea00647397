"""Zero-D reactors (counterpart of g4s_tpu/models/cantera/reactor.py).

Reference: cantera/src/zeroD — Reactor::eval (Reactor.cpp:203: mass/energy/
species ODE RHS calling getNetProductionRates at :222) integrated by
ReactorNet/CVodesIntegrator (ReactorNet.cpp:210 step -> CVode). Here the
reactor is a constant-volume adiabatic vessel (what `ct.Reactor` +
`ReactorNet.step()` does in the NonIdealShockTube driver) whose RHS is plain
torch and whose integrator is the port's BDF (g4s_tpu_torch.ops.odeint).

State vector: y = [T, c_1 .. c_K] with c in mol/m^3 (constant volume, so
concentrations are the natural species variables). The energy equation is
derived by autodiff of the volumetric internal energy U(T, c):
  dU/dt = 0  =>  dT/dt = -(dU/dc . cdot) / (dU/dT)
which handles ideal and Redlich-Kwong phases identically — the real-gas
departure (RedlichKwongMFTP) simply changes U. dU/dT and dU/dc come from
torch.func.grad, which nests under the integrator's jacfwd.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad

from g4s_tpu_torch.models.cantera.kinetics import (build_kinetics,
                                                   net_production_rates)
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.thermo import (GasState, _max0,
                                                 as_scalar, cp0_R, h0_RT,
                                                 mech_tensor,
                                                 pr_molar_volume,
                                                 rk_molar_volume, u0_RT)
from g4s_tpu_torch.ops.odeint import bdf_solve
from g4s_tpu_torch.sparse.containers import resolve_device


class IdealGasConstVolumeReactor:
    """Constant-volume adiabatic reactor; works for RK and PR phases too
    (real_gas=True) via the departure-function energy. State lives on
    `device` in float64."""

    def __init__(self, mech: Mechanism, *, real_gas: bool = False,
                 device="cuda"):
        self.mech = mech
        self.device = resolve_device(device)
        self.dtype = torch.float64
        self.kin = build_kinetics(mech, self.dtype, device=self.device)
        self.gas = GasState(mech, real_gas=real_gas)
        self.real_gas = self.gas.real_gas

    # -- state setup ------------------------------------------------------
    def initial_state(self, T, P, X):
        """y0 from temperature, pressure, mole fractions (TPX).

        For the RK phase the molar volume solves the cubic EoS on the
        reactor's device — the real-gas density difference that drives the
        benchmark's RK vs ideal ignition-delay gap.
        """
        X = np.asarray(X, np.float64)
        X = X / X.sum()
        if self.real_gas:
            solve_v = pr_molar_volume if self.gas._is_pr else rk_molar_volume
            x = torch.as_tensor(X, dtype=self.dtype, device=self.device)
            v = float(solve_v(self.mech, as_scalar(float(T), x),
                              as_scalar(float(P), x), x))
        else:
            v = R_GAS * float(T) / float(P)
        conc = X / v
        return torch.as_tensor(np.concatenate([[float(T)], conc]),
                               dtype=self.dtype, device=self.device)

    # -- energy -----------------------------------------------------------
    def _U_vol(self, T, conc):
        """Internal energy per unit volume (J/m^3)."""
        u_ig = u0_RT(self.mech, T) * R_GAS * T
        U = torch.sum(conc * u_ig)
        if self.real_gas:
            ntot = torch.sum(conc)
            x = conc / ntot
            u_dep, _ = self.gas._eos_departures(T, 1.0 / ntot, x)
            U = U + ntot * u_dep
        return U

    # -- RHS --------------------------------------------------------------
    def rhs(self, t, y):
        T = y[0]
        conc = _max0(y[1:])
        cdot = net_production_rates(self.kin, self.mech, T, conc)
        dU_dT, dU_dc = grad(self._U_vol, argnums=(0, 1))(T, conc)
        dT = -torch.dot(dU_dc, cdot) / dU_dT
        return torch.cat([dT[None], cdot])

    # -- integration ------------------------------------------------------
    def advance(self, y0, t_end, *, rtol=1e-9, atol=1e-15,
                record_species=None, record_size=20000, max_steps=200000):
        """Integrate to t_end; optionally record (T, c_species) history at
        every accepted internal step (the ReactorNet.step() protocol)."""
        rec = None
        if record_species is not None:
            k = self.mech.species_index(record_species)

            def rec(y):
                return torch.stack([y[0], y[1 + k]])
        y0 = torch.as_tensor(y0, dtype=self.dtype, device=self.device)
        return bdf_solve(self.rhs, y0, 0.0, float(t_end), rtol=rtol,
                         atol=atol, max_steps=max_steps, record_fn=rec,
                         record_size=record_size)

    # -- observables ------------------------------------------------------
    def pressure(self, y):
        return self.gas.pressure(y[0], _max0(y[1:]))

    def temperature(self, y):
        return y[0]

    def mass_fractions(self, y):
        conc = _max0(y[1:])
        W = mech_tensor(self.mech, "mol_weights", conc)
        rho = torch.sum(conc * W)
        return conc * W / rho


class IdealGasConstPressureReactor(IdealGasConstVolumeReactor):
    """Constant-pressure adiabatic reactor (zeroD
    IdealGasConstPressureReactor): state y = [T, x_k (mole fractions)]
    at fixed P; the energy equation closes on enthalpy,
        sum_k n_k cp_k dT/dt = - sum_k h_k dn_k/dt   (per mole basis)
    and concentrations follow from the ideal-gas state c = x P/(R T).
    Ideal gas only (the RK/PR benchmark path is constant-volume).
    """

    def __init__(self, mech: Mechanism, *, pressure: float = 101325.0,
                 device="cuda"):
        super().__init__(mech, real_gas=False, device=device)
        self.P = pressure

    def initial_state(self, T, P, X):
        self.P = float(P)
        X = np.asarray(X, np.float64)
        X = X / X.sum()
        return torch.as_tensor(np.concatenate([[float(T)], X]),
                               dtype=self.dtype, device=self.device)

    def _conc(self, T, x):
        return x * (self.P / (R_GAS * T))

    def rhs(self, t, y):
        T = y[0]
        x = _max0(y[1:])
        x = x / torch.sum(x)
        conc = self._conc(T, x)
        wdot = net_production_rates(self.kin, self.mech, T, conc)
        ctot = torch.sum(conc)
        # per mole of mixture: dx/dt from dn/dt at constant P
        xdot_raw = wdot / ctot
        xdot = xdot_raw - x * torch.sum(xdot_raw)
        h = h0_RT(self.mech, T) * R_GAS * T
        cp = torch.sum(x * cp0_R(self.mech, T)) * R_GAS
        dT = -torch.dot(h, wdot) / (ctot * cp)
        return torch.cat([dT[None], xdot])

    def pressure(self, y):
        return torch.as_tensor(self.P, dtype=y.dtype, device=y.device)

    def temperature(self, y):
        return y[0]

    def mole_fractions(self, y):
        x = _max0(y[1:])
        return x / torch.sum(x)
