"""Reactor networks: multiple reactors coupled by walls and flow devices
(counterpart of g4s_tpu/models/cantera/network.py).

Reference capability: cantera/src/zeroD — ReactorNet.cpp:253 eval (fan-out
of the global state vector to each reactor), Reactor.cpp:203 eval
(mass/energy/species RHS), Wall.cpp (heat flux Q = U A (T_left - T_right),
piston velocity v = K A (P_left - P_right)), and the flow devices
MassFlowController (fixed mdot) / Valve (mdot = Kv max(P_up - P_down, 0))
with Reservoir endpoints.

The whole network is ONE flat state vector
  y = concat_i [T_i, V_i, n_i (moles, nspec)]
whose RHS is evaluated for all reactors at once (kinetics under
torch.func.vmap) and integrated by the same variable-order BDF as the
single reactor: the network is a bigger stiff ODE, not an object graph
traversed per step. All reactors share one mechanism.

Energy accounting per reactor (ideal gas, adiabatic walls aside):
  dU/dt = -P dV/dt + sum_walls Q + sum_in mdot_in h_in - sum_out mdot_out h
with U = sum_k n_k u_k(T); solved for dT/dt.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import vmap

from g4s_tpu_torch.models.cantera.kinetics import (build_kinetics,
                                                   net_production_rates)
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.thermo import (_max0, cp0_R, h0_RT,
                                                 mech_tensor, u0_RT)
from g4s_tpu_torch.ops.odeint import bdf_solve
from g4s_tpu_torch.sparse.containers import resolve_device


@dataclasses.dataclass(frozen=True)
class Reservoir:
    """Fixed-state endpoint (zeroD/Reservoir.h): never integrates."""
    T: float
    P: float
    X: np.ndarray          # mole fractions (nspec,)

    def conc(self):
        X = np.asarray(self.X, np.float64)
        X = X / X.sum()
        return X * self.P / (R_GAS * self.T)


@dataclasses.dataclass(frozen=True)
class Wall:
    """Wall between reactors left/right (indices; -1..-n = reservoirs).

    Heat flux into LEFT:  Q = -U A (T_left - T_right)  (i.e. heat flows
    from hot to cold); piston: dV_left/dt = K A (P_left - P_right),
    dV_right/dt the negative (Wall.cpp vdot/Q sign conventions).
    """
    left: int
    right: int
    A: float = 1.0
    U: float = 0.0         # heat transfer coeff, W/m^2/K
    K: float = 0.0         # wall velocity coeff, m/s/Pa


@dataclasses.dataclass(frozen=True)
class MassFlowController:
    """Fixed mass flow upstream -> downstream (kg/s)."""
    upstream: int
    downstream: int
    mdot: float


@dataclasses.dataclass(frozen=True)
class Valve:
    """mdot = Kv * max(P_up - P_down, 0) (Valve.h)."""
    upstream: int
    downstream: int
    Kv: float


class ReactorNet:
    """N constant-volume-by-default ideal-gas reactors + couplings, with
    the state on `device` in float64.

    reactors: list of (T, P, X) initial states; reservoirs: list of
    Reservoir. In wall/flow endpoints, indices 0..N-1 name reactors and
    -1, -2, ... name reservoirs[0], reservoirs[1], ...
    """

    def __init__(self, mech: Mechanism, reactor_states: Sequence[tuple],
                 *, reservoirs: Sequence[Reservoir] = (),
                 walls: Sequence[Wall] = (),
                 flows: Sequence[object] = (),
                 energy: str = "on", device="cuda"):
        self.mech = mech
        self.device = resolve_device(device)
        self.dtype = torch.float64
        self.kin = build_kinetics(mech, self.dtype, device=self.device)
        self.nr = len(reactor_states)
        self.ns = mech.nspec
        self.walls = list(walls)
        self.flows = list(flows)
        self.reservoirs = list(reservoirs)
        self.energy = energy
        y0 = []
        for (T, P, X) in reactor_states:
            X = np.asarray(X, np.float64)
            X = X / X.sum()
            V = 1.0                        # reference volume; n scales with V
            n = X * P * V / (R_GAS * T)
            y0.append(np.concatenate([[T, V], n]))
        self.y0 = self._tensor(np.concatenate(y0))
        # reservoir states and fixed flows staged once
        self._res = [(self._tensor(r.T), self._tensor(r.P),
                      self._tensor(r.conc())) for r in self.reservoirs]
        self._mdot = [None if isinstance(f, Valve) else self._tensor(f.mdot)
                      for f in self.flows]

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    # -- state access -----------------------------------------------------
    def _split(self, y):
        blk = y.reshape(self.nr, 2 + self.ns)
        return blk[:, 0], blk[:, 1], blk[:, 2:]    # T (nr,), V (nr,), n

    def temperature(self, y, i: int):
        return self._split(y)[0][i]

    def volume(self, y, i: int):
        return self._split(y)[1][i]

    def pressure(self, y, i: int):
        T, V, n = self._split(y)
        return torch.sum(n[i]) * R_GAS * T[i] / V[i]

    def moles(self, y, i: int):
        return self._split(y)[2][i]

    def _endpoint_TPh(self, idx: int, T, V, n):
        """(T, P, conc) of a wall/flow endpoint: reactor or reservoir."""
        if idx < 0:
            return self._res[-idx - 1]
        ni = n[idx]
        return (T[idx], torch.sum(ni) * R_GAS * T[idx] / V[idx], ni / V[idx])

    # -- RHS --------------------------------------------------------------
    def rhs(self, t, y):
        T, V, n = self._split(y)
        conc = _max0(n) / V[:, None]

        wdot = vmap(lambda Ti, ci: net_production_rates(
            self.kin, self.mech, Ti, ci))(T, conc)      # (nr, ns)
        # per-reactor accumulators, added in the reference's order
        ndot = [wdot[i] * V[i] for i in range(self.nr)]
        Vdot = [torch.zeros((), dtype=y.dtype, device=y.device)] * self.nr
        Q = list(Vdot)                                   # heat in, W
        Hflux = list(Vdot)                               # enthalpy in, W

        P_all = torch.sum(_max0(n), dim=1) * R_GAS * T / V

        for w in self.walls:
            Tl, Pl, _ = self._endpoint_TPh(w.left, T, V, n)
            Tr_, Pr_, _ = self._endpoint_TPh(w.right, T, V, n)
            q = w.U * w.A * (Tl - Tr_)                  # left -> right
            vd = w.K * w.A * (Pl - Pr_)                 # left expands
            if w.left >= 0:
                Q[w.left] = Q[w.left] + -q
                Vdot[w.left] = Vdot[w.left] + vd
            if w.right >= 0:
                Q[w.right] = Q[w.right] + q
                Vdot[w.right] = Vdot[w.right] + -vd

        W = mech_tensor(self.mech, "mol_weights", y)
        for f, mdot in zip(self.flows, self._mdot):
            Tu, Pu, cu = self._endpoint_TPh(f.upstream, T, V, n)
            _, Pd, _ = self._endpoint_TPh(f.downstream, T, V, n)
            if isinstance(f, Valve):
                mdot = f.Kv * _max0(Pu - Pd)
            xu = cu / torch.sum(cu)
            Wu = torch.sum(xu * W)                      # upstream mean W
            nmol = mdot / Wu                            # mol/s
            h_u = torch.sum(xu * h0_RT(self.mech, Tu)) * R_GAS * Tu
            if f.upstream >= 0:
                ndot[f.upstream] = ndot[f.upstream] + -nmol * xu
                Hflux[f.upstream] = Hflux[f.upstream] + -nmol * h_u
            if f.downstream >= 0:
                ndot[f.downstream] = ndot[f.downstream] + nmol * xu
                Hflux[f.downstream] = Hflux[f.downstream] + nmol * h_u
        ndot = torch.stack(ndot)
        Vdot, Q, Hflux = torch.stack(Vdot), torch.stack(Q), torch.stack(Hflux)

        # energy: sum_k n_k cv_k dT/dt = -P Vdot + Q + Hflux - sum u_k ndot_k
        def dTdt(Ti, ni, Pi, Vdi, Qi, Hi, ndi):
            u = u0_RT(self.mech, Ti) * R_GAS * Ti       # (ns,)
            cv = (cp0_R(self.mech, Ti) - 1.0) * R_GAS
            C = torch.sum(_max0(ni) * cv)
            return (-Pi * Vdi + Qi + Hi - torch.dot(u, ndi)) / C

        dT = vmap(dTdt)(T, n, P_all, Vdot, Q, Hflux, ndot)
        if self.energy == "off":
            dT = torch.zeros_like(dT)
        return torch.reshape(
            torch.cat([dT[:, None], Vdot[:, None], ndot], dim=1), (-1,))

    # -- integration ------------------------------------------------------
    def advance(self, t_end, *, y0=None, rtol=1e-8, atol=1e-14,
                max_steps=200000, record_fn=None, record_size=20000):
        y0 = self.y0 if y0 is None else y0
        return bdf_solve(self.rhs, y0, 0.0, t_end, rtol=rtol, atol=atol,
                         max_steps=max_steps, record_fn=record_fn,
                         record_size=record_size)
