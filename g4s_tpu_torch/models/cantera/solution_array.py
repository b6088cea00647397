"""Vectorized state container (counterpart of
g4s_tpu/models/cantera/solution_array.py; the reference's SolutionArray,
interfaces/cython/cantera/composite.py).

SolutionArray holds N thermodynamic states and evaluates properties for
all of them at once: every property is one batched torch evaluation over
the states (torch.func.vmap of the one-state thermo and kinetics), on the
array's device (`device=`, default "cuda") in f64.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from g4s_tpu_torch.models.cantera.kinetics import (build_kinetics,
                                                   net_production_rates)
from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.models.cantera.thermo import cp0_R, h0_RT, s0_R
from g4s_tpu_torch.sparse.containers import resolve_device

F64 = torch.float64


class SolutionArray:
    """states: TPX arrays — T (n,), P (n,), X (n, nspec)."""

    def __init__(self, mech: Mechanism, n: int | None = None, *,
                 T=None, P=None, X=None, device="cuda"):
        self.mech = mech
        self.device = resolve_device(device)
        dev = self.device

        def to(v):
            return torch.as_tensor(np.asarray(v, np.float64) if not
                                   torch.is_tensor(v) else v, dtype=F64,
                                   device=dev)

        self.kin = build_kinetics(mech, F64, device=dev)
        self.W = to(mech.mol_weights)
        if T is not None:
            T = torch.atleast_1d(to(T))
            n = T.shape[0]
        n = n or 1
        self.T = T if T is not None else torch.full((n,), 300.0, dtype=F64,
                                                    device=dev)
        P = torch.atleast_1d(to(P if P is not None else 101325.0))
        self.P = torch.broadcast_to(P, (n,))
        if X is None:
            X = torch.zeros((n, mech.nspec), dtype=F64, device=dev)
            X[:, 0] = 1.0
        else:
            X = torch.atleast_2d(to(X))
            X = torch.broadcast_to(X, (n, mech.nspec))
        self.X = X / torch.sum(X, dim=1, keepdim=True)

    def __len__(self):
        return self.T.shape[0]

    # -- thermodynamic properties (all (n,) or (n, nspec)) ---------------
    @property
    def mean_molecular_weight(self):
        return torch.sum(self.X * self.W, dim=1)

    @property
    def density(self):
        """Mass density, ideal gas (kg/m^3)."""
        return self.P * self.mean_molecular_weight / (R_GAS * self.T)

    @property
    def concentrations(self):
        """(n, nspec) mol/m^3."""
        ctot = self.P / (R_GAS * self.T)
        return self.X * ctot[:, None]

    @property
    def cp_mole(self):
        return vmap(lambda T, x: torch.sum(x * cp0_R(self.mech, T))
                    * R_GAS)(self.T, self.X)

    @property
    def enthalpy_mole(self):
        return vmap(lambda T, x: torch.sum(x * h0_RT(self.mech, T))
                    * R_GAS * T)(self.T, self.X)

    @property
    def entropy_mole(self):
        """Ideal mixture molar entropy incl. mixing + pressure terms."""
        def one(T, P, x):
            s0 = s0_R(self.mech, T) * R_GAS
            # the reference's clamp: a zero mole fraction adds 0, not NaN
            xs = torch.maximum(x, torch.full_like(x, 1e-300))
            return torch.sum(x * (s0 - R_GAS * torch.log(xs)
                                  - R_GAS * torch.log(P / 101325.0)))
        return vmap(one)(self.T, self.P, self.X)

    @property
    def net_production_rates(self):
        return vmap(lambda T, c: net_production_rates(
            self.kin, self.mech, T, c))(self.T, self.concentrations)

    # -- bulk operations --------------------------------------------------
    def equilibrate(self, mode: str = "TP"):
        """Equilibrate every state at constant T, P (ChemEquil role): the
        element-potential Newton on the host per state, its standard
        potentials on the array's device."""
        if mode != "TP":
            raise NotImplementedError("only TP equilibration")
        from g4s_tpu_torch.models.cantera.equilibrium import equilibrate_tp
        T, P, X = (v.cpu().numpy() for v in (self.T, self.P, self.X))
        X = np.stack([np.asarray(equilibrate_tp(
            self.mech, float(T[i]), float(P[i]), X[i], device=self.device))
            for i in range(len(self))])
        self.X = torch.as_tensor(X, dtype=F64, device=self.device)
        return self

    def __getattr__(self, name):
        # species mole-fraction accessor: sol("H2O") style instead; keep
        # attribute errors informative
        raise AttributeError(name)

    def __call__(self, species: str):
        """Mole fractions of one species across all states."""
        return self.X[:, self.mech.species_index(species)]
