"""One NVT step in plain PyTorch: velocity Verlet with a Nose-Hoover chain
of three, the Martyna-Tuckerman-Klein update LAMMPS's `fix nvt` makes
(one Suzuki-Yoshida term, one chain cycle), in LAMMPS metal units
(A, ps, eV, g/mol), the integrator of DeePMD-kit's
examples/water/lmp/in.lammps.

The chain's masses are Q_0 = ndof kT tdamp^2 and Q_k = kT tdamp^2 with
ndof = 3N (the program counts no removed momentum; LAMMPS counts 3N - 3).
A half step of the chain, h = dt/2, updates xi from the chain's end
inward by h/2 with each xi scaled by exp(-xi_next h/4) on either side,
scales the velocities by exp(-xi_0 h), and goes back outward. Positions
are wrapped into the orthorhombic box [0, L).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

KB_EV = 8.617333262e-5            # Boltzmann constant, eV/K
F_OVER_M = 9648.53306             # (eV/A) / (g/mol) in A/ps^2
CHAIN = 3


class Thermostat(NamedTuple):
    T0: float                     # K
    tdamp: float                  # ps
    dt: float                     # ps
    masses: torch.Tensor          # (N,) g/mol
    L: torch.Tensor               # (3,) A


def temperature(masses, v):
    """Kinetic temperature with 3N degrees of freedom."""
    twice_ke = (masses[:, None] * v * v).sum() / F_OVER_M
    return twice_ke / (3 * masses.shape[0] * KB_EV)


def _chain_half(p: Thermostat, v, xi):
    kT = KB_EV * p.T0
    ndof = 3 * p.masses.shape[0]
    Q = [ndof * kT * p.tdamp ** 2] + [kT * p.tdamp ** 2] * (CHAIN - 1)
    h = p.dt / 2
    xi = list(xi.unbind(0))
    twice_ke = (p.masses[:, None] * v * v).sum() / F_OVER_M

    def force(k):
        if k == 0:
            return (twice_ke - ndof * kT) / Q[0]
        return (Q[k - 1] * xi[k - 1] ** 2 - kT) / Q[k]

    def update(k):
        if k == CHAIN - 1:
            xi[k] = xi[k] + force(k) * h / 2
        else:
            damp = torch.exp(-xi[k + 1] * h / 4)
            xi[k] = (xi[k] * damp + force(k) * h / 2) * damp

    for k in reversed(range(CHAIN)):
        update(k)
    scale = torch.exp(-xi[0] * h)
    v = v * scale
    twice_ke = twice_ke * scale * scale
    for k in range(CHAIN):
        update(k)
    return v, torch.stack(xi)


def step(p: Thermostat, force_fn, x, v, xi, f):
    """(x, v, xi, f) after one step from a state and its forces."""
    v, xi = _chain_half(p, v, xi)
    inv_m = F_OVER_M / p.masses[:, None]
    v = v + p.dt / 2 * f * inv_m
    x = x + p.dt * v
    x = x - p.L * torch.floor(x / p.L)
    f = force_fn(x)
    v = v + p.dt / 2 * f * inv_m
    v, xi = _chain_half(p, v, xi)
    return x, v, xi, f
