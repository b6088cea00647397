"""Molecular-dynamics inference driver: the LAMMPS water benchmark
(counterpart of g4s_tpu/models/deepmd/md.py).

Replaces the reference's benchmark step `lmp -in in.lammps`
(deepmd/examples/water/lmp/in.lammps: metal units, periodic bulk water of
192 atoms, masses 16/2, velocities created at 330 K with seed 23456789,
Nose-Hoover NVT at 330 K with 0.5 ps damping, dt = 0.5 fs, 1000 steps,
thermo every 100) with a velocity-Verlet + Nose-Hoover chain loop whose
forces come from the se_e2_a model (the role of pair_deepmd +
DeepPot::compute). The loop runs eagerly with its state on the device;
forces come from autograd, the state update runs under no_grad.

Also includes a minimal LAMMPS data-file reader for water.lmp.
Units (metal): lengths A, energy eV, time ps, mass g/mol.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.sparse.containers import resolve_device

# metal units: [mass g/mol][distance A][time ps][energy eV]
# a = F[eV/A] / m[g/mol] * MVV2E ; kB in eV/K
KB_EV = 8.617333262e-5
# 1 eV/A / (1 g/mol) in A/ps^2:
F_OVER_M = 9648.53306


def read_lammps_data(path):
    """Minimal LAMMPS data reader (atomic style): returns coord (N,3),
    types (N,) 0-based, box (3,3)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n_atoms = None
    bounds = {}
    atoms_start = None
    for i, ln in enumerate(lines):
        s = ln.split("#")[0].strip()
        if s.endswith("atoms"):
            n_atoms = int(s.split()[0])
        for key in ("xlo", "ylo", "zlo"):
            if key in s:
                p = s.split()
                bounds[key[0]] = (float(p[0]), float(p[1]))
        if s.startswith("Atoms"):
            atoms_start = i + 2
    if not (n_atoms and atoms_start):
        raise ValueError(f"{path}: no atom count or Atoms section")
    rows = []
    for ln in lines[atoms_start:]:
        s = ln.split()
        if not s:
            if rows:
                break
            continue
        rows.append([float(v) for v in s[:5]])
    arr = np.asarray(rows)
    order = np.argsort(arr[:, 0])
    arr = arr[order]
    types = arr[:, 1].astype(np.int32) - 1
    coord = arr[:, 2:5]
    box = np.diag([bounds[d][1] - bounds[d][0] for d in "xyz"])
    return coord, types, box


def init_velocities(rng, masses, T0):
    """`velocity all create` semantics: Maxwell-Boltzmann at T0, zero net
    momentum, rescaled to exactly T0."""
    n = masses.shape[0]
    v = rng.normal(size=(n, 3)) * np.sqrt(KB_EV * T0 * F_OVER_M
                                          / masses[:, None])
    v -= (masses[:, None] * v).sum(axis=0) / masses.sum()
    ke = 0.5 * (masses[:, None] * v * v).sum() / F_OVER_M
    T_now = 2 * ke / (3 * n * KB_EV)
    return v * np.sqrt(T0 / T_now)


class MDState(NamedTuple):
    x: torch.Tensor      # (N, 3) positions
    v: torch.Tensor      # (N, 3) velocities
    xi: torch.Tensor     # (M,) thermostat chain velocities
    step: int


class NVTIntegrator:
    """Velocity-Verlet with a Nose-Hoover CHAIN thermostat (M=3), the
    integrator behind LAMMPS `fix nvt` (Martyna-Klein-Tuckerman update).
    A single Nose-Hoover is non-ergodic on near-harmonic systems; the
    chain fixes that. force_fn(x) -> F runs on `device` in `dtype`."""

    M_CHAIN = 3

    def __init__(self, force_fn, masses, box, *, T0=330.0, tdamp=0.5,
                 dt=0.0005, nve=False, device="cuda", dtype=torch.float64):
        self.force_fn = force_fn
        self.device = resolve_device(device)
        self.dtype = dtype
        self.masses = self._tensor(masses)
        self.box = self._tensor(box)
        self.box_inv = torch.linalg.inv(self.box)
        self.T0, self.tdamp, self.dt = T0, tdamp, dt
        self.nve = nve          # thermostat off: plain velocity Verlet
                                # (the energy-drift validation ensemble)
        self.n = masses.shape[0]
        self.ndof = 3 * self.n
        kT = KB_EV * T0
        Q = np.full(self.M_CHAIN, kT * tdamp ** 2)
        Q[0] = self.ndof * kT * tdamp ** 2
        self.Q = self._tensor(Q)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def temperature(self, v):
        ke = 0.5 * torch.sum(self.masses[:, None] * v * v) / F_OVER_M
        return 2 * ke / (self.ndof * KB_EV)

    def _nhc_half(self, v, vxi):
        """Half-step thermostat-chain update; returns (scaled v, vxi)."""
        M = self.M_CHAIN
        kT = KB_EV * self.T0
        dt2, dt4, dt8 = self.dt / 2, self.dt / 4, self.dt / 8
        Q = self.Q
        xi = list(vxi.unbind(0))
        ke2 = torch.sum(self.masses[:, None] * v * v) / F_OVER_M

        def G0(ke2_):
            return (ke2_ - self.ndof * kT) / Q[0]

        def Gk(k):
            return (Q[k - 1] * xi[k - 1] ** 2 - kT) / Q[k]

        xi[M - 1] = xi[M - 1] + Gk(M - 1) * dt4
        for k in range(M - 2, 0, -1):
            e = torch.exp(-xi[k + 1] * dt8)
            xi[k] = (xi[k] * e + Gk(k) * dt4) * e
        e = torch.exp(-xi[1] * dt8)
        xi[0] = (xi[0] * e + G0(ke2) * dt4) * e

        scale = torch.exp(-xi[0] * dt2)
        v = v * scale
        ke2 = ke2 * scale * scale

        e = torch.exp(-xi[1] * dt8)
        xi[0] = (xi[0] * e + G0(ke2) * dt4) * e
        for k in range(1, M - 1):
            e = torch.exp(-xi[k + 1] * dt8)
            xi[k] = (xi[k] * e + Gk(k) * dt4) * e
        xi[M - 1] = xi[M - 1] + Gk(M - 1) * dt4
        return v, torch.stack(xi)

    @torch.no_grad()
    def step(self, state: MDState, f):
        """One step from (state, its forces f) -> (next state, its forces)."""
        m = self.masses[:, None]
        dt = self.dt
        if self.nve:
            v, vxi = state.v, state.xi
        else:
            v, vxi = self._nhc_half(state.v, state.xi)
        v = v + dt / 2 * f / m * F_OVER_M
        x = state.x + dt * v
        frac = x @ self.box_inv
        x = (frac - torch.floor(frac)) @ self.box
        f_new = self.force_fn(x)
        v = v + dt / 2 * f_new / m * F_OVER_M
        if not self.nve:
            v, vxi = self._nhc_half(v, vxi)
        return MDState(x, v, vxi, state.step + 1), f_new

    def initial_state(self, x0, v0):
        """(state at step 0, its forces)."""
        x0, v0 = self._tensor(x0), self._tensor(v0)
        return (MDState(x0, v0, torch.zeros(self.M_CHAIN, dtype=self.dtype,
                                            device=self.device), 0),
                self.force_fn(x0))

    def run(self, x0, v0, n_steps: int, *, thermo_every: int = 100,
            energy_fn=None, verbose=True):
        state, f = self.initial_state(x0, v0)
        log = []
        t0 = time.time()
        for i in range(n_steps):
            state, f = self.step(state, f)
            if (i + 1) % thermo_every == 0 or i == 0:
                T = float(self.temperature(state.v))
                pe = float(energy_fn(state.x)) if energy_fn else float("nan")
                log.append((i + 1, T, pe))
                if verbose:
                    print(f"step {i+1}: T={T:.1f} K  pe={pe:.4f} eV "
                          f"({(time.time()-t0)/(i+1)*1e3:.1f} ms/step)")
        return state, log


def water_md(params, spec, *, data_file, n_steps=1000, seed=23456789,
             verbose=True, dtype=torch.float64, ensemble="nvt",
             device="cuda"):
    """The full water-MD benchmark from a model's params on `device`.

    data_file: the LAMMPS data file (water.lmp); the port has no default.
    ensemble="nvt": the reference protocol (examples/water/lmp/
    in.lammps:15,27 — 1000-step fix nvt at 330 K).
    ensemble="nve": thermostat off, for the energy-drift validation
    (log pe column + kinetic energy give the conserved E)."""
    from g4s_tpu_torch.models.deepmd.model import (energy_force_virial,
                                                   params_to, total_energy)
    device = resolve_device(device)
    params = params_to(params, device=device, dtype=dtype)
    coord, types_np, box_np = read_lammps_data(data_file)
    types = torch.as_tensor(types_np, dtype=torch.int64, device=device)
    box = torch.as_tensor(box_np, dtype=dtype, device=device)
    masses = np.where(types_np == 0, 16.0, 2.0)  # in.lammps mass 1 16/2 2

    def force_fn(x):
        return energy_force_virial(params, spec, x, box, types)[1]

    @torch.no_grad()
    def energy_fn(x):
        return total_energy(params, spec, x, box, types)

    rng = np.random.default_rng(seed)
    v0 = init_velocities(rng, masses, 330.0)
    integ = NVTIntegrator(force_fn, masses, box_np, nve=(ensemble == "nve"),
                          device=device, dtype=dtype)
    return integ.run(coord, v0, n_steps, energy_fn=energy_fn,
                     verbose=verbose)
