"""NonIdealShockTube benchmark driver (counterpart of
g4s_tpu/models/cantera/shock_tube.py).

Re-implements Cantera's benchmark script
(cantera/interfaces/cython/cantera/examples/reactors/NonIdealShockTube.py):
stoichiometric n-dodecane/air at 40 atm in a constant-UV reactor, ignition
delay = time of peak OH (the script uses peak OH mass fraction, :40-42 —
at constant volume that is the peak OH concentration), run once at 1000 K
for the Redlich-Kwong and ideal phases (:77-148) and swept over the NTC
temperature range (:198-266), one case after another, or striped over the
ranks of a torch.distributed group (`run_ntc_sweep_sharded`, the script's
mpi4py `counter % nprocs == rank`), or all cases of a phase at once in
one lockstep batched BDF (`run_ntc_sweep_batched`, the reference's
jax.vmap).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.mech import Mechanism, load_mechanism
from g4s_tpu_torch.models.cantera.reactor import IdealGasConstVolumeReactor

NTC_TEMPERATURES = np.array(
    [1250, 1225, 1200, 1150, 1100, 1075, 1050, 1025, 1012.5, 1000, 987.5,
     975, 962.5, 950, 937.5, 925, 912.5, 900, 875, 850, 825, 800])


def stoich_mixture(mech: Mechanism, fuel: str = "c12h26", phi: float = 1.0,
                   o2_name: str = "o2", n2_name: str = "n2",
                   n2_per_o2: float = 3.76) -> np.ndarray:
    """Mole fractions for phi-equivalence fuel/air
    (set_equivalence_ratio semantics): nO2 = nC + nH/4 - nO/2 per fuel
    molecule, from the fuel's stored composition."""
    X = np.zeros(mech.nspec)
    i_f = mech.species_index(fuel)
    comp = mech.compositions[i_f]
    n_o2 = comp.get("C", 0.0) + comp.get("H", 0.0) / 4.0 \
        - comp.get("O", 0.0) / 2.0
    X[i_f] = phi
    X[mech.species_index(o2_name)] = n_o2
    X[mech.species_index(n2_name)] = n_o2 * n2_per_o2
    return X / X.sum()


def ignition_delay(reactor: IdealGasConstVolumeReactor, T0: float, P0: float,
                   X0: np.ndarray, *, t_end: float = 0.005,
                   rtol=1e-9, atol=1e-15, record_size: int = 20000):
    """One ignition-delay case: integrate, return (tau, result); tau is the
    recorded time of the largest recorded OH concentration."""
    y0 = reactor.initial_state(T0, P0, X0)
    res = reactor.advance(y0, t_end, rtol=rtol, atol=atol,
                          record_species="oh", record_size=record_size)
    oh = res.record[:, 1]
    tau = res.record_t[torch.argmax(oh)]
    return float(tau), res


class ShockTubeBenchmark:
    """The full NonIdealShockTube protocol over a mechanism file, both
    phases' reactors on `device`."""

    def __init__(self, mech_path, *, rk_phase: str = "nDodecane_RK",
                 ig_phase: str = "nDodecane_IG", fuel: str = "c12h26",
                 device="cuda"):
        self.mech_rk = load_mechanism(mech_path, rk_phase)
        self.mech_ig = load_mechanism(mech_path, ig_phase)
        self.fuel = fuel
        self.r_rk = IdealGasConstVolumeReactor(self.mech_rk, real_gas=True,
                                               device=device)
        self.r_ig = IdealGasConstVolumeReactor(self.mech_ig, real_gas=False,
                                               device=device)

    def run_single(self, T0: float = 1000.0, P0: float = 40 * 101325.0,
                   **kw):
        """Both phases at (T0, P0): the reference's taus and wall seconds,
        and each phase's BDFResult ("result_RG", "result_IG")."""
        X_rk = stoich_mixture(self.mech_rk, self.fuel)
        X_ig = stoich_mixture(self.mech_ig, self.fuel)
        t0 = time.time()
        tau_rg, res_rg = ignition_delay(self.r_rk, T0, P0, X_rk, **kw)
        t_rg = time.time() - t0
        t0 = time.time()
        tau_ig, res_ig = ignition_delay(self.r_ig, T0, P0, X_ig, **kw)
        t_ig = time.time() - t0
        return {"tau_RG": tau_rg, "tau_IG": tau_ig,
                "wall_RG": t_rg, "wall_IG": t_ig,
                "result_RG": res_rg, "result_IG": res_ig}

    def run_ntc_sweep(self, temperatures: Sequence[float] = NTC_TEMPERATURES,
                      P0: float = 40 * 101325.0, **kw):
        X_rk = stoich_mixture(self.mech_rk, self.fuel)
        X_ig = stoich_mixture(self.mech_ig, self.fuel)
        out = {"T": list(temperatures), "tau_RG": [], "tau_IG": []}
        for T0 in temperatures:
            out["tau_RG"].append(
                ignition_delay(self.r_rk, T0, P0, X_rk, **kw)[0])
            out["tau_IG"].append(
                ignition_delay(self.r_ig, T0, P0, X_ig, **kw)[0])
        return out

    def run_ntc_sweep_batched(self,
                              temperatures: Sequence[float] = NTC_TEMPERATURES,
                              P0: float = 40 * 101325.0, *,
                              t_end: float = 0.005,
                              rtol=1e-9, atol=1e-15,
                              record_size: int = 20000):
        """All NTC cases of one phase integrated together, as the
        reference's jax.jit(jax.vmap(bdf_solve)) does: one lockstep batched
        BDF (ops/odeint._bdf_solve_batched) per phase, every case a lane
        with its own t, h, order, Jacobian and LU on the reactors' device,
        recording (T, [OH]) at each accepted step; each lane's tau is its
        recorded time of peak OH. Cantera's script stripes the cases over
        MPI ranks instead (NonIdealShockTube.py:229-231). Returns {"T",
        "tau_RG", "tau_IG"} and, per phase, "result_*" (the batched
        BDFResult) and "wall_*" (seconds)."""
        from g4s_tpu_torch.ops.odeint import _bdf_solve_batched

        out = {"T": [float(t) for t in temperatures]}
        for name, mech, reactor in (("RG", self.mech_rk, self.r_rk),
                                    ("IG", self.mech_ig, self.r_ig)):
            t0 = time.time()
            X = stoich_mixture(mech, self.fuel)
            k_oh = mech.species_index("oh")
            y0 = torch.stack([reactor.initial_state(float(T0), P0, X)
                              for T0 in temperatures])
            res = _bdf_solve_batched(
                reactor.rhs, y0, 0.0, t_end, rtol=rtol, atol=atol,
                record_fn=lambda yy: torch.stack([yy[0], yy[1 + k_oh]]),
                record_size=record_size, max_steps=200000)
            peak = torch.argmax(res.record[:, :, 1], dim=1)
            taus = res.record_t.gather(1, peak[:, None])[:, 0]
            out[f"tau_{name}"] = [float(x) for x in taus.cpu()]
            out[f"result_{name}"] = res
            out[f"wall_{name}"] = time.time() - t0
        return out

    def run_ntc_sweep_sharded(self, group=None,
                              temperatures: Sequence[float] = NTC_TEMPERATURES,
                              P0: float = 40 * 101325.0, *,
                              t_end: float = 0.005, rtol=1e-9, atol=1e-15,
                              record_size: int = 20000):
        """The NTC sweep striped over the ranks of a torch.distributed
        group (None: the default group), the NonIdealShockTube.py:229-231
        rank striding (`if counter % nprocs == rank`): rank r integrates
        the cases i with i % world == r, one after another, each with
        ignition_delay for both phases, and the taus are all-gathered.
        There is no coupling between cases, so no padding of the case
        list. Returns {"T", "tau_RG", "tau_IG"} on every rank."""
        import torch.distributed as dist

        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        temps = [float(t) for t in temperatures]
        X_rk = stoich_mixture(self.mech_rk, self.fuel)
        X_ig = stoich_mixture(self.mech_ig, self.fuel)
        kw = dict(t_end=t_end, rtol=rtol, atol=atol, record_size=record_size)
        mine = np.zeros((2, len(temps)))
        for i in range(rank, len(temps), world):
            mine[0, i] = ignition_delay(self.r_rk, temps[i], P0, X_rk,
                                        **kw)[0]
            mine[1, i] = ignition_delay(self.r_ig, temps[i], P0, X_ig,
                                        **kw)[0]
        # NCCL moves device tensors only: the taus travel on the reactors'
        # device
        local = torch.as_tensor(mine, dtype=torch.float64,
                                device=self.r_rk.device)
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local, group=group)
        taus = torch.stack(parts).cpu().numpy()
        return {"T": temps,
                "tau_RG": [float(taus[i % world, 0, i])
                           for i in range(len(temps))],
                "tau_IG": [float(taus[i % world, 1, i])
                           for i in range(len(temps))]}
