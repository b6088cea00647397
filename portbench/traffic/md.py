"""Traffic kind `md`: LAMMPS-style NVT molecular dynamics of a water box,
as DeePMD-kit's examples/water/lmp/in.lammps runs it (metal units,
masses, T0, tdamp, dt, thermo every thermo_every steps), in a box of
n_side^3 molecules. The loop calls NVTIntegrator.step with the force
function `water_md` gives it (energy_force_virial of the DeepPot's
parameters) and reads the temperature to the host every thermo_every
steps, as NVTIntegrator.run does.

Mix parameters: n_side, masses, T0, tdamp, dt, thermo_every,
warmup_steps, check_every, checks.

End-to-end: ns_per_day, the steps completed in the whole window times dt
over the window.

The check. The start: the program's forces at the generated positions,
and its warm-up steps from the generated state, against the reference's
own forces and steps. The window: a step of it is checked when its index
is 0 or first + j * check_every (first drawn from the seed in
[1, check_every]), up to `checks` steps; the reference takes one step
from the program's state before it and is compared with the program's
state after it (a step-by-step check: the reference cannot follow the
whole window in less time than the window). Numbers: x_abs_A, the largest position gap in A;
v_rel, the largest velocity gap over the largest reference speed
component; xi_tdamp, the largest gap of the chain's velocities times
tdamp; f_rel, the largest force gap over the largest reference force.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import flops, frames, model
from portbench.harness import Window, span, timed
from portbench.reference import nvt

CONTROL_STEPS = 2      # the control's steps past its warm-up


class Inputs(NamedTuple):
    weights: dict
    stat_x: np.ndarray
    x0: np.ndarray
    v0: np.ndarray
    L: float
    types: np.ndarray
    masses: np.ndarray


class State(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor
    xi: torch.Tensor


def inputs(cell, seed: int, device) -> Inputs:
    mix = cell.mix
    n = mix["n_side"]
    types = frames.types(n ** 3)
    masses = np.asarray(mix["masses"], np.float64)[types]
    return Inputs(model.raw_weights(cell.config, seed, device),
                  model.stat_frames(cell.config, seed),
                  frames.water_frame(frames.rng(seed, "frames"), n),
                  frames.velocities(frames.rng(seed, "velocities"), masses,
                                    mix["T0"], nvt.KB_EV, nvt.F_OVER_M),
                  frames.box_length(n), types, masses)


class Judge:
    """The reference's side of the check, in the configuration's
    precision: forces and steps, and the gaps of a state from them."""

    def __init__(self, cell, inp: Inputs, device, dtype=None):
        self.ref = model.Reference(cell.config, inp.weights, inp.stat_x,
                                   device, dtype=dtype)
        self.dtype, self.device = self.ref.dtype, device
        self.inp = inp
        self.tdamp = cell.mix["tdamp"]
        self.p = nvt.Thermostat(cell.mix["T0"], cell.mix["tdamp"],
                                cell.mix["dt"], self.t(inp.masses),
                                self.t(np.full(3, inp.L)))

    def t(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def force(self, x):
        _, f, _, self.info = self.ref.efv(x[None], self.inp.L,
                                          self.inp.types)
        return f[0]

    def step(self, s: State, f):
        x, v, xi, f = nvt.step(self.p, self.force, self.t(s.x), self.t(s.v),
                               self.t(s.xi), self.t(f))
        return State(x, v, xi), f

    def gaps(self, s: State, f, want: State, want_f) -> dict:
        def gap(a, b):
            return float((self.t(a) - b).abs().max())
        out = {"f_rel": gap(f, want_f) / float(want_f.abs().max())}
        if s is not None:
            out.update(x_abs_A=gap(s.x, want.x),
                       v_rel=gap(s.v, want.v) / float(want.v.abs().max()),
                       xi_tdamp=gap(s.xi, want.xi) * self.tdamp)
        return out


def judge_run(judge: Judge, f0, warm, samples, limits, log=None):
    """(largest gaps, checks failed) of a run: its forces at the start,
    its warm-up (state, forces) after each step from the start, and its
    sampled window steps (index, state before, forces before, state after,
    forces after). `log` gets each check's gaps beside the reference's
    largest force, closest pair and temperature."""
    inp = judge.inp
    worst = {"x_abs_A": 0.0, "v_rel": 0.0, "xi_tdamp": 0.0, "f_rel": 0.0}
    failed = 0

    def take(label, err, want, want_f):
        nonlocal failed, worst
        failed += any(v > limits[k] for k, v in err.items())
        worst = {k: max(worst[k], err.get(k, 0.0)) for k in worst}
        if log:
            T = float(nvt.temperature(judge.p.masses, want.v))
            log(f"md check {label}: "
                + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
                + f"; reference max|F| {float(want_f.abs().max()):.4g} "
                f"eV/A, closest pair {judge.info['closest']:.4f} A, "
                f"T {T:.1f} K")

    want = State(judge.t(inp.x0), judge.t(inp.v0),
                 torch.zeros(nvt.CHAIN, dtype=judge.dtype,
                             device=judge.device))
    want_f = judge.force(want.x)
    take("start", judge.gaps(None, f0, None, want_f), want, want_f)
    for i, (s, f) in enumerate(warm):
        want, want_f = judge.step(want, want_f)
        take(f"warm-up {i + 1}", judge.gaps(s, f, want, want_f), want,
             want_f)
    for k, s0, f0_, s1, f1 in samples:
        want, want_f = judge.step(s0, f0_)
        take(f"window step {k}", judge.gaps(s1, f1, want, want_f), want,
             want_f)
    return worst, failed


class Runner:
    def __init__(self, cell, seed: int, device):
        from g4s_tpu_torch.models.deepmd.md import NVTIntegrator
        from g4s_tpu_torch.models.deepmd.model import energy_force_virial
        self.cell, self.device = cell, torch.device(device)
        mix = cell.mix
        self.setup = {}
        with timed(self.setup, "inputs"):
            self.inp = inp = inputs(cell, seed, self.device)
        with timed(self.setup, "stats_freeze_load"):
            pot = model.program_pot(cell.config, inp.weights, inp.stat_x,
                                    self.device)
        dt = pot.dtype
        box = torch.eye(3, dtype=dt, device=self.device) * inp.L
        types = torch.as_tensor(inp.types, device=self.device)
        params, spec = pot.params, pot.spec

        def force_fn(x):
            return energy_force_virial(params, spec, x, box, types)[1]

        self.integ = NVTIntegrator(force_fn, inp.masses, np.eye(3) * inp.L,
                                   T0=mix["T0"], tdamp=mix["tdamp"],
                                   dt=mix["dt"], device=self.device,
                                   dtype=dt)
        with timed(self.setup, "warmup"):
            state, f = self.integ.initial_state(inp.x0, inp.v0)
            self.f0 = f
            self.warm = []
            for _ in range(mix["warmup_steps"]):
                state, f = self.integ.step(state, f)
                self.warm.append((state, f))
        self.state, self.f = state, f
        P = mix["check_every"]
        self.first = int(frames.rng(seed, "sample").integers(1, P + 1))
        self.samples = []
        self.temps = []
        self.steps = 0          # window steps before this window

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, annotate: bool = False) -> Window:
        mix = self.cell.mix
        P, every = mix["check_every"], mix["thermo_every"]
        state, f = self.state, self.f
        host, k = [], 0
        self._sync()
        t_start = time.perf_counter()
        end = t_start + seconds
        while time.perf_counter() < end:
            before = (state, f)
            t0 = time.perf_counter()
            with span("portbench.step", annotate):
                state, f = self.integ.step(state, f)
            host.append(time.perf_counter() - t0)
            if k == 0 or (k >= self.first and (k - self.first) % P == 0
                          and len(self.samples) < mix["checks"]):
                self.samples.append((self.steps + k,) + before
                                    + (state, f))
            k += 1
            if k % every == 0:
                with span("portbench.thermo", annotate):
                    self.temps.append(float(self.integ.temperature(state.v)))
        self._sync()
        t_end = time.perf_counter()
        self.state, self.f = state, f
        self.steps += k
        s = t_end - t_start
        per_step = flops.model_flops(self.cell.config,
                                     len(self.inp.types))["own_type_only"]
        return Window(t_start, s, k,
                      {"ns_per_day": k * mix["dt"] / s * 86400 / 1000},
                      {"steps": k, "checked": len(self.samples),
                       "thermo_reads": len(self.temps)},
                      {"host_step_s": host}, per_step * k)

    def release(self):
        del self.integ, self.state, self.f
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log=None):
        if log and self.temps:
            log(f"md thermo: T every {self.cell.mix['thermo_every']} "
                f"steps {[round(t, 2) for t in self.temps]} K")
        judge = Judge(self.cell, self.inp, self.device)
        return judge_run(judge, self.f0, self.warm, self.samples,
                         self.cell.limits, log)


def control(cell, seed: int, device, dtype=torch.float32) -> dict:
    """The check's numbers for the reference in `dtype` in the program's
    place: its forces at the start, its warm-up steps and CONTROL_STEPS
    steps after them, judged as the program's are."""
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    lo = Judge(cell, inp, device, dtype=dtype)
    s = State(lo.t(inp.x0), lo.t(inp.v0),
              torch.zeros(nvt.CHAIN, dtype=dtype, device=device))
    f0 = f = lo.force(s.x)
    warm, samples = [], []
    for _ in range(cell.mix["warmup_steps"]):
        s, f = lo.step(s, f)
        warm.append((s, f))
    for k in range(CONTROL_STEPS):
        s1, f1 = lo.step(s, f)
        samples.append((k, s, f, s1, f1))
        s, f = s1, f1
    limits = {k: float("inf") for k in ("x_abs_A", "v_rel", "xi_tdamp",
                                        "f_rel")}
    return judge_run(Judge(cell, inp, device), f0, warm, samples, limits)[0]
