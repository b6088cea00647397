"""Traffic kind `infer`: what `dp test` and `dp model-devi` send over a
dataset. One client in a closed loop passes frames_per_call frames of
n_side^3 water molecules, as host numpy arrays, to DeepPot.eval, cycling
through pool_batches batches generated from the seed, and reads E, F and
the virial back to numpy before its next call.

Mix parameters: n_side, frames_per_call, pool_batches, warmup_calls.

End-to-end: frames_per_s, the frames whose E, F and W reached the host
over the whole window; eval_p95_ms, the 95th percentile of every call's
time from entering DeepPot.eval to its three arrays on the host.

The check: every call of the window, up to KEEP calls (past that, a
reservoir sample of KEEP drawn from the seed), against the reference's
E, F and W of its batch; each number is the largest over those calls,
scaled by the batch's largest reference magnitude.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import flops, frames, model
from portbench.harness import Window, span, timed

KEEP = 1024


class Inputs(NamedTuple):
    weights: dict
    stat_x: np.ndarray
    pool: list
    L: float
    box: np.ndarray
    types: np.ndarray


def inputs(cell, seed: int, device) -> Inputs:
    mix = cell.mix
    g = frames.rng(seed, "frames")
    pool = [frames.water_frames(g, mix["frames_per_call"], mix["n_side"])
            for _ in range(mix["pool_batches"])]
    L = frames.box_length(mix["n_side"])
    return Inputs(model.raw_weights(cell.config, seed, device),
                  model.stat_frames(cell.config, seed), pool, L,
                  np.tile(np.eye(3) * L, (mix["frames_per_call"], 1, 1)),
                  frames.types(mix["n_side"] ** 3))


def _errors(out, want) -> dict:
    return {k: float(np.abs(o - w).max() / np.abs(w).max())
            for k, o, w in zip(("e_rel", "f_rel", "w_rel"), out, want)}


class Runner:
    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.setup = {}
        with timed(self.setup, "inputs"):
            self.inp = inputs(cell, seed, self.device)
        with timed(self.setup, "stats_freeze_load"):
            self.pot = model.program_pot(cell.config, self.inp.weights,
                                         self.inp.stat_x, self.device)
        self.outputs, self.dropped = [], 0
        self.sample = frames.rng(seed, "sample")
        self.annotate = False
        with timed(self.setup, "warmup"):
            for i in range(cell.mix["warmup_calls"]):
                self._call(i)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, i: int):
        b = i % len(self.inp.pool)
        t0 = time.perf_counter()
        with span("portbench.eval", self.annotate):
            e, f, w = self.pot.eval(self.inp.pool[b], self.inp.box,
                                    self.inp.types)
        t1 = time.perf_counter()
        with span("portbench.read", self.annotate):
            out = (e.cpu().numpy(), f.cpu().numpy(), w.cpu().numpy())
        return b, out, t1 - t0, time.perf_counter() - t0

    def _keep(self, seen: int, item):
        if seen < KEEP:
            self.outputs.append(item)
            return
        self.dropped += 1
        j = int(self.sample.integers(0, seen + 1))
        if j < KEEP:
            self.outputs[j] = item

    def window(self, seconds: float, annotate: bool = False) -> Window:
        self.annotate = annotate
        self._sync()
        t_start = time.perf_counter()
        end = t_start + seconds
        lat, host, i = [], [], 0
        while True:
            b, out, h, total = self._call(i)
            self._keep(len(self.outputs) + self.dropped, (b, out))
            lat.append(total)
            host.append(h)
            i += 1
            if time.perf_counter() >= end:
                break
        t_end = time.perf_counter()
        n = self.cell.mix["frames_per_call"] * i
        per_frame = flops.model_flops(self.cell.config,
                                      len(self.inp.types))["own_type_only"]
        return Window(t_start, t_end - t_start, i,
                      {"frames_per_s": n / (t_end - t_start),
                       "eval_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                      {"calls": i, "frames": n}, {"host_call_s": host},
                      per_frame * n)

    def release(self):
        del self.pot
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log=None):
        ref = model.Reference(self.cell.config, self.inp.weights,
                              self.inp.stat_x, self.device)
        want = []
        for i, x in enumerate(self.inp.pool):
            E, F, W, info = ref.efv(x, self.inp.L, self.inp.types)
            want.append(tuple(t.cpu().numpy() for t in (E, F, W)))
            if log:
                log(f"infer batch {i}: reference max|F| "
                    f"{float(F.abs().max()):.4g} eV/A, closest pair "
                    f"{info['closest']:.4f} A, most neighbours "
                    f"{info['most']} of sel {list(ref.model.sel)}")
        worst = {"e_rel": 0.0, "f_rel": 0.0, "w_rel": 0.0}
        failed = 0
        for b, out in self.outputs:
            err = _errors(out, want[b])
            failed += any(v > self.cell.limits[k] for k, v in err.items())
            worst = {k: max(worst[k], err[k]) for k in worst}
        return worst, failed


def control(cell, seed: int, device, dtype=torch.float32) -> dict:
    """The check's numbers for the reference in `dtype` in the program's
    place, over every batch of the pool."""
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    hi = model.Reference(cell.config, inp.weights, inp.stat_x, device)
    lo = model.Reference(cell.config, inp.weights, inp.stat_x, device,
                         dtype=dtype)
    worst = {"e_rel": 0.0, "f_rel": 0.0, "w_rel": 0.0}
    for x in inp.pool:
        want = [t.cpu().numpy() for t in hi.efv(x, inp.L, inp.types)[:3]]
        got = [t.double().cpu().numpy()
               for t in lo.efv(x, inp.L, inp.types)[:3]]
        err = _errors(got, want)
        worst = {k: max(worst[k], err[k]) for k in worst}
    return worst
