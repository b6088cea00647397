"""How far rounding alone moves the CitcomS Cookbook2 f64 trajectory, in the
reference (g4s_tpu) and in the port (g4s_tpu_torch), both on the CPU.

    python tests/citcoms_rounding_spread.py [--seeds 10] [--steps 3]

Prints four parts, at Cookbook2's 33x33x9 nodes (cookbook2.cfg):

  1. the initial Stokes solve in both packages (Uzawa/CG counts, how far
     V and P part), then two steps in each from the reference's state;
  2. the first inner CG solve of the initial solve on one right-hand side
     in both packages, cut at 10..40 iterations: how fast the two
     iterates part;
  3. for each seed, both packages run from the initial temperature times
     (1 + 1e-15 e), e standard normal: per-step counts and the largest
     relative error against benchmarks/cookbook2_blessed_f64.json;
  4. one port step from its solved state with every loop run to a fixed
     cap (accuracy 0, 3 Uzawa x 60 CG iterations, as chip_smoke.py's
     card-against-CPU check runs it): how far a 1e-15 change of T and V,
     and f32 arithmetic, move T, V and P.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from g4s_tpu.models.citcoms import CitcomModel as JModel  # noqa: E402
from g4s_tpu.models.citcoms import nodal as jnodal  # noqa: E402
from g4s_tpu.models.citcoms import observables as jobs  # noqa: E402
from g4s_tpu.models.citcoms import solvers as jsol  # noqa: E402
from g4s_tpu_torch.models.citcoms import (CitcomModel, assembly,  # noqa
                                          load_config, nodal, observables,
                                          solvers, state_from_numpy)

CFG = ROOT / "g4s_tpu_torch" / "models" / "citcoms" / "cookbook2.cfg"
BLESSED = ROOT / "benchmarks" / "cookbook2_blessed_f64.json"
KEYS = ("vrms", "nu_top", "nu_bot", "dt", "T_mean")


def rel(got, want) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def arrays(s) -> dict:
    return {f.name: np.asarray(getattr(s, f.name).cpu()
                               if isinstance(getattr(s, f.name), torch.Tensor)
                               else getattr(s, f.name))
            for f in dataclasses.fields(s)}


def counts(mon) -> tuple:
    it = getattr(mon, "outer_iterations", None)
    if it is None:
        it = mon.uzawa_iterations
    return int(it), int(mon.inner_iterations)


def blessed_err(model, obs, s, dt, blessed, k) -> float:
    got = {"vrms": obs.rms_velocity(model, s.V),
           "nu_top": obs.surface_heat_flux(model, s.T, top=True)[1],
           "nu_bot": obs.surface_heat_flux(model, s.T, top=False)[1],
           "dt": dt, "T_mean": s.T.mean()}
    return max(abs(float(got[n]) / blessed[n][k] - 1) for n in KEYS)


def shared_state(jm, pm):
    js, jmon = jm.initial_solve(jm.init_state())
    ps, mon = pm.initial_solve(pm.init_state())
    print(f"[1] initial solve: reference {counts(jmon)}, port {counts(mon)};"
          f" V {rel(ps.V, js.V):.3g}, P {rel(ps.P, js.P):.3g} apart",
          flush=True)
    ps = state_from_numpy(pm, arrays(js))
    for k in range(2):
        js, jd = jm.step(js)
        ps, d = pm.step(ps)
        print(f"[1] step {k + 1} from the reference's state: reference "
              f"{counts(jd)}, port {counts(d)}; T {rel(ps.T, js.T):.3g}, "
              f"V {rel(ps.V, js.V):.3g}, P {rel(ps.P, js.P):.3g}, "
              f"dt {rel(ps.dt, js.dt):.3g} apart", flush=True)


def first_cg(jm, pm):
    js, ps = jm.init_state(), pm.init_state()
    jo, po = jm._build_ops(js.T), pm._build_ops(ps.T)
    jprob = jsol.local_problem(jo, jm.nmass, jm.e_area, jm.total_volume)
    W = jnodal.build_stencil(jo.elt_k, jm.stencil_plan)
    jprob = jprob._replace(A=lambda u: jnodal.nodal_matvec(W, u,
                                                           jm.vbc_mask))
    pprob = solvers.local_problem(po, pm.nmass, pm.e_area, pm.total_volume)
    st = nodal.build_stencil(po.elt_k, pm.stencil_plan)
    pprob = pprob._replace(A=lambda u: nodal.nodal_matvec(st, u,
                                                          pm.vbc_mask))
    # the initial solve's first right-hand side: F - K V with V the lid
    F = assembly.assemble_forces(po, pm.N, pm.gda, pm.gweight, pm.cc,
                                 pm.buoyancy(ps.T))
    F1 = pprob.strip(F - pprob.A(ps.V))
    acc = 1e-4 * float(torch.linalg.vector_norm(F))
    for n in (10, 20, 25, 30, 35, 40):
        a = solvers.conj_grad(pprob, F1, torch.tensor(acc, dtype=F.dtype), n)
        b = jsol.conj_grad(jprob, jnp.asarray(F1.numpy()), acc, n)
        print(f"[2] first CG cut at {n}: x {rel(a.x, b.x):.3g}, residual "
              f"{rel(a.residual, b.residual):.3g} apart", flush=True)


def spread(jm, pm, seeds: int, steps: int, blessed):
    for name, m, obs in (("reference", jm, jobs), ("port", pm, observables)):
        worst = 0.0
        for seed in range(seeds):
            s = m.init_state()
            e = np.random.default_rng(seed).standard_normal(tuple(s.T.shape))
            e = jnp.asarray(e) if m is jm else torch.from_numpy(e)
            s, mon = m.initial_solve(dataclasses.replace(
                s, T=s.T * (1 + 1e-15 * e)))
            cs, errs = [counts(mon)], []
            for k in range(steps):
                s, d = m.step(s)
                cs.append(counts(d))
                errs.append(blessed_err(m, obs, s, d.dt, blessed, k))
            worst = max(worst, max(errs))
            print(f"[3] {name} seed {seed}: Uzawa/CG {cs}; largest rel. "
                  f"error per step {['%.3g' % x for x in errs]}", flush=True)
        print(f"[3] {name}: largest over {seeds} seeds {worst:.3g}",
              flush=True)


def fixed_count(cfg, pm):
    s, _ = pm.initial_solve(pm.init_state())
    fixed = dataclasses.replace(cfg, accuracy=0.0, piterations=3,
                                vlowstep=60)
    m64 = CitcomModel(fixed, device="cpu")
    m32 = CitcomModel(fixed, device="cpu", dtype=torch.float32)
    s0 = state_from_numpy(m64, arrays(s))
    x, d = m64.step(s0)
    e = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(s0.T.shape)))
    y, _ = m64.step(dataclasses.replace(s0, T=s0.T * (1 + 1e-15 * e),
                                        V=s0.V * (1 + 1e-15 * e[:, None])))
    z, _ = m32.step(state_from_numpy(m32, arrays(s)))
    for what, o in (("1e-15 change", y), ("f32", z)):
        print(f"[4] fixed {counts(d)} step, {what}: T {rel(o.T, x.T):.3g}, "
              f"V {rel(o.V, x.V):.3g}, P {rel(o.P, x.P):.3g}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    cfg = load_config(CFG)
    with open(BLESSED) as f:
        blessed = json.load(f)["trajectory"]
    jm, pm = JModel(cfg), CitcomModel(cfg, device="cpu")
    t0 = time.perf_counter()
    shared_state(jm, pm)
    first_cg(jm, pm)
    spread(jm, pm, args.seeds, args.steps, blessed)
    fixed_count(cfg, pm)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
