"""How far rounding alone moves the CitcomS full sphere's Stokes solves, in
the reference (g4s_tpu) and in the port (g4s_tpu_torch), both in f64 on
the CPU.

    python tests/citcoms_full_rounding_spread.py [--nodes 5 4] [--seeds 8]

At --nodes per cap (nodex = nodey, nodez; Ra = 1e5, radius_inner 0.55,
free slip, the temperature blob of tests/test_citcoms.py's full-sphere
step) it prints:

  1. the initial solve and one step run to tolerance in both packages,
     and for each seed the reference from T times (1 + 1e-15 e), e
     standard normal: Uzawa/CG counts and how far V, P and T move;
  2. at fixed caps (accuracy 0; Uzawa x CG iterations), the initial solve
     in the port from T and from T times (1 + 1e-15 e), and the port
     against the reference: where rounding starts to grow.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from g4s_tpu.models.citcoms import CitcomConfig as JCfg  # noqa: E402
from g4s_tpu.models.citcoms import full_driver as jfd  # noqa: E402
from g4s_tpu_torch.models.citcoms import (CitcomConfig,  # noqa: E402
                                          FullSphereModel, state_from_numpy)

CAPS = ((1, 10), (1, 20), (1, 40), (1, 60), (3, 60))


def rel(got, want) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def blob_T(model) -> np.ndarray:
    T0 = np.asarray(model.init_state().T)
    blob = np.exp(-np.sum((model._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                          axis=1) / 0.05)
    return np.clip(T0 + 0.3 * blob, 0, 1)


def wiggle(T, seed):
    return T * (1 + 1e-15 * np.random.default_rng(seed).standard_normal(
        T.shape))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs=2, default=(5, 4))
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    n, nz = args.nodes
    base = dict(nodex=n, nodey=n, nodez=nz, radius_inner=0.55,
                radius_outer=1.0, rayleigh=1e5, num_mat=1)

    # ---- 1: run to tolerance ----
    jm = jfd.FullSphereModel(JCfg(**base))
    pm = FullSphereModel(CitcomConfig(**base), device="cpu")
    T = blob_T(jm)

    def ref_run(TT):
        s, mon = jm.initial_solve(dataclasses.replace(
            jm.init_state(), T=jnp.asarray(TT)))
        s1, d = jm.step(s)
        return s, s1, (int(mon.outer_iterations), int(mon.inner_iterations),
                       int(d.uzawa_iterations), int(d.inner_iterations))

    js, js1, jc = ref_run(T)
    js0 = dataclasses.replace(jm.init_state(), T=jnp.asarray(T))
    ps, mon = pm.initial_solve(state_from_numpy(pm, {
        f.name: np.asarray(getattr(js0, f.name))
        for f in dataclasses.fields(js0)}))
    ps1, d = pm.step(ps)
    print(f"{n}x{n}x{nz} per cap, {pm.mesh.nel} elements; counts are "
          "initial Uzawa/CG, step Uzawa/CG")
    print(f"reference {jc}; port ({mon.outer_iterations}, "
          f"{mon.inner_iterations}, {d.uzawa_iterations}, "
          f"{d.inner_iterations}): V0 {rel(ps.V, js.V):.3g} "
          f"P0 {rel(ps.P, js.P):.3g} T1 {rel(ps1.T, js1.T):.3g} "
          f"V1 {rel(ps1.V, js1.V):.3g} P1 {rel(ps1.P, js1.P):.3g}")
    for seed in range(args.seeds):
        s, s1, c = ref_run(wiggle(T, seed))
        print(f"  reference, seed {seed}: {c} V0 {rel(s.V, js.V):.3g} "
              f"P0 {rel(s.P, js.P):.3g} T1 {rel(s1.T, js1.T):.3g} "
              f"V1 {rel(s1.V, js1.V):.3g} P1 {rel(s1.P, js1.P):.3g}")

    # ---- 2: fixed caps ----
    for uzawa, cg in CAPS:
        fixed = dict(base, accuracy=0.0, piterations=uzawa, vlowstep=cg)
        jmf = jfd.FullSphereModel(JCfg(**fixed))
        pmf = FullSphereModel(CitcomConfig(**fixed), device="cpu")
        V0 = torch.from_numpy(np.array(jmf.init_state().V))
        P0 = torch.zeros(pmf.mesh.nel, dtype=torch.float64)
        pV, pP, _ = pmf.stokes(torch.from_numpy(T), V0, P0)
        wV, wP, _ = pmf.stokes(torch.from_numpy(wiggle(T, 0)), V0, P0)
        jV, jP, _ = jmf.stokes(jnp.asarray(T), jnp.asarray(V0.numpy()),
                               jnp.zeros(pmf.mesh.nel))
        print(f"cap {uzawa} x {cg}: port moved by 1e-15 V {rel(wV, pV):.3g} "
              f"P {rel(wP, pP):.3g}; port against reference V "
              f"{rel(pV, jV):.3g} P {rel(pP, jP):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
