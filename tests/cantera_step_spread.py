"""How far rounding alone moves the real-gas shock tube's BDF step counts,
in the reference (g4s_tpu) and in the port (g4s_tpu_torch), both in f64 on
the CPU.

    python tests/cantera_step_spread.py [--counts 45 190 7 7] [--eps ...]

On chip_smoke._synthetic_mechanism_yaml(..., seed=0) at --counts (species,
reactions, Troe falloff, three-body; 45/190/7/7 is the smallest that
ignites), the RK case at 1000 K and 40 atm (rtol 1e-8, atol 1e-14, to
5 ms) runs from T0 times (1 + eps) for each eps in both packages. Printed
per run: steps, RHS and Jacobian calls, tau, and the final state's
distance between the packages; then, for eps = 0, the accepted steps of
each package up to a few times, which shows where the two sequences part.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
jax.config.update("jax_enable_x64", True)

from chip_smoke import _synthetic_mechanism_yaml  # noqa: E402
from g4s_tpu.models.cantera import shock_tube as J  # noqa: E402
from g4s_tpu_torch.models.cantera import shock_tube as P  # noqa: E402

TIMES_MS = (1.0, 3.0, 3.7, 3.8, 3.85, 3.9, 4.0, 4.5, 5.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs=4, default=(45, 190, 7, 7))
    ap.add_argument("--eps", type=float, nargs="+",
                    default=(0.0, 1e-15, -1e-15, 3e-15))
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    nspec, nrxn, nfo, ntb = args.counts
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mech.yaml")
        _synthetic_mechanism_yaml(path, nspec=nspec, nrxn=nrxn,
                                  n_falloff=nfo, n_three_body=ntb, seed=0)
        jb = J.ShockTubeBenchmark(path)
        pb = P.ShockTubeBenchmark(path, device="cpu")
    X = P.stoich_mixture(pb.mech_rk)
    kw = dict(t_end=0.005, rtol=1e-8, atol=1e-14)
    for eps in args.eps:
        T0 = 1000.0 * (1 + eps)
        jtau, jres = J.ignition_delay(jb.r_rk, T0, 40 * 101325.0, X, **kw)
        ptau, pres = P.ignition_delay(pb.r_rk, T0, 40 * 101325.0, X, **kw)
        jy, py = np.asarray(jres.y), pres.y.numpy()
        print(json.dumps({
            "eps": eps,
            "reference_steps_fev_jev": [int(jres.steps), int(jres.n_fev),
                                        int(jres.n_jev)],
            "port_steps_fev_jev": [pres.steps, pres.n_fev, pres.n_jev],
            "tau_reference": jtau, "tau_port": ptau,
            "y_rel": float(np.abs(py - jy).max() / np.abs(jy).max())}),
            flush=True)
        if eps == 0.0:
            jt = np.asarray(jres.record_t)
            pt = pres.record_t.numpy()
            for ms in TIMES_MS:
                t = ms * 1e-3
                print(f"  accepted steps to {ms} ms: reference "
                      f"{int(((jt > 0) & (jt <= t)).sum())}, port "
                      f"{int(((pt > 0) & (pt <= t)).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
