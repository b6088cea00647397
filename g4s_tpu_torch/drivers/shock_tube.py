"""NonIdealShockTube benchmark CLI (counterpart of
g4s_tpu/drivers/shock_tube.py).

Cantera's benchmark step `python NonIdealShockTube.py`
(cantera/interfaces/cython/cantera/examples/reactors/NonIdealShockTube.py):
single 1000 K / 40 atm ignition for the Redlich-Kwong and ideal phases
with per-case wall time, then optionally the 22-temperature NTC sweep.
The mechanism file must hold the phases `nDodecane_RK` and
`nDodecane_IG` (as nDodecane_Reitz.yaml does).

Usage: python -m g4s_tpu_torch.drivers.shock_tube --mech FILE [--sweep]
           [--temps T1,T2,...] [--rtol R] [--device cuda|cpu]

Runs on the CUDA card by default; without one it raises unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mech", required=True,
                    help="mechanism YAML with the phases nDodecane_RK and "
                         "nDodecane_IG")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--temps", default=None,
                    help="comma-separated sweep temperatures")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from g4s_tpu_torch.models.cantera import (NTC_TEMPERATURES,
                                              ShockTubeBenchmark)

    t0 = time.time()
    bench = ShockTubeBenchmark(args.mech, device=args.device)
    print(f"# mechanism loaded ({time.time() - t0:.1f} s): "
          f"{bench.mech_rk.nspec} species, {bench.mech_rk.nrxn} reactions")

    out = bench.run_single(1000.0, rtol=args.rtol, atol=1e-14)
    print(f"Real-gas ignition delay:  {out['tau_RG']*1e6:9.1f} us "
          f"({out['wall_RG']:.1f} s wall)")
    print(f"Ideal-gas ignition delay: {out['tau_IG']*1e6:9.1f} us "
          f"({out['wall_IG']:.1f} s wall)")

    if args.sweep or args.temps:
        temps = ([float(t) for t in args.temps.split(",")] if args.temps
                 else list(NTC_TEMPERATURES))
        t0 = time.time()
        res = bench.run_ntc_sweep(temps, rtol=args.rtol, atol=1e-14)
        print("#   T[K]   tau_RG[us]   tau_IG[us]")
        for T, rg, ig in zip(res["T"], res["tau_RG"], res["tau_IG"]):
            print(f"  {T:7.1f} {rg*1e6:11.1f} {ig*1e6:11.1f}")
        print(f"# sweep total {time.time() - t0:.1f} s "
              f"({len(temps)} temperatures x 2 phases)")
    return out


if __name__ == "__main__":
    main()
