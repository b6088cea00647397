"""CLI entry point — the `CitcomSRegional <configfile>` equivalent
(citcoms/bin/Citcom.c:50-299 main; counterpart of
g4s_tpu/drivers/citcoms_regional.py): parse the flat config, run the
initial Stokes solve and the timestep loop, print each step's diagnostics
and the wall time per step.

Usage: python -m g4s_tpu_torch.drivers.citcoms_regional <configfile>
           [--steps N] [--f32] [--device cuda|cpu] [--restart ckpt]

Output files, checkpoints (and so `--restart`) and the graceful stop on
SIGINT/SIGTERM, which writes a checkpoint, wait for the port's output and
checkpoints (ROADMAP.md queue 1, item 4, "The CitcomS tail").
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--restart", default=None)
    ap.add_argument("--f32", action="store_true", help="run in f32")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from g4s_tpu_torch.models.citcoms import CitcomModel, load_config

    cfg = load_config(args.config)
    print(f"# G4S-TPU (torch) CitcomSRegional: "
          f"{cfg.nodex}x{cfg.nodey}x{cfg.nodez} Ra={cfg.rayleigh} "
          f"steps={cfg.maxstep} device={args.device}")
    model = CitcomModel(cfg, dtype=torch.float32 if args.f32
                        else torch.float64, device=args.device)
    t0 = time.perf_counter()
    s, hist = model.run(args.steps, verbose=True,
                        restart_from=args.restart)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n = len(hist)
    print(f"# total time {total:.3f} s; {total / max(n, 1):.4f} s/step "
          f"(incl. the initial solve)")
    return s, hist


if __name__ == "__main__":
    main()
