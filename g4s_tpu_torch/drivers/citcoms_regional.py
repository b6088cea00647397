"""CLI entry point — the `CitcomSRegional <configfile>` equivalent
(citcoms/bin/Citcom.c:50-299 main; counterpart of
g4s_tpu/drivers/citcoms_regional.py): parse the flat config, run the
timestep loop with output every storage_spacing steps and checkpoints every
checkpoint_frequency steps (both into the config's datadir), print each
step's diagnostics and the wall time per step. SIGINT/SIGTERM request a
graceful stop: finish the current step, write a checkpoint, exit
(lib/Interuption.c set_signal semantics).

Usage: python -m g4s_tpu_torch.drivers.citcoms_regional <configfile>
           [--restart ckpt] [--f32] [--steps N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import signal
import time

_STOP = {"flag": False}


def _graceful(sig, frame):
    print(f"# caught signal {sig}: stopping after this step", flush=True)
    _STOP["flag"] = True


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
          f"steps={cfg.maxstep} device={args.device}", flush=True)
    model = CitcomModel(cfg, dtype=torch.float32 if args.f32
                        else torch.float64, device=args.device)
    _STOP["flag"] = False
    handlers = {sig: signal.signal(sig, _graceful)
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        t0 = time.perf_counter()
        s, hist = model.run(args.steps, verbose=True, write_output=True,
                            checkpoint=True, restart_from=args.restart,
                            stop_flag=lambda: _STOP["flag"])
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    n = len(hist)
    print(f"# total time {total:.3f} s; {total / max(n, 1):.4f} s/step "
          f"(incl. the initial solve)", flush=True)
    return s, hist


if __name__ == "__main__":
    main()
