"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,...
        --control-seeds 21,22,23 --seconds 5 [--out FILE]

For each of --seeds, a run of the program as the benchmark makes it (set-
up, a window of --seconds, the check) prints its numbers: the lower
readings. For each of --control-seeds, the reference in the next lower
precision below the configuration's (float32 for float64, TF32 off) in
the program's place prints its numbers: the upper readings. Each line is
a JSON object; --out also writes them all to FILE. The benchmark's own
runs never run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the next lower precision below a configuration's
LOWER = {"float64": "float32"}


def readings(cell_name: str, seeds, control_seeds, seconds: float, log):
    import torch

    from portbench import harness
    device = "cuda"
    cell = harness.load_cell(cell_name)
    lower = getattr(torch, LOWER[cell.config["precision"]])
    cell = cell._replace(limits={k: float("inf") for k in cell.limits})
    mod = harness.traffic_module(cell)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        runner = mod.Runner(cell, seed, device)
        win = runner.window(seconds)
        runner.release()
        numbers, _ = runner.check()
        del runner
        out.append({"side": "program", "seed": seed, "numbers": numbers,
                    "attempted": win.attempted,
                    "seconds": time.perf_counter() - t0})
        log(json.dumps(out[-1]))
    for seed in control_seeds:
        t0 = time.perf_counter()
        numbers = mod.control(cell, seed, device, dtype=lower)
        out.append({"side": "control", "seed": seed, "numbers": numbers,
                    "dtype": str(lower),
                    "seconds": time.perf_counter() - t0})
        log(json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from portbench import harness
    harness.pin_caches()

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                   args.seconds, log=lambda s: print(s, flush=True))
    for side in ("program", "control"):
        rows = [r["numbers"] for r in out if r["side"] == side]
        if rows:
            agg = max if side == "program" else min
            print(json.dumps({"side": side, "seeds": len(rows),
                              "reading": {k: agg(r[k] for r in rows)
                                          for k in rows[0]}}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
