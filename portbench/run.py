"""The benchmark's command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

run from the root of a checkout. It exits non-zero and prints no result
where there is no CUDA card or fewer than the cell asks for, where the
program cannot be imported, or where JAX or the JAX package has been
loaded by the time the window has closed. Otherwise the last line of
standard output is the result object (see README.md).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED -= _age()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    harness.pin_caches()
    cell = harness.load_cell(args.workload)
    t0 = time.perf_counter()
    import torch
    print(f"import torch: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process has loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
