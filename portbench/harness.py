"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json
gives its configuration (a file under configs/) and its traffic mix
(traffic/<mix>.json, whose "kind" names the module traffic/<kind>.py that
drives it); workloads/<cell>.json holds the limits of the numbers its
check compares; a per-layer metric is read by metrics/<metric>.py. The
metrics a cell reports are those BENCHMARK.json gives it.

A traffic module defines Runner(cell, seed, device), whose construction
is the set-up (weights, inputs, the program's model, warm-up), with
window(seconds, annotate) -> Window, release() and check(log) -> (numbers,
failed);
and control(cell, seed, device) -> numbers, the check's numbers for the
reference run in the next lower precision in the program's place.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "g4s_tpu")
TRACE_SECONDS = 5.0          # the traced run's windows, at most
SHAPES_SECONDS = 0.2         # the window whose op shapes are recorded
WARMUP_SLEEPS = 64           # device sleeps ahead of a traced window


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


class Window(NamedTuple):
    t_start: float                  # perf_counter at the first timed call
    seconds: float                  # its length, to the end of its work
    attempted: int                  # calls or steps
    metrics: Dict[str, float]       # the end-to-end metrics it measured
    counts: Dict[str, int]
    spans: Dict[str, List[float]]   # the harness's host spans, seconds
    model_flops: float              # the model FLOPs of the work done


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_file=ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; known: "
                       f"{', '.join(sorted(cells))}")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), load_json(ROOT / cfg_file),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "workloads" / f"{name}.json")["limits"],
                e2e, per_layer)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(cell: Cell):
    return load_module(HERE / "traffic" / f"{cell.mix['kind']}.py")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def timed(log: dict, key: str):
    """Adds the block's host seconds to log[key]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log[key] = log.get(key, 0.0) + time.perf_counter() - t0


def span(name: str, on: bool):
    """A host span the traced run records (nothing when off)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def card_state() -> str:
    """nvidia-smi's reading of the card: name, power limit and draw,
    clocks, temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Context(NamedTuple):
    """What a per-layer reader reads: the profiled window and its trace
    (CPU ops and device activities, no shapes), the untraced window run
    just before it (the harness's host spans without the profiler's
    cost), and the trace of a short window with the ops' input shapes
    recorded."""
    cell: Cell
    window: Window
    trace: object                   # tracing.Trace
    plain: Window
    shapes: object                  # tracing.Trace
    device_name: str
    peak: Optional[tuple]           # (FLOP/s, bytes/s) or None
    itemsize: int


def read_per_layer(ctx: Context, log) -> Dict[str, dict]:
    out = {}
    for m in ctx.cell.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is None:
            log(f"per-layer {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _profiled(runner, seconds: float, shapes: bool, on_card: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import tracing
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=shapes) as prof:
        if on_card:
            # the tracer can lose a profile's first activities: let
            # sleeps take that loss ahead of the window
            for _ in range(WARMUP_SLEEPS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with record_function(tracing.WINDOW):
            win = runner.window(seconds, annotate=True)
    t0 = time.perf_counter()
    trace = tracing.from_profile(prof)
    return win, trace, time.perf_counter() - t0


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
        started: float, log=None) -> dict:
    """One run; returns the result object. `started` is the process's
    start on the perf_counter clock."""
    import torch

    from portbench import model, peaks, tracing
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    mod = traffic_module(cell)
    log(f"process start to the Runner: {time.perf_counter() - started:.3f} s")
    runner = mod.Runner(cell, seed, device)
    if trace:
        plain = runner.window(min(seconds, TRACE_SECONDS))
        win, tr, reduce_s = _profiled(runner, min(seconds, TRACE_SECONDS),
                                      False, on_card)
        shapes = _profiled(runner, SHAPES_SECONDS, True, on_card)[1]
    else:
        plain = win = runner.window(seconds)
    setup_s = plain.t_start - started
    peak_mem = torch.cuda.max_memory_allocated() if on_card else 0
    name = torch.cuda.get_device_name() if on_card else "cpu"
    log(f"set-up: {json.dumps({k: round(v, 3) for k, v in runner.setup.items()})}")
    log(f"card: {card_state() if on_card else 'none (cpu)'}")
    log(f"window: {win.seconds:.6f} s, {win.attempted} attempted, "
        f"counts {json.dumps(win.counts)}, memory_peak_bytes {peak_mem}, "
        f"setup_s {setup_s:.6f}")
    if trace:
        log(f"untraced window before it: {plain.seconds:.6f} s, "
            f"{plain.attempted} attempted, {json.dumps(plain.metrics)}; "
            f"profile reduction {reduce_s:.3f} s")
    runner.release()
    t0 = time.perf_counter()
    numbers, failed = runner.check(log)
    log(f"check: {time.perf_counter() - t0:.3f} s")
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": win.attempted,
              "failed": failed}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak_mem)}
    if trace:
        ctx = Context(cell, win, tr, plain, shapes, name,
                      peaks.peak(name, cell.config["precision"]),
                      model.dtype_of(cell.config).itemsize)
        result["metrics"] = read_per_layer(ctx, log)
        dev["busy_s"] = tracing.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": tracing.device_ops(tr),
                               "idle_gaps": tracing.idle_by_host(tr)}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The check's numbers, each beside its limit, as the last lines of
    standard error, then the result as the last line of standard
    output."""
    print(f"correct: {result['correct']}, failed {result['failed']} of "
          f"{result['attempted']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
