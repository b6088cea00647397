"""Stage timing and GFLOPS reporting (counterpart of the `Timings` class
of g4s_tpu/obs/timings.py, the reference SpGEMM suite's per-stage
milliseconds plus total GFLOPS), and the per-call device timer the
drivers use.

On a CUDA device a stage is timed by CUDA events recorded on the current
stream before and after it: the span runs until the device has finished
the stage's work, whether the host or the device was the slower. On the
CPU the host clock times it.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import OrderedDict
from typing import Dict, Optional

import torch

from g4s_tpu_torch.sparse.containers import resolve_device


class Timings:
    """Accumulates named stage durations; prints a Timings-style report."""

    def __init__(self, name: str = "", *, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.stages: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.record(name, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def report(self, *, flops: Optional[int] = None) -> str:
        lines = [f"=== Timings {self.name} ==="]
        for k, v in self.stages.items():
            lines.append(f"  {k:<12s} {v * 1e3:10.3f} ms")
        lines.append(f"  {'total':<12s} {self.total * 1e3:10.3f} ms")
        if flops is not None and self.total > 0:
            lines.append(f"  GFLOPS {flops / self.total / 1e9:10.3f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.stages)
        d["total"] = self.total
        return d


def device_ms(fn, *, device="cuda", reps: int = 30, warmup: int = 3,
              before=None) -> float:
    """Median time of one fn() call in ms, over `reps` back-to-back calls.

    On a CUDA device: a CUDA event pair around each call. Enqueueing one
    call can take the host longer than the device takes to run it, and an
    event pair around a call on an idle device then times the host; so the
    device first sleeps while the host queues every call and event, and if
    the device reached the first event before the host had queued them
    all, the batch is repeated with a longer sleep, and then with fewer
    calls: the device's launch queue holds about a thousand launches, and
    a host that queues more blocks until the device drains them.
    `before`, when given, runs ahead of each call outside its event pair:
    a cold-cache timing passes an L2 flush there. On the CPU: the host
    clock around each call."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    cycles = 1 << 26
    for _ in range(8):
        first = torch.cuda.Event()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        first.record()
        for start, end in pairs:
            if before is not None:
                before()
            start.record()
            fn()
            end.record()
        drained = first.query()
        torch.cuda.synchronize()
        if not drained:
            return statistics.median(a.elapsed_time(b) for a, b in pairs)
        if cycles < 1 << 30:
            cycles *= 4
        elif reps > 1:
            reps //= 2
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


# profiles the last device_activities call took (1 when its first held
# all of fn's activities)
PROFILE_TRIES = 0


def device_kernels(fn, *, tries: int = 10) -> list:
    """Names of the device activities (kernels, copies, fills) of one
    fn() call on the card, in order, as torch.profiler records them."""
    return [name for name, _ in device_activities(fn, tries=tries)]


def device_activities(fn, *, tries: int = 10) -> list:
    """(name, device µs) of each device activity (kernels, copies, fills)
    of one fn() call on the card, in order, as torch.profiler records them.

    The tracer can lose the first activities of a profile, more of them
    the longer the process has run (on an H100, 1 to 5 or more in the
    later phases of chip_smoke.py), or all of a profile's. So short device
    sleeps run before fn inside the same profile, 64 in the first profile
    and twice as many in each one taken again, and one runs after it; a
    profile counts only when fn's activities have a sleep before and after
    them, so that no loss reached them; they are returned without the
    sleeps. Any other profile is taken again, up to `tries` times, and
    PROFILE_TRIES holds how many profiles the last call took: each one
    runs fn again, so a profile of 10^5 kernels that is taken again costs
    tens of seconds."""
    global PROFILE_TRIES
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        PROFILE_TRIES = attempt + 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64 << attempt):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        # the profiler's raw events: prof.events() builds torch's event
        # tree over every CPU op too, minutes of host time for a profile of
        # 10^5 kernels
        events = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA),
                        key=lambda e: e.start_ns())
        names = [e.name() for e in events]
        marks = [i for i, n in enumerate(names) if "spin_kernel" in n]
        body = [i for i, n in enumerate(names) if "spin_kernel" not in n]
        if body and marks and marks[0] < body[0] and marks[-1] > body[-1]:
            return [(names[i], events[i].duration_ns() / 1e3) for i in body]
    raise RuntimeError(f"torch.profiler recorded no device activity of fn "
                       f"in {tries} profiles (the last: {len(events)} "
                       f"device activities, {len(marks)} of them markers)")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace of the block into logdir (obs.profile.trace):
    the analog of DeePMD's TF timeline profiling (deepmd trainer.py:407-408,
    859) and the SpGEMM suite's rdtsc probes; view it in chrome://tracing
    or Perfetto."""
    from g4s_tpu_torch.obs.profile import trace
    with trace(logdir):
        yield


class ConvergenceLog:
    """Per-iteration convergence reporting (CitcomS's
    print_convergence_progress lines, Stokes_flow_Incomp.c:129-148)."""

    def __init__(self, path=None):
        self.rows = []
        self.path = path

    def record(self, step: int, **metrics):
        self.rows.append((step, dict(metrics)))
        if self.path:
            with open(self.path, "a") as f:
                vals = " ".join(f"{k}={v:.6e}" for k, v in metrics.items())
                f.write(f"{step} {vals}\n")

    def last(self):
        return self.rows[-1] if self.rows else None
