"""From a torch.profiler trace of the measured window to the numbers the
per-layer readers take.

The profiler's raw events (prof.profiler.kineto_results.events()) are
read once into plain tuples; torch's own event tree is not built. A
device activity (kernel, copy, fill) carries the correlation id of the
innermost torch op that launched it, so an op's self device time is the
sum of its activities' durations, and its recorded input shapes give its
operations and bytes. CUPTI's overhead events ("Command Buffer Full",
where a launch waits for room in the queue) carry ids of another count
that can equal an op's, so every host event with an id gets the
activities of that id, as torch's own key_averages() gives them: an op's
time is never lost to an overhead event that shares its id.

  window      the host span `WINDOW` the harness opens around the
              measured loop; every interval is clipped to it
  busy_s      the union of the device activities' intervals in it
  gaps        the intervals of the window in which no activity runs,
              each named by what the host was doing at its midpoint:
              the harness's span on the main thread, then the innermost
              op open on any thread (the latest to start)
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


class Op(NamedTuple):
    name: str
    shapes: list
    device_ns: int


class Trace(NamedTuple):
    window: Tuple[int, int]                   # ns
    activities: List[Tuple[int, int, str]]    # (start, end, name), clipped
    ops: List[Op]                             # ops that ran on the device
    host: Dict[int, List[Tuple[int, int, str]]]   # thread -> events
    spans: List[Tuple[int, int, str]]         # the harness's, main thread

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def from_profile(prof) -> Trace:
    """A Trace of the events of a torch.profiler.profile that ran the
    harness's window."""
    from torch.autograd import DeviceType
    w = None
    device, host_ops, host, spans = [], [], defaultdict(list), []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX) \
                    and not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), name,
                               e.linked_correlation_id()))
            continue
        if name == WINDOW:
            w = (e.start_ns(), e.end_ns())
        elif name.startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name))
        else:
            host[e.start_thread_id()].append((e.start_ns(), e.end_ns(),
                                              name))
            if e.linked_correlation_id() == 0:
                host_ops.append((e.correlation_id(), name, e.shapes()))
    if w is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} span")
    return build(w, device, host_ops, host, spans)


def build(window, device, host_ops, host, spans) -> Trace:
    """A Trace from plain events: device (start, end, name, op id),
    host_ops [(op id, name, shapes)], host {thread: [(start, end, name)]}
    (torch ops and runtime calls), spans [(start, end, name)] (the
    harness's own, which do not nest)."""
    w0, w1 = window
    acts, dev_ns = [], defaultdict(int)
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        acts.append((s, e, name))
        dev_ns[corr] += e - s
    ops = [Op(name, shapes, dev_ns[corr]) for corr, name, shapes in host_ops
           if corr in dev_ns]
    acts.sort()
    host = {t: sorted(ev) for t, ev in host.items()}
    return Trace((w0, w1), acts, ops, host, sorted(spans))


def merged(trace: Trace) -> List[Tuple[int, int]]:
    out = []
    for s, e, _ in trace.activities:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in merged(trace)) / 1e9


def gaps(trace: Trace) -> List[Tuple[int, int]]:
    out, t = [], trace.window[0]
    for s, e in merged(trace):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        out.append((t, trace.window[1]))
    return out


def _innermost(events, at: int):
    """(start, name) of the innermost event open at time `at` in one
    thread's events (sorted by start), or None."""
    best = None
    hi = bisect.bisect_right(events, (at, float("inf"), ""))
    for s, e, name in reversed(events[max(0, hi - 256):hi]):
        if e > at and (best is None or s > best[0]):
            best = (s, name)
    return best


def gap_label(trace: Trace, at: int) -> str:
    i = bisect.bisect_right(trace.spans, (at, float("inf"), "")) - 1
    span = trace.spans[i][2] if i >= 0 and trace.spans[i][1] > at \
        else "harness"
    inner = None
    for events in trace.host.values():
        found = _innermost(events, at)
        if found and (inner is None or found[0] > inner[0]):
            inner = found
    return f"{span} > {inner[1] if inner else 'python'}"


def idle_by_host(trace: Trace, top: int = 10) -> List[list]:
    """[label, idle seconds] summed over the window's gaps by what the
    host was doing, the largest first."""
    total = defaultdict(int)
    for s, e in gaps(trace):
        total[gap_label(trace, (s + e) // 2)] += e - s
    return [[k, v / 1e9] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """[activity name, seconds] of the activities that took the most
    time in the window."""
    total = defaultdict(int)
    for s, e, name in trace.activities:
        total[name] += e - s
    return [[k[:160], v / 1e9] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def self_device_s(trace: Trace, op_name: str) -> float:
    return sum(op.device_ns for op in trace.ops
               if op.name == op_name) / 1e9


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def gemm_work(op: Op) -> Optional[Tuple[int, int]]:
    """(operations, elements read once and written once) of one GEMM op
    from its recorded input shapes."""
    sh = [list(s) for s in op.shapes]
    if op.name == "aten::mm":
        (m, k), (_, n) = sh[0], sh[1]
        b, extra = 1, 0
    elif op.name == "aten::addmm":
        (m, k), (_, n) = sh[1], sh[2]
        b, extra = 1, _numel(sh[0])
    elif op.name == "aten::bmm":
        (b, m, k), (_, _, n) = sh[0], sh[1]
        extra = 0
    elif op.name == "aten::baddbmm":
        (b, m, k), (_, _, n) = sh[1], sh[2]
        extra = _numel(sh[0])
    else:
        return None
    return 2 * b * m * n * k, b * (m * k + k * n + m * n) + extra


def gemm_roofline(trace: Trace, flops_peak: float, bytes_peak: float,
                  itemsize: int) -> Optional[dict]:
    """The GEMM ops' share of their roofline: the least time the card
    could take for their operations and bytes over their device time."""
    ops = flops = elems = 0
    ns = 0
    for op in trace.ops:
        work = gemm_work(op) if op.name in GEMM_OPS else None
        if work is None:
            continue
        ops += 1
        flops += work[0]
        elems += work[1]
        ns += op.device_ns
    if not ns:
        return None
    t_flops, t_bytes = flops / flops_peak, elems * itemsize / bytes_peak
    return {"share_pct": 100.0 * max(t_flops, t_bytes) / (ns / 1e9),
            "bound": "compute" if t_flops >= t_bytes else "memory",
            "ops": ops, "flops": flops, "bytes": elems * itemsize,
            "device_s": ns / 1e9}
