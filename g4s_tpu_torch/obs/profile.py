"""Profiler hooks and roofline accounting (counterpart of
g4s_tpu/obs/profile.py).

  * `trace(logdir)` — context manager around torch.profiler that writes a
    Chrome trace of the block (CPU ops and, on a card, its kernels) into
    logdir;
  * `roofline(...)` — converts a measured kernel time plus its byte/flop
    footprint into achieved bandwidth/throughput and the fraction of the
    card's roofline, stating which resource bounds the kernel;
  * PEAKS — each card's published peaks, keyed by the name nvidia-smi and
    torch.cuda.get_device_name() give it: the roofline's denominators, and
    the ones chip_smoke.py's bounds use.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

# (HBM GB/s, dense bf16 tensor-core TFLOP/s, f32 TFLOP/s outside the tensor
# cores, f64 TFLOP/s outside the tensor cores), published for the H100 SXM
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "bf16_tflops": 989.0,
                              "f32_tflops": 67.0, "f64_tflops": 34.0},
}


def detect_platform() -> str:
    """The card's name as torch.cuda.get_device_name() gives it; raises
    when it has no entry in PEAKS (pass platform= to roofline then)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("detect_platform: no CUDA card; pass platform=")
    name = torch.cuda.get_device_name()
    if name not in PEAKS:
        raise RuntimeError(f"detect_platform: no peaks for {name!r} in "
                           f"PEAKS ({', '.join(PEAKS)}); pass platform=")
    return name


def roofline(*, seconds: float, bytes_moved: int = 0, flops: int = 0,
             dtype: str = "f32", platform: Optional[str] = None) -> dict:
    """Achieved vs peak for one measured kernel invocation.

    Returns a dict with achieved GB/s and GFLOP/s, the roofline fractions,
    and which resource binds ('memory' when arithmetic intensity is below
    the machine balance point, else 'compute')."""
    plat = platform or detect_platform()
    pk = PEAKS[plat]
    peak_flops = pk["bf16_tflops"] if dtype == "bf16" else pk["f32_tflops"]
    gbs = bytes_moved / seconds / 1e9 if bytes_moved else 0.0
    gfs = flops / seconds / 1e9 if flops else 0.0
    ai = flops / bytes_moved if bytes_moved else float("inf")
    balance = peak_flops * 1e3 / pk["hbm_gbs"]       # flop/byte
    return {
        "platform": plat,
        "seconds": seconds,
        "achieved_gbs": round(gbs, 2),
        "achieved_gflops": round(gfs, 2),
        "frac_hbm_roofline": round(gbs / pk["hbm_gbs"], 4),
        "frac_compute_roofline": round(gfs / (peak_flops * 1e3), 4),
        "arithmetic_intensity": round(ai, 3) if ai != float("inf") else None,
        "bound": "memory" if ai < balance else "compute",
    }


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler trace of the block, written as a Chrome trace
    (`trace_<pid>_<n>.json`) into logdir; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def timed(out: dict, key: str):
    """Wall-clock a block (device work must be synchronised by the
    caller)."""
    t0 = time.perf_counter()
    yield
    out[key] = time.perf_counter() - t0
