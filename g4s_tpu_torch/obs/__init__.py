"""Stage timing, profiling and roofline accounting (counterpart of
g4s_tpu/obs)."""

from g4s_tpu_torch.obs.timings import (  # noqa: F401
    ConvergenceLog, Timings, device_ms, profile_trace,
)
from g4s_tpu_torch.obs.profile import (  # noqa: F401
    PEAKS, detect_platform, roofline, trace,
)
