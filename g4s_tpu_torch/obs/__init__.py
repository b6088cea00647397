"""Stage timing (counterpart of g4s_tpu/obs)."""

from g4s_tpu_torch.obs.timings import Timings, device_ms  # noqa: F401
