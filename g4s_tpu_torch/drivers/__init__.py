"""Benchmark and regression drivers of the mm/ and mv/ suites
(counterpart of g4s_tpu/drivers)."""
