"""Benchmark and regression drivers of the mm/ and mv/ suites, and the
CitcomSRegional and dp command lines (counterpart of g4s_tpu/drivers)."""
