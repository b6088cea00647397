"""Benchmark and regression drivers of the mm/ and mv/ suites, the
CitcomSRegional, dp and NonIdealShockTube (shock_tube) command lines
(counterpart of g4s_tpu/drivers), and static_spmv, the two per-matrix
WSELL-K probes of benchmarks/ as one command line."""
