"""Workload models ported from g4s_tpu.models (CitcomS so far)."""
