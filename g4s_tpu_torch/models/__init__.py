"""Workload models ported from g4s_tpu.models: CitcomS and DeePMD."""
