"""Workload models ported from g4s_tpu.models: CitcomS, DeePMD and
Cantera's NonIdealShockTube path."""
