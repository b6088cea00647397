"""Loader of the hand-written Hopper kernels in g4s_tpu_torch/csrc/."""
