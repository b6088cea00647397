"""G4S-TPU's graph engine ported to PyTorch and hand-written Hopper kernels.

The JAX package `g4s_tpu` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports neither `jax` nor
`g4s_tpu`.

  g4s_tpu_torch.sparse   — COO/CSR/CSC/ELL/SELL/DIA containers, .mtx IO,
                           host conversions
  g4s_tpu_torch.ops      — SpMV layouts, segment ops, the permute, WSELL-K
                           and BWELL kernels' wrappers, the streaming SpMV,
                           stream shifts, SpGEMM (two-phase, ESC, block
                           ESC), dense BLAS2, the variable-order BDF
  g4s_tpu_torch.engine   — build_graph / mxv / vxm / mxm dispatch,
                           operator forms, semirings, GAS
  g4s_tpu_torch.obs      — stage timings and the device timer
  g4s_tpu_torch.models   — workloads: the regional CitcomS step, the
                           DeePMD se_e2_a serving and training paths,
                           Cantera's zero-D NonIdealShockTube path
  g4s_tpu_torch.drivers  — the mm/ and mv/ benchmark and regression
                           drivers, the CitcomSRegional, dp and
                           shock_tube CLIs
  g4s_tpu_torch.kernels  — the nvcc build and ctypes loader of csrc/*.cu

Entry points take `device="cuda"` by default; pass device="cpu" to run on
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# The f32 correctness tier is 1e-6; TF32 keeps ~3 decimal digits, so matmuls
# and convolutions run in full fp32 (the counterpart of g4s_tpu/__init__.py
# setting jax_default_matmul_precision="highest").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from g4s_tpu_torch.sparse import COO, CSR, CSC, DIA, ELL, SELL  # noqa: F401,E402
