"""Published peaks of the cards the benchmark runs on, keyed by the name
torch.cuda.get_device_name() gives: NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the card's full 700 W (a card set lower runs
slower: every share is printed beside the card's power.limit).

  hbm_Bps       HBM bandwidth, bytes/s (3.35 TB/s)
  f64_tc_flops  FP64 tensor-core rate (67 TFLOP/s): cuBLAS's f64 GEMMs
  f64_flops     FP64 outside the tensor cores (34 TFLOP/s)
  f32_flops     FP32 outside the tensor cores (67 TFLOP/s)
  tf32_flops    TF32 tensor-core rate (495 TFLOP/s)
  bf16_flops    BF16 tensor-core rate (989 TFLOP/s)
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_Bps": 3.35e12, "f64_tc_flops": 67e12, "f64_flops": 34e12,
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
    },
}

# the rate a configuration's precision is held to: its GEMMs' peak (float32
# with TF32 off, as the program sets it, runs outside the tensor cores)
MATMUL_PEAK = {"float64": "f64_tc_flops", "float32": "f32_flops",
               "bfloat16": "bf16_flops"}


def peak(device_name: str, precision: str):
    """(FLOP/s, bytes/s) of a card at a precision, or None where the
    table has no entry for the card."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return p[MATMUL_PEAK[precision]], p["hbm_Bps"]
