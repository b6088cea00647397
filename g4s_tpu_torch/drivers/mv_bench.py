"""Dense matrix-vector benchmark driver, the reference's mv/ suite
(counterpart of g4s_tpu/drivers/mv_bench.py).

Protocol of the reference's mv driver: a Matrix-Market file (or a number)
fixes the dimension, a dense dim x dim matrix is filled with uniform
random values, and symv / trmv / packed-symmetric spmv / gemv are timed
(g4s_tpu_torch.ops.blas2). Each time is the median device time of one
call between back-to-back calls (obs.timings.device_ms).

Usage: python -m g4s_tpu_torch.drivers.mv_bench <matrix.mtx | dim> [reps]
       [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from g4s_tpu_torch.obs.timings import device_ms
from g4s_tpu_torch.ops.blas2 import (gemv, pack_symmetric, spmv_packed,
                                     symv, trmv)
from g4s_tpu_torch.sparse import read_mtx
from g4s_tpu_torch.sparse.containers import resolve_device


def run(dim_or_path, reps: int = 10, dtype=torch.float32, verbose=True,
        device="cuda") -> dict:
    """{name: ms per call} for dsymv, dtrmv, dspmv and dgemv."""
    device = resolve_device(device)
    try:
        dim = int(dim_or_path)
    except (TypeError, ValueError):
        dim = read_mtx(dim_or_path).shape[0]
    rng = np.random.default_rng(0)
    a_np = rng.random((dim, dim))
    a = torch.from_numpy(a_np).to(device, dtype)
    x = torch.from_numpy(rng.random(dim)).to(device, dtype)
    sym = np.triu(a_np) + np.triu(a_np, 1).T
    ap = torch.from_numpy(pack_symmetric(sym)).to(device, dtype)

    results = {}
    for name, kernel, mat in [("dsymv", symv, a), ("dtrmv", trmv, a),
                              ("dspmv", spmv_packed, ap), ("dgemv", gemv, a)]:
        ms = device_ms(lambda: kernel(mat, x), device=device, reps=reps)
        results[name] = ms
        if verbose:
            print(f"{name}: dim={dim} {ms:.4f} ms "
                  f"({2 * dim * dim / ms / 1e6:.1f} GFLOP/s)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", nargs="?", default="1024")
    ap.add_argument("reps", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.matrix, args.reps, device=args.device)


if __name__ == "__main__":
    main()
