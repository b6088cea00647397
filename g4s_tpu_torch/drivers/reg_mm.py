"""Regression driver for every SpGEMM strategy (counterpart of
g4s_tpu/drivers/reg_mm.py, the reference's planned `reg_` binaries).

Runs each strategy on the same inputs, checks each against the f64 dense
oracle, prints PASS/FAIL per strategy and exits 1 on any mismatch:

  plan    — two-phase symbolic/numeric       (hash-SpGEMM analog)
  csc     — column-wise via transposes       (heap-SpGEMM analog)
  blockN  — block ESC, when both inputs have a usable N x N block cover
  device  — expand/sort/merge on the device  (outer-SpGEMM analog)
  dense   — dense matmul                     (MKL-comparator analog)

Usage: python -m g4s_tpu_torch.drivers.reg_mm A.mtx [B.mtx]
       python -m g4s_tpu_torch.drivers.reg_mm --random N DENSITY [--seed S]
       (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from g4s_tpu_torch.ops.spgemm import (spgemm, spgemm_device_merge,
                                      spgemm_via_csc)
from g4s_tpu_torch.ops.spgemm_block import (block_c_to_scipy, block_cover,
                                            spgemm_block)
from g4s_tpu_torch.sparse import csr_to_dense, dense_to_csr
from g4s_tpu_torch.sparse.containers import as_numpy, resolve_device


def run(A, B, *, tol=1e-10, verbose=True, device="cuda") -> dict:
    """{strategy: (passed, max abs error)} against the f64 dense oracle,
    within tol * max(|oracle|, 1)."""
    device = resolve_device(device)
    oracle = csr_to_dense(A).astype(np.float64) \
        @ csr_to_dense(B).astype(np.float64)
    scale = max(np.abs(oracle).max(), 1.0)
    results = {}

    def check(name, c_csr=None, c_dense=None):
        if c_dense is None:
            c_dense = csr_to_dense(c_csr)
        err = float(np.abs(c_dense - oracle).max())
        ok = err <= tol * scale
        results[name] = (bool(ok), err)
        if verbose:
            print(f"  {name:8s} {'PASS' if ok else 'FAIL'}  max err "
                  f"{err:.3e}")
        return ok

    check("plan", spgemm(A, B, device=device))
    check("csc", spgemm_via_csc(A, B, device=device))
    # the block tier joins whenever the inputs carry a usable block cover
    for bs in (3, 2):
        if min(block_cover(A, bs), block_cover(B, bs)) >= 0.5:
            bp, cd = spgemm_block(A, B, bs, device=device)
            check(f"block{bs}", c_dense=block_c_to_scipy(bp, cd)
                  .toarray().astype(np.float64))
            break
    # device merge returns sorted (row*n+col) keys + merged values
    keys, vals, nnz = spgemm_device_merge(A, B, device=device)
    nnz = int(nnz)
    dm = np.zeros(A.shape[0] * B.shape[1])
    dm[as_numpy(keys)[:nnz]] = as_numpy(vals)[:nnz]
    check("device", c_dense=dm.reshape(A.shape[0], B.shape[1]))
    ad = torch.from_numpy(csr_to_dense(A)).to(device)
    bd = torch.from_numpy(csr_to_dense(B)).to(device)
    check("dense", c_dense=as_numpy(ad @ bd).astype(np.float64))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--random", nargs=2, type=float,
                    metavar=("N", "DENSITY"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from g4s_tpu_torch.drivers.mm_bench import load_pair
    if args.random:
        n, dens = int(args.random[0]), args.random[1]
        rng = np.random.default_rng(args.seed)
        M = (rng.random((n, n)) < dens) * rng.standard_normal((n, n))
        A = B = dense_to_csr(M)
    else:
        if not args.a:
            ap.error("need A.mtx or --random")
        A, B = load_pair(args.a, args.b)

    print(f"reg_mm: A {A.shape} nnz {A.nnz}, B {B.shape} nnz {B.nnz}")
    results = run(A, B, tol=args.tol, device=args.device)
    ok = all(v[0] for v in results.values())
    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
