"""SpGEMM benchmark driver, the reference's mm/ suite (counterpart of
g4s_tpu/drivers/mm_bench.py).

Protocol of the reference's mkl_spgemm driver: load A (and B) from
Matrix-Market, crop on a dimension mismatch, count flops, warm up, time N
iterations and print per-stage Timings + GFLOPS. Strategies:

  plan    — two-phase host symbolic / device numeric (the hash-SpGEMM
            analog; the symbolic phase amortizes across numeric reps)
  device  — expand/sort/merge on the device (the outer-product analog)
  dense   — dense matmul baseline (the MKL-comparator role)

Usage: python -m g4s_tpu_torch.drivers.mm_bench A.mtx [B.mtx] [--reps N]
       python -m g4s_tpu_torch.drivers.mm_bench --random N DENSITY
       (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse

import torch

from g4s_tpu_torch.obs.timings import Timings, device_ms
from g4s_tpu_torch.ops.spgemm import (spgemm_device_merge, spgemm_flops,
                                      spgemm_numeric, spgemm_plan)
from g4s_tpu_torch.sparse import CSR, crop, csr_to_dense, read_mtx_csr
from g4s_tpu_torch.sparse.containers import resolve_device


def load_pair(a_path, b_path=None):
    A = read_mtx_csr(a_path)
    B = read_mtx_csr(b_path) if b_path else A
    if A.shape[1] != B.shape[0]:     # crop like the reference driver
        d = min(A.shape[1], B.shape[0])
        A = crop(A, A.shape[0], d)
        B = crop(B, d, B.shape[1])
    return A, B


def bench_pair(A: CSR, B: CSR, *, reps: int = 10, verbose=True,
               device="cuda"):
    device = resolve_device(device)
    flops = spgemm_flops(A, B)
    out = {}

    # --- plan variant ---
    t = Timings("plan (two-phase)", device=device)
    with t.stage("symbolic"):
        plan = spgemm_plan(A, B, device=device)
    a_d, b_d = A.data.to(device), B.data.to(device)
    t.record("numeric", device_ms(lambda: spgemm_numeric(a_d, b_d, plan),
                                  device=device, reps=reps) / 1e3)
    out["plan"] = t.as_dict()
    out["plan"]["gflops_numeric"] = flops / t.stages["numeric"] / 1e9
    if verbose:
        print(t.report(flops=flops))
        print(f"  numeric-only GFLOPS {out['plan']['gflops_numeric']:.3f}")

    # --- device-merge variant ---
    t = Timings("device-merge (expand/sort/merge)", device=device)
    t.record("expand+merge", device_ms(
        lambda: spgemm_device_merge(A, B, device=device), device=device,
        reps=reps) / 1e3)
    out["device"] = t.as_dict()
    if verbose:
        print(t.report(flops=flops))

    # --- dense baseline ---
    if max(A.shape[0], A.shape[1], B.shape[1]) <= 8192:
        Ad = torch.from_numpy(csr_to_dense(A)).to(device, torch.float32)
        Bd = torch.from_numpy(csr_to_dense(B)).to(device, torch.float32)
        dt = device_ms(lambda: Ad @ Bd, device=device, reps=reps) / 1e3
        out["dense"] = {"matmul": dt, "gflops": 2 * Ad.shape[0]
                        * Ad.shape[1] * Bd.shape[1] / dt / 1e9}
        if verbose:
            print(f"=== dense baseline === {dt * 1e3:.3f} ms "
                  f"({out['dense']['gflops']:.1f} GFLOP/s f32)")
    out["flops"] = flops
    out["nnz_c"] = plan.nnz
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--random", nargs=2, type=float, metavar=("N", "DENSITY"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.random:
        import scipy.sparse as sp
        n, dens = int(args.random[0]), args.random[1]
        A = B = CSR.from_scipy(sp.random(n, n, density=dens, random_state=0,
                                         format="csr"))
    else:
        if not args.a:
            ap.error("need A.mtx or --random")
        A, B = load_pair(args.a, args.b)
    print(f"A: {A.shape} nnz={A.nnz}; B: {B.shape} nnz={B.nnz}")
    bench_pair(A, B, reps=args.reps, device=args.device)


if __name__ == "__main__":
    main()
