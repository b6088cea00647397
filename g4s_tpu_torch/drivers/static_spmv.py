"""Per-matrix WSELL-K SpMV driver: the main()s of the reference's two
probes (benchmarks/static_spmv_probe.py and static_spmv_probe2.py) as one
command line.

Builds the 3D 7-point stencil at nx (bench.py's headline matrix),
renumbered by a permutation from default_rng(seed) as both probes do, and
packs it by build_graph's CUDA layout rules (asked for explicitly on the
CPU), which must pick "wsell". Then it builds the
kernel specialised to this pack (ops/static_spmv.py): one launch per tile
(probe 1), or with --one-kernel one launch over the first --n-tiles-cap
tiles (probe 2). It prints the window statistics, the nvcc wall time, the
largest error against the port's WSELL chain kernel on x = 1 (as the
probes), and the time per call with the GB/s of the probes' byte count
(6 bytes per stored entry, 8 per row). On the card the time is the median
device time per call (obs.timings.device_ms); with --device cpu, the host
clock times the plain PyTorch version, which is no device metric.

Usage: python -m g4s_tpu_torch.drivers.static_spmv [--nx 101]
       [--one-kernel] [--n-tiles-cap N] [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from g4s_tpu_torch.engine import dispatch
from g4s_tpu_torch.obs.timings import device_ms
from g4s_tpu_torch.ops import static_spmv, wsell_spmv
from g4s_tpu_torch.sparse import CSR
from g4s_tpu_torch.sparse.containers import resolve_device


def stencil(nx: int, seed: int = 0):
    """The 3D 7-point stencil (ones), f32, renumbered at random."""
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = np.random.default_rng(seed).permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=101)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one-kernel", action="store_true")
    ap.add_argument("--n-tiles-cap", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    a = stencil(args.nx, args.seed)
    n = a.shape[0]
    # the CUDA layout rules; on the CPU they are asked for explicitly
    g = dispatch._build_graph(
        CSR.from_scipy(a), device=device, kernel_layouts=True, variant=None,
        max_padding_waste=1.5, pad_to=8, max_diags=48,
        dense_threshold=1 << 21, dtype=None, reorder=True)
    if g.variant != "wsell":
        raise RuntimeError(f"the stencil dispatched to {g.variant!r}, not "
                           "'wsell'")
    packed = g.wsell
    total = packed.lanes.shape[0]
    starts_h, kc_h = static_spmv.static_windows(packed)
    print(f"packs={starts_h.shape[0]} K={packed.k} kc mean "
          f"{kc_h.mean():.2f} tiles={total} ppt={packed.ppt}", flush=True)

    n_tiles = total if args.n_tiles_cap is None \
        else min(args.n_tiles_cap, total)
    if args.one_kernel:
        f = static_spmv.build_static_one_kernel(
            packed, starts_h, kc_h, n_tiles, device=device)
    else:
        if n_tiles != total:
            raise ValueError("--n-tiles-cap needs --one-kernel")
        f = static_spmv.build_static_chain(packed, starts_h, kc_h,
                                           device=device)
    xp = torch.zeros((wsell_spmv._chain_pad(packed),), device=device)
    xp[:n] = 1.0
    y_ref = wsell_spmv.spmv_wsell_chain(packed, xp)
    y = f(xp)
    rows = n_tiles * packed.ppt * packed.rows_per_pack
    err = float((y[:rows] - y_ref[:rows]).abs().max())
    print(f"compile {f.nvcc_s:.1f}s  maxerr {err:.2e}", flush=True)

    ms = device_ms(lambda: f(xp), device=device, reps=args.reps)
    nbytes = (a.nnz * 6 + n * 8) * n_tiles / total
    form = "one-kernel" if args.one_kernel else "chain"
    print(f"{form} static ({n_tiles}/{total} tiles, {device.type}): "
          f"{ms * 1e3:.1f} us = {nbytes / ms / 1e6:.0f} GB/s "
          f"(compile {f.nvcc_s:.1f}s)", flush=True)
    return {"variant": g.variant, "n_tiles": n_tiles, "tiles": total,
            "max_err": err, "ms": ms, "nvcc_s": f.nvcc_s}


if __name__ == "__main__":
    main()
