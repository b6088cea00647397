#!/usr/bin/env python3
"""Time two hand kernels of the port in one or more checkouts on one CUDA
card: the sorted segment sum at every shape the Cookbook2 step gives it,
and the static WSELL chain (one kernel per tile) at the stencil pack.

    python3 chip_ab.py [--segment-only] PARENT_ROOT . . PARENT_ROOT

Each root runs in a process of its own, in the order given (parent,
change, change, parent compares two versions on one card), and imports
g4s_tpu_torch from that root; every root's kernels are built from its own
sources. Each process prints one JSON line: per shape the kernel's device
ms (`obs.timings.device_ms`, unchanged between the versions compared so
far), its plain version's, one `index_add_` of the unsorted blocks, the
bytes bound of the tensors the root passes, and a hash of the result's
bytes (two roots that agree bit for bit print the same hash); then the
chain's warm and cold ms (a 128 MiB fill flushes L2 before each cold
call) and its nvcc seconds, unless --segment-only. Needs one CUDA card;
fails without one.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, published


def _stencil(nx: int, seed: int):
    """chip_smoke.py's phase 3 matrix (bench.py's headline): a 3D 7-point
    stencil, renumbered by a random permutation drawn from `seed`."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def _one(root: str, chain: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from g4s_tpu_torch.engine import build_graph
    from g4s_tpu_torch.models.citcoms import CitcomModel, load_config
    from g4s_tpu_torch.obs.timings import device_ms
    from g4s_tpu_torch.ops import segment, static_spmv, wsell_spmv
    from g4s_tpu_torch.sparse import CSR
    here = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(here, "g4s_tpu_torch", "models",
                                   "citcoms", "cookbook2.cfg"))
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "segment_sum": {}}
    rng = np.random.default_rng(5)
    for dtype in (torch.float64, torch.float32):
        m = CitcomModel(cfg, dtype=dtype, device=dev)
        ops = m._build_ops(m.init_state().T)
        sp_ = m.stencil_plan
        p = torch.from_numpy(rng.standard_normal(m.mesh.nel)).to(dev, dtype)
        buoy = torch.from_numpy(rng.standard_normal(m.mesh.nno)).to(dev, dtype)
        cases = {
            # nodal.build_stencil: (nel*64, 9) blocks into nno*27 slots
            "stencil_build": (ops.elt_k.reshape(-1, 8, 3, 8, 3)
                              .permute(0, 1, 3, 2, 4).reshape(-1, 9)
                              .contiguous(), sp_.seg_ids, sp_.order,
                              m.mesh.nno * 27),
            # assembly.assemble_grad_p: (nel*8, 3) into nno nodes
            "assembly_scatter": ((ops.G * p[:, None, None]).reshape(-1, 3)
                                 .contiguous(), m.plan.seg_ids, m.plan.order,
                                 m.plan.nno),
            # CitcomModel.buoyancy: nno values into nodez layers
            "layer_sum": (buoy * m._layer_weights, m._layer_sorted,
                          m._layer_order, cfg.nodez),
        }
        for name, (flat, ids, order, n_seg) in cases.items():
            fn = lambda: segment.sorted_segment_sum(flat, ids, n_seg,
                                                    order=order)
            by_row = torch.empty_like(ids)
            by_row[order.long()] = ids
            d = flat.shape[1] if flat.dim() > 1 else 1
            lib = lambda: torch.zeros((n_seg,) + tuple(flat.shape[1:]),
                                      dtype=dtype, device=dev).index_add_(
                0, by_row, flat)
            got = fn()
            torch.cuda.synchronize()
            nbytes = (flat.numel() * flat.element_size()
                      + ids.numel() * ids.element_size()
                      + order.numel() * order.element_size()
                      + n_seg * d * flat.element_size())
            key = f"{name}_{'f64' if dtype == torch.float64 else 'f32'}"
            out["segment_sum"][key] = {
                "rows": order.numel(), "cols": d, "segments": n_seg,
                "index_dtype": str(ids.dtype).replace("torch.", ""),
                "ms": device_ms(fn, device=dev, reps=50),
                "plain_ms": device_ms(lambda: segment
                                      ._sorted_segment_sum_plain(
                                          flat, ids, n_seg, order=order),
                                      device=dev, reps=50),
                "index_add_ms": device_ms(lib, device=dev, reps=50),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "sha": hashlib.sha256(got.cpu().numpy().tobytes())
                .hexdigest()[:16]}
        del m, ops, cases
    if not chain:
        return out
    a = _stencil(101, seed=0)
    g = build_graph(CSR.from_scipy(a), device=dev)
    ws = g.wsell
    x_pad = torch.zeros(wsell_spmv._chain_pad(ws), device=dev)
    x_pad[: a.shape[0]] = torch.from_numpy(
        np.random.default_rng(1).standard_normal(a.shape[0])
        .astype(np.float32)).to(dev)
    starts_h, kc_h = static_spmv.static_windows(ws)
    chain = static_spmv.build_static_chain(ws, starts_h, kc_h, device=dev)
    y = chain(x_pad)
    same = torch.equal(y, wsell_spmv.spmv_wsell_chain(ws, x_pad)[: y.numel()])
    out["chain"] = {
        "tiles": ws.lanes.shape[0], "nvcc_s": chain.nvcc_s,
        "equals_wsell_kernel": same,
        "ms": device_ms(lambda: chain(x_pad), device=dev, reps=50),
        "cold_ms": device_ms(lambda: chain(x_pad), device=dev, reps=50,
                             before=lambda: flush_buf.fill_(1))}
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card", file=sys.stderr)
        return 1
    flags = [a for a in argv if a == "--segment-only"]
    roots = [a for a in argv if a != "--segment-only"]
    if roots[:1] == ["--one"]:
        print(json.dumps(_one(roots[1], chain=not flags)), flush=True)
        return 0
    rc = 0
    for root in roots or ["."]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, *flags], capture_output=True,
                              text=True, timeout=600)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            rc = proc.returncode
        print(f"# {root}: rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
