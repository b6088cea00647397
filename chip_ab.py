#!/usr/bin/env python3
"""Time hand kernels of the port in one or more checkouts on one CUDA card:
the sorted segment sum at every shape the Cookbook2 step gives it, the
static WSELL chain (one kernel per tile) at the stencil pack, and the
permute gather at the engine's six path permutations.

    python3 chip_ab.py [--segment-only | --permute-only] PARENT_ROOT . . \
        PARENT_ROOT

Each root runs in a process of its own, in the order given (parent,
change, change, parent compares two versions on one card), and imports
g4s_tpu_torch from that root; every root's kernels are built from its own
sources. Each process prints one JSON line: per shape the kernel's device
ms (`obs.timings.device_ms`, unchanged between the versions compared so
far), its plain version's, one `index_add_` of the unsorted blocks, the
bytes bound of the tensors the root passes, and a hash of the result's
bytes (two roots that agree bit for bit print the same hash); then the
chain's warm and cold ms (a 128 MiB fill flushes L2 before each cold
call) and its nvcc seconds; then, per path permutation (chip_smoke.py
phases 3-5: stencil.perm, stencil.iperm, dia.perm, stream.xplan,
stream.route2, stream.rowplan), the f32 gather's warm and cold ms and
the f64 gather's warm ms beside the gather over the identity sigma, m
random reads of z alone (a generated yardstick kernel: no sigma read, no
out written), `z[sigma]` warm and cold, the bound, whether it equals the
plain version bit for bit, and the result's hash, and the device ms of
one stencil, RCM-DIA and stream `mxv`.
--segment-only runs the segment sum alone, --permute-only the permute
alone. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, published


def _permute_paths(dev):
    """The engine's six path permutations as chip_smoke.py phases 3-5 build
    them (the band's renumbering drawn from its own seed here), with the
    graphs whose mxv runs them: ({name: (sigma, n_z, n_out)}, {layout:
    (graph, x)})."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from chip_smoke import _band, _stencil
    from g4s_tpu_torch.engine import build_graph
    from g4s_tpu_torch.ops import wsell_spmv
    from g4s_tpu_torch.sparse import CSR
    g = build_graph(CSR.from_scipy(_stencil(101, seed=0)), device=dev)
    n = g.perm.shape[0]
    n_pad = wsell_spmv._chain_pad(g.wsell)
    nb, nr = 1 << 20, 1 << 17
    p_ = np.random.default_rng(2).permutation(nb)
    g4 = build_graph(CSR.from_scipy(_band(nb)[p_][:, p_].tocsr()),
                     device=dev)
    rr = np.random.default_rng(1)
    rand = sp.coo_matrix(
        (rr.normal(size=nr * 8).astype(np.float32),
         (rr.integers(0, nr, nr * 8), rr.integers(0, nr, nr * 8))),
        shape=(nr, nr)).tocsr()
    g5 = build_graph(CSR.from_scipy(rand), device=dev, reorder=False)
    s5 = g5.stream
    paths = {
        "stencil.perm": (g.perm, n, n_pad),
        "stencil.iperm": (g.iperm, n_pad, n),
        "dia.perm": (g4.perm, nb, nb),
        "stream.xplan": (s5.xplan.sigma, nr, s5.nc_pad),
        "stream.route2": (s5.route2.sigma, s5.m, s5.m),
        "stream.rowplan": (s5.rowplan.sigma[: s5.n_rows], s5.n_rows,
                           s5.n_rows),
    }
    xs = np.random.default_rng(3)
    graphs = {name: (gr, torch.from_numpy(xs.standard_normal(k)
                                          .astype(np.float32)).to(dev))
              for name, gr, k in (("stencil", g, n), ("dia", g4, nb),
                                  ("stream", g5, nr))}
    return paths, graphs


# m reads of z at hashed, scattered indices and nothing else (no index
# array read, no output written; a store that never happens keeps the
# loads): what the permute gather's random reads alone cost on the card
_RANDOM_READS = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
random_reads(const float* __restrict__ z, unsigned n_z, long long m,
             float* __restrict__ sink) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= m) return;
  const float v =
      __ldg(z + (unsigned)(((unsigned long long)i * 2654435761ull) % n_z));
  if (v == 1234.5f) sink[0] = v;
}
extern "C" int g4s_random_reads(const void* z, long long n_z, long long m,
                                void* sink, void* stream) {
  random_reads<<<(unsigned)((m + 255) / 256), 256, 0,
                 (cudaStream_t)stream>>>((const float*)z, (unsigned)n_z, m,
                                         (float*)sink);
  return (int)cudaGetLastError();
}
"""


def _permute(dev, flush_buf) -> dict:
    """The permute gather at the six path permutations, f32 (and f64
    warm), beside m random reads of z alone."""
    import ctypes
    import numpy as np
    import torch
    from g4s_tpu_torch.engine import mxv
    from g4s_tpu_torch.kernels import _build
    from g4s_tpu_torch.obs.timings import device_ms
    from g4s_tpu_torch.ops import route
    lib, _ = _build.build_generated("random_reads", _RANDOM_READS)
    lib.g4s_random_reads.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_void_p]
    sink = torch.zeros(1, device=dev)

    def random_reads(z, m_):
        _build.check(lib.g4s_random_reads(
            z.data_ptr(), z.shape[0], m_, sink.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "g4s_random_reads")

    paths, graphs = _permute_paths(dev)
    out = {}
    for name, (sigma, n_z, n_out) in paths.items():
        m_ = sigma.shape[0]
        z = torch.from_numpy(np.random.default_rng(m_).standard_normal(n_z)
                             .astype(np.float32)).to(dev)
        top = int(sigma.max()) + 1
        z_lib = z if top <= n_z else torch.cat([z, z.new_zeros(top - n_z)])
        reads = int(torch.unique(sigma[sigma < n_z]).numel())
        ident = torch.arange(m_, dtype=torch.int32, device=dev)
        got = route.permute_gather(z, sigma, n_out=n_out)
        exact = torch.equal(got, route._apply_permute_plain(
            z, sigma, n_out=n_out))

        def gather():
            return route.permute_gather(z, sigma, n_out=n_out)

        def flush():
            flush_buf.fill_(1)

        z64 = z.double()
        out[name] = {
            "m": m_, "n_z": n_z, "n_out": n_out,
            "ms": device_ms(gather, device=dev, reps=50),
            "f64_ms": device_ms(lambda: route.permute_gather(
                z64, sigma, n_out=n_out), device=dev, reps=50),
            "random_reads_ms": device_ms(lambda: random_reads(z, m_),
                                         device=dev, reps=50),
            "cold_ms": device_ms(gather, device=dev, reps=50, before=flush),
            "identity_ms": device_ms(lambda: route.permute_gather(
                z, ident, n_out=n_out), device=dev, reps=50),
            "library_ms": device_ms(lambda: z_lib[sigma], device=dev,
                                    reps=50),
            "library_cold_ms": device_ms(lambda: z_lib[sigma], device=dev,
                                         reps=50, before=flush),
            # sigma (int32) and the z it reaches read, out written (f32)
            "bound_ms": 4.0 * (m_ + reads + n_out) / HBM_BYTES_PER_S * 1e3,
            "bit_exact": exact,
            "sha": hashlib.sha256(got.cpu().numpy().tobytes())
            .hexdigest()[:16]}
    sigma, n_z, n_out = paths["stencil.perm"]
    if hasattr(route, "permute_launch_shape"):
        out["launch_shape"] = route.permute_launch_shape(torch.float32,
                                                         n_out, device=dev)
    out["mxv_ms"] = {name: device_ms(lambda: mxv(gr, x), device=dev,
                                     reps=50)
                     for name, (gr, x) in graphs.items()}
    return out


def _one(root: str, parts: set) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from g4s_tpu_torch.engine import build_graph
    from g4s_tpu_torch.models.citcoms import CitcomModel, load_config
    from g4s_tpu_torch.obs.timings import device_ms
    from g4s_tpu_torch.ops import segment, static_spmv, wsell_spmv
    from g4s_tpu_torch.sparse import CSR
    from chip_smoke import _stencil
    here = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(here, "g4s_tpu_torch", "models",
                                   "citcoms", "cookbook2.cfg"))
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    if "permute" in parts:
        out["permute"] = _permute(dev, flush_buf)
    if "segment" not in parts:
        return out
    out["segment_sum"] = {}
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
    if "chain" not in parts:
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
    only = {"--segment-only": {"segment"}, "--permute-only": {"permute"}}
    flags = [a for a in argv if a in only]
    roots = [a for a in argv if a not in only]
    if roots[:1] == ["--one"]:
        parts = only[flags[0]] if flags else {"segment", "chain", "permute"}
        print(json.dumps(_one(roots[1], parts)), flush=True)
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
