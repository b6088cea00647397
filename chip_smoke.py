#!/usr/bin/env python3
"""Drive the port's graph-engine SpMV path once on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It

  0. requires a CUDA card and prints torch, CUDA and nvcc versions and the
     card's name and power limit;
  1. builds the hand-written kernels from g4s_tpu_torch/csrc/;
  2. holds each kernel against its plain PyTorch version on the card:
     permute_gather bit-exact (m = 2^20, f32 and f64), wsell_spmv within a
     relative 1e-5 on the multi-window, rectangular, W=2 and W=16 packs;
  3. drives the main path, build_graph + mxv, on the randomly renumbered
     3D 7-point stencil at nx = 101 (n = 1,030,301): it must dispatch to
     "wsell" with an RCM permutation, launch both kernels, and match scipy
     in f64 to a relative 1e-5 (f32 sums of 7 terms in another order);
     both kernels are compared and timed at the shapes this path gives
     them, beside their plain versions (device time per call, see
     _cuda_ms), and mxv's host wall time per call is timed beside it;
  4. the shuffled 16-diagonal band at n = 2^20 -> "dia" with a permutation;
  5. a uniform random 2^17 x 8-per-row matrix -> "stream", 3 permutes.

Each phase prints one line; any failure raises. The line before the last
is a JSON object describing each kernel; the last is the result line.
Fails (exit code 1, no result line) without CUDA or outside the repo.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REL_TOL = 1e-5


def _say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def _cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one fn() call, by CUDA events between `reps`
    back-to-back calls.

    Enqueueing one call can take the host longer than the device takes to
    run it, and an event pair around a call on an idle device then times
    the host. So the device first sleeps while the host queues every call
    and event; if the device reached the first event before the host had
    queued them all, the sleep is lengthened and the batch repeated."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 26
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(cycles)
        ev[0].record()
        for e in ev[1:]:
            fn()
            e.record()
        drained = ev[0].query()
        torch.cuda.synchronize()
        if not drained:
            return statistics.median(
                a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
        cycles *= 4
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


def _host_us(fn, reps: int = 100) -> float:
    """Host wall time per call of back-to-back fn() calls, synchronized at
    the end: what a caller waits when the host enqueues slower than the
    device runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _rel_err(y, ref) -> float:
    import numpy as np
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    if not np.isfinite(y).all():
        raise AssertionError("non-finite output")
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _wsell_cases():
    """The four pack shapes the kernel is compared on: the multi-window and
    rectangular/empty-row matrices of tests/test_ops.py, and packs with
    W = 2 and W = 16."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    n = 2048
    rows, cols, vals = [], [], []
    for i in range(n):
        for o in (0, 1, -1, 400, -400, 900, -900):
            j = i + o + int(rng.integers(-2, 3))
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(float(rng.normal()))
    multi = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    multi.sum_duplicates()
    yield "multi_window", multi.astype(np.float32)

    n_r, n_c = 500, 700
    m = sp.random(n_r, n_c, density=0.004, random_state=3, format="csr",
                  dtype=np.float32).tocoo()
    m.col[:] = np.minimum(n_c - 1, (m.row * n_c) // n_r + (m.col % 64))
    rect = sp.coo_matrix((m.data, (m.row, m.col)), shape=(n_r, n_c)).tocsr()
    rect.sum_duplicates()
    yield "rect_empty_rows", rect

    n = 4096
    w2 = sp.diags([rng.normal(size=n), rng.normal(size=n - 1)], [0, 1],
                  shape=(n, n), format="csr").astype(np.float32)
    yield "w2", w2

    offs = list(range(-6, 7)) + [300, -300, 1000]
    w16 = sp.diags([rng.normal(size=n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr").astype(np.float32)
    yield "w16", w16


def _stencil(nx: int, seed: int):
    """bench.py's headline matrix: a 3D 7-point stencil, renumbered by a
    random permutation drawn from `seed`."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import scipy.sparse as sp

    from g4s_tpu_torch.engine import build_graph, mxv
    from g4s_tpu_torch.kernels import _build
    from g4s_tpu_torch.ops import route, wsell_spmv
    from g4s_tpu_torch.sparse import CSR

    dev = torch.device("cuda")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc_ver = _run([_build.nvcc(), "--version"]).splitlines()[-1]
    _say("0-machine", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=repr(nvcc_ver), card=repr(smi),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    _say("1-build", seconds=f"{build_s:.2f}", lib=lib_path.name,
         sources=",".join(s.name for s in _build.sources()))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # ---- 2: each kernel against its plain version, small cases ----------
    rng = np.random.default_rng(0)
    err = {"permute_gather": 0.0, "wsell_spmv": 0.0}
    m = 1 << 20
    sigma = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)
    for dt in (torch.float32, torch.float64):
        z = torch.from_numpy(rng.standard_normal(m)).to(dev, dt)
        got = route.permute_gather(z, sigma)
        want = route._apply_permute_plain(z, sigma)
        _check(torch.equal(got, want), f"permute_gather {dt} not bit-exact")
    _say("2-permute", m=m, dtypes="f32,f64", bit_exact=True)
    for name, a in _wsell_cases():
        packed = wsell_spmv.pack_wsell(CSR.from_scipy(a), device=dev,
                                       packs_per_tile=2)
        n_pad = wsell_spmv._chain_pad(packed)
        x_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        x_pad[: a.shape[1]] = torch.from_numpy(
            rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev)
        got = wsell_spmv.spmv_wsell_chain(packed, x_pad)
        want = wsell_spmv._spmv_wsell_plain(packed, x_pad)
        rel = _rel_err(got.cpu(), want.cpu())
        err["wsell_spmv"] = max(err["wsell_spmv"],
                                float((got - want).abs().max()))
        _check(rel <= REL_TOL, f"wsell_spmv {name}: rel err {rel}")
        _check(bool((got[packed.n_rows:] == 0).all()),
               f"wsell_spmv {name}: non-zero tail")
        _say("2-wsell", case=name, shape=a.shape, W=packed.width,
             k=packed.k, rel_err=f"{rel:.3g}")

    # ---- 3: the main path, shuffled 3D 7-point stencil -----------------
    A = _stencil(101, seed=0)
    n = A.shape[0]
    t0 = time.perf_counter()
    g = build_graph(CSR.from_scipy(A), device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    _check(g.variant == "wsell" and g.perm is not None,
           f"stencil dispatched to {g.variant!r}, perm "
           f"{'set' if g.perm is not None else 'None'}")
    _say("3-plan", n=n, nnz=A.nnz, variant=g.variant,
         k=g.wsell.k, groups=list(g.wsell.groups), width=g.wsell.width,
         host_build_s=f"{plan_s:.2f}")

    x_np = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    x_pad = torch.zeros(wsell_spmv._chain_pad(g.wsell), device=dev)
    x_pad[:n] = x
    # kernels vs plain at the main path's shapes
    p_k = route.permute_gather(x, g.perm)
    p_p = route._apply_permute_plain(x, g.perm)
    _check(torch.equal(p_k, p_p), "permute_gather at n: not bit-exact")
    w_k = wsell_spmv.spmv_wsell_chain(g.wsell, x_pad)
    w_p = wsell_spmv._spmv_wsell_plain(g.wsell, x_pad)
    rel = _rel_err(w_k.cpu(), w_p.cpu())
    _check(rel <= REL_TOL, f"wsell_spmv at the stencil pack: rel {rel}")
    err["wsell_spmv"] = max(err["wsell_spmv"], float((w_k - w_p).abs().max()))

    ms = {
        "permute_gather": _cuda_ms(lambda: route.permute_gather(x, g.perm)),
        "wsell_spmv": _cuda_ms(
            lambda: wsell_spmv.spmv_wsell_chain(g.wsell, x_pad)),
    }
    plain_ms = {
        "permute_gather": _cuda_ms(
            lambda: route._apply_permute_plain(x, g.perm)),
        "wsell_spmv": _cuda_ms(
            lambda: wsell_spmv._spmv_wsell_plain(g.wsell, x_pad)),
    }

    def mxv_plain():
        xp = torch.zeros_like(x_pad)
        xp[:n] = route._apply_permute_plain(x, g.perm)
        y_p = wsell_spmv._spmv_wsell_plain(g.wsell, xp)[:n]
        return route._apply_permute_plain(y_p, g.iperm)

    mxv_ms = _cuda_ms(lambda: mxv(g, x))
    mxv_plain_ms = _cuda_ms(mxv_plain)
    mxv_host_us = _host_us(lambda: mxv(g, x))
    stencil_bytes = A.nnz * 8 + n * 8          # bench.py's byte count
    _say("3-time", mxv_ms=f"{mxv_ms:.4f}", mxv_plain_ms=f"{mxv_plain_ms:.4f}",
         mxv_host_wall_us=f"{mxv_host_us:.2f}",
         device_idle_share=f"{max(0.0, 1 - mxv_ms * 1e3 / mxv_host_us):.3f}",
         hoisted_wsell_ms=f"{ms['wsell_spmv']:.4f}",
         wsell_plain_ms=f"{plain_ms['wsell_spmv']:.4f}",
         permute_ms=f"{ms['permute_gather']:.4f}",
         permute_plain_ms=f"{plain_ms['permute_gather']:.4f}",
         gbs_mxv=f"{stencil_bytes / mxv_ms / 1e6:.1f}",
         gbs_hoisted=f"{stencil_bytes / ms['wsell_spmv'] / 1e6:.1f}")

    route.LAUNCHES = 0
    wsell_spmv.LAUNCHES = 0
    y = mxv(g, x)
    torch.cuda.synchronize()
    launches = {"permute_gather": route.LAUNCHES,
                "wsell_spmv": wsell_spmv.LAUNCHES}
    _check(launches["wsell_spmv"] >= 1 and launches["permute_gather"] >= 2,
           f"main path launches {launches}")
    _check(tuple(y.shape) == (n,), f"mxv shape {tuple(y.shape)}")
    rel = _rel_err(y.cpu(), A.astype(np.float64) @ x_np.astype(np.float64))
    _check(rel <= REL_TOL, f"stencil mxv vs scipy f64: rel {rel}")
    _say("3-mxv", launches=json.dumps(launches).replace(" ", ""),
         rel_err_vs_scipy_f64=f"{rel:.3g}")

    # ---- 4: RCM-DIA: the shuffled 16-diagonal band ----------------------
    nb = 1 << 20
    offs = np.r_[0, np.arange(1, 8), -np.arange(1, 9)]
    band = sp.diags([np.ones(nb)] * len(offs), offs, shape=(nb, nb),
                    format="csr").astype(np.float32)
    p_ = rng.permutation(nb)
    shuf = band[p_][:, p_].tocsr()
    g4 = build_graph(CSR.from_scipy(shuf), device=dev)
    _check(g4.variant == "dia" and g4.perm is not None,
           f"band dispatched to {g4.variant!r}")
    xb = rng.standard_normal(nb).astype(np.float32)
    route.LAUNCHES = 0
    yb = mxv(g4, torch.from_numpy(xb).to(dev))
    torch.cuda.synchronize()
    _check(route.LAUNCHES >= 2, f"dia permute launches {route.LAUNCHES}")
    rel = _rel_err(yb.cpu(), shuf.astype(np.float64) @ xb.astype(np.float64))
    _check(rel <= REL_TOL, f"dia mxv vs scipy f64: rel {rel}")
    _say("4-dia", n=nb, variant=g4.variant, ndiag=g4.dia.ndiag,
         permute_launches=route.LAUNCHES, rel_err_vs_scipy_f64=f"{rel:.3g}")

    # ---- 5: the streaming schedule: uniform random 2^17 x 8 -------------
    nr = 1 << 17
    rr = np.random.default_rng(1)
    nnz_r = nr * 8
    rand = sp.coo_matrix(
        (rr.normal(size=nnz_r).astype(np.float32),
         (rr.integers(0, nr, nnz_r), rr.integers(0, nr, nnz_r))),
        shape=(nr, nr)).tocsr()
    t0 = time.perf_counter()
    g5 = build_graph(CSR.from_scipy(rand), device=dev, reorder=False)
    stream_plan_s = time.perf_counter() - t0
    _check(g5.variant == "stream", f"random dispatched to {g5.variant!r}")
    xr = rr.standard_normal(nr).astype(np.float32)
    xr_d = torch.from_numpy(xr).to(dev)
    route.LAUNCHES = 0
    yr = mxv(g5, xr_d)
    torch.cuda.synchronize()
    _check(route.LAUNCHES == 3, f"stream permute launches {route.LAUNCHES}")
    rel = _rel_err(yr.cpu(), rand.astype(np.float64) @ xr.astype(np.float64))
    _check(rel <= REL_TOL, f"stream mxv vs scipy f64: rel {rel}")
    stream_ms = _cuda_ms(lambda: mxv(g5, xr_d))
    stream_host_us = _host_us(lambda: mxv(g5, xr_d))
    _say("5-stream", n=nr, nnz=rand.nnz, variant=g5.variant,
         stream_m=g5.stream.m, permute_launches=3,
         rel_err_vs_scipy_f64=f"{rel:.3g}", mxv_ms=f"{stream_ms:.4f}",
         mxv_host_wall_us=f"{stream_host_us:.2f}",
         host_build_s=f"{stream_plan_s:.2f}")

    kernels = [
        {"name": "permute_gather", "route": "cuda",
         "source": "g4s_tpu_torch/csrc/permute.cu",
         "replaces": "g4s_tpu/ops/route.py:417 (_lane_benes_kernel) + "
                     "g4s_tpu/ops/route.py:438 (_mid_kernel)",
         "launches": launches["permute_gather"],
         "max_abs_err": err["permute_gather"],
         "ms": ms["permute_gather"], "plain_ms": plain_ms["permute_gather"]},
        {"name": "wsell_spmv", "route": "cuda",
         "source": "g4s_tpu_torch/csrc/wsell_spmv.cu",
         "replaces": "g4s_tpu/ops/pallas_spmv.py:491 (_wsell_kernel)",
         "launches": launches["wsell_spmv"],
         "max_abs_err": err["wsell_spmv"],
         "ms": ms["wsell_spmv"], "plain_ms": plain_ms["wsell_spmv"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
