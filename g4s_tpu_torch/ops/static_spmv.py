"""WSELL-K SpMV compiled per matrix, its window starts baked into the code
(counterpart of benchmarks/static_spmv_probe.py and static_spmv_probe2.py).

The function is the WSELL chain's, y_pad = A @ x_pad over a `WSELL` pack
(ops/wsell_spmv.py). The production kernel reads each entry's window start
from memory, `starts[pack * k + slot]`. Here every pack's window starts
and its exact window count kc (`static_windows`) are constants of a CUDA
source generated for the one matrix (`generate_static_source`) and built
by nvcc at first use into g4s_tpu_torch/_build/: a switch on the pack sets
the kc window offsets as immediates, and an entry's window is chosen among
them by a kc-long compare-and-select, with no load. Windows that packs of
a tile share are read once into L1 and hit there after.

Two forms, as the reference's two probes:

- `build_static_chain`: one kernel per tile, each holding only its tile's
  constants, launched one after another (probe 1, one pallas_call per
  tile). The tiles write disjoint rows of y and only read x, so each
  launch after the first is a programmatic dependent launch (Hopper): a
  tile's grid starts as soon as every block of the tile before it has
  started, and each tile finishes only after the one before it
  (`griddepcontrol.wait` after its rows are written), so the tiles
  overlap on the device and the op after the last one still sees all of
  y. 128-thread blocks give each tile 128 blocks, so the overlapping
  tiles spread over all the SMs;
- `build_static_one_kernel`: one kernel over the first `n_tiles` tiles,
  every tile's constants in one program (probe 2, one pallas_call). The
  probe stages x in VMEM and double-buffers lanes and values by DMA; x
  here (4 MB at the stencil) is too large for shared memory and stays in
  L2, and the card's own loads stream lanes and values.

As in the probes, an entry whose slot is kc or more reads window 0: only
zero-valued padding has such a slot. Both kernels take f32, as the probes
do on the chip; `_static_spmv_plain` is dtype-generic.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from g4s_tpu_torch.kernels import _build
from g4s_tpu_torch.ops.wsell_spmv import WSELL, _chain_pad
from g4s_tpu_torch.sparse.containers import resolve_device

# launches of the generated kernels (CUDA tensors only): the chain form
# launches one kernel per tile
CHAIN_LAUNCHES = 0
ONE_LAUNCHES = 0

# threads per block: the chain's tiles overlap, each with 128 blocks
_CHAIN_THREADS = 128
_ONE_THREADS = 256


def static_windows(packed: WSELL):
    """(starts_h, kc_h): each pack's K window starts (128-column block ids,
    (n_packs, K) int32) and its live window count, as the probes compute
    them: starts are sorted and distinct, padding slots repeat the first,
    so kc = 1 + the number of rises."""
    n_packs = packed.lanes.shape[0] * packed.ppt
    starts_h = packed.starts.cpu().numpy().reshape(n_packs, packed.k)
    kc_h = 1 + (np.diff(starts_h, axis=1) > 0).sum(axis=1)
    return starts_h, kc_h


def _static_spmv_plain(packed: WSELL, starts_h, kc_h, x_pad: torch.Tensor,
                       n_tiles: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the generated kernels: the first `n_tiles`
    tiles' rows (all tiles, and the chain-padded zero tail, when None).
    `starts_h` and `kc_h` may be numpy arrays or tensors; tensors already
    on x_pad's device cost no copy."""
    total = packed.lanes.shape[0]
    nt = total if n_tiles is None else n_tiles
    dev = x_pad.device
    code = packed.lanes[:nt].reshape(-1).to(dev).long()
    pack = torch.arange(code.numel(), device=dev) // 1024
    starts = torch.as_tensor(starts_h, device=dev)[: nt * packed.ppt].long()
    kc = torch.as_tensor(kc_h, device=dev)[: nt * packed.ppt].long()
    slot = code >> 7
    slot = torch.where(slot < kc[pack], slot, torch.zeros_like(slot))
    col = starts[pack, slot] * 128 + (code & 127)
    rows = nt * packed.ppt * packed.rows_per_pack
    y = (packed.vals[:nt].reshape(-1).to(dev) * x_pad[col]) \
        .view(rows, packed.width).sum(dim=1)
    tail = _chain_pad(packed) - rows if nt == total else 0
    return torch.nn.functional.pad(y, (0, tail)) if tail else y


_HEADER = """\
// Generated by g4s_tpu_torch/ops/static_spmv.py for one WSELL-K pack:
// y = A x with every pack's window starts and window count kc compiled in.
// One thread per row sums its W products in f32 in entry order, as
// csrc/wsell_spmv.cu does; a switch on the pack sets the kc window offsets
// (128-column block id * 128) as immediates, and an entry's window is
// chosen among them with no load. An entry whose slot is kc or more reads
// window 0 (only zero-valued padding has one).

#include <cstdint>
#include <cuda_runtime.h>

namespace {{

constexpr int W = {width};
constexpr int K = {k};
constexpr int RPP = {rpp};                   // rows per pack
constexpr long long ROWS_PER_TILE = {rows_per_tile}LL;
constexpr int THREADS = {threads};

template <int KC>
__device__ __forceinline__ float term(int code, const int (&b)[K],
                                      const float* __restrict__ x, float v) {{
  const int slot = code >> 7;
  int w = b[0];
#pragma unroll
  for (int j = 1; j < KC; ++j) w = slot == j ? b[j] : w;
  return v * __ldg(x + w + (code & 127));
}}

// code j of 8 packed little-endian int16 codes (all non-negative)
__device__ __forceinline__ int code_of(const int4& q, int j) {{
  const int word = j < 2 ? q.x : j < 4 ? q.y : j < 6 ? q.z : q.w;
  return (j & 1) ? (int)((unsigned)word >> 16) : (word & 0xFFFF);
}}

template <int KC>
__device__ __forceinline__ float row_dot(const int (&b)[K], long long r,
                                         const int16_t* __restrict__ lanes,
                                         const float* __restrict__ vals,
                                         const float* __restrict__ x) {{
  float acc = 0.f;
  if constexpr (W % 8 == 0) {{
    const int4* l4 = reinterpret_cast<const int4*>(lanes + r * W);
    const float4* v4 = reinterpret_cast<const float4*>(vals + r * W);
#pragma unroll
    for (int c = 0; c < W / 8; ++c) {{
      const int4 lw = __ldg(l4 + c);
      const float4 va = __ldg(v4 + 2 * c);
      const float4 vb = __ldg(v4 + 2 * c + 1);
      acc += term<KC>(code_of(lw, 0), b, x, va.x);
      acc += term<KC>(code_of(lw, 1), b, x, va.y);
      acc += term<KC>(code_of(lw, 2), b, x, va.z);
      acc += term<KC>(code_of(lw, 3), b, x, va.w);
      acc += term<KC>(code_of(lw, 4), b, x, vb.x);
      acc += term<KC>(code_of(lw, 5), b, x, vb.y);
      acc += term<KC>(code_of(lw, 6), b, x, vb.z);
      acc += term<KC>(code_of(lw, 7), b, x, vb.w);
    }}
  }} else {{
#pragma unroll
    for (int e = 0; e < W; ++e)
      acc += term<KC>((int)__ldg(lanes + r * W + e), b, x,
                      __ldg(vals + r * W + e));
  }}
  return acc;
}}

// the row's sum with the pack's kc live windows
__device__ __forceinline__ float pack_dot(int kc, const int (&b)[K],
                                          long long r,
                                          const int16_t* __restrict__ lanes,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ x) {{
  switch (kc) {{
{kc_cases}
  }}
  return 0.f;
}}
"""

_TILE = """
// tile {t}: packs {p0}..{p1}; sets b[0..kc) and returns kc
__device__ __forceinline__ int windows_{t}(int q, int (&b)[K]) {{
  switch (q) {{
{cases}
  }}
  return 0;
}}
"""

_CHAIN = """
__global__ void __launch_bounds__(THREADS) static_tile_{t}(
    const int16_t* __restrict__ lanes, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ y, long long end) {{
  // cudaTriggerProgrammaticLaunchCompletion(): the next tile may start
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long r = {t}LL * ROWS_PER_TILE
      + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r < end) {{
    float acc = 0.f;
    if (r < {t1}LL * ROWS_PER_TILE) {{
      int b[K];
      const int q = (int)((r - {t}LL * ROWS_PER_TILE) / RPP);
      acc = pack_dot(windows_{t}(q, b), b, r, lanes, vals, x);
    }}
    y[r] = acc;
  }}
  // cudaGridDependencySynchronize(): finish after the tile before
  asm volatile("griddepcontrol.wait;" ::: "memory");
}}
"""

_CHAIN_ENTRY = """
}}  // namespace

// one launch per tile, in order; the last also writes the zero tail. The
// first tile waits for the stream's earlier work as any launch does; each
// later one is a programmatic dependent launch of the tile before it
extern "C" int g4s_static_spmv(const void* lanes, const void* vals,
                               const void* x, void* y, void* stream) {{
  const int16_t* l = (const int16_t*)lanes;
  const float* v = (const float*)vals;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {{}};
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = pdl;
{launches}
  return (int)cudaSuccess;
}}
"""

_CHAIN_LAUNCH = """\
  cfg.gridDim = dim3({blocks});
  cfg.numAttrs = {pdl};
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, static_tile_{t}, l, v, xx, yy,
                                         {end}LL))
    return (int)e;"""

_ONE = """
constexpr int N_TILES = {n_tiles};
constexpr long long END = {end}LL;     // rows written: zero tail included

__global__ void __launch_bounds__(THREADS) static_one(
    const int16_t* __restrict__ lanes, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ y) {{
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= END) return;
  float acc = 0.f;
  if (r < N_TILES * ROWS_PER_TILE) {{
    int b[K];
    int kc = 0;
    const int q = (int)((r % ROWS_PER_TILE) / RPP);
    switch ((int)(r / ROWS_PER_TILE)) {{
{tile_cases}
    }}
    acc = pack_dot(kc, b, r, lanes, vals, x);
  }}
  y[r] = acc;
}}

}}  // namespace

extern "C" int g4s_static_spmv(const void* lanes, const void* vals,
                               const void* x, void* y, void* stream) {{
  static_one<<<{blocks}, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)lanes, (const float*)vals, (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}}
"""


def generate_static_source(packed: WSELL, starts_h, kc_h, *,
                           one_kernel: bool,
                           n_tiles: Optional[int] = None) -> str:
    """The CUDA source of one form for this pack: a pure function of the
    pack, so the same pack gives the same bytes (and the build cache hits).
    `n_tiles` (one kernel only) keeps the first n_tiles tiles."""
    total = packed.lanes.shape[0]
    nt = total if n_tiles is None else int(n_tiles)
    if not one_kernel and nt != total:
        raise ValueError("the chain form runs every tile")
    if not 1 <= nt <= total:
        raise ValueError(f"n_tiles={nt} outside 1..{total}")
    ppt, rpp = packed.ppt, packed.rows_per_pack
    rows_per_tile = ppt * rpp
    n_pad = _chain_pad(packed)
    starts_h = np.asarray(starts_h)
    kc_h = np.asarray(kc_h)
    kc_cases = "\n".join(
        f"    case {kc}: return row_dot<{kc}>(b, r, lanes, vals, x);"
        for kc in range(1, packed.k + 1))
    threads = _ONE_THREADS if one_kernel else _CHAIN_THREADS
    parts = [_HEADER.format(width=packed.width, k=packed.k, rpp=rpp,
                            rows_per_tile=rows_per_tile,
                            threads=threads, kc_cases=kc_cases)]
    for t in range(nt):
        cases = []
        for q in range(ppt):
            p = t * ppt + q
            kc = int(kc_h[p])
            sets = " ".join(f"b[{j}] = {int(starts_h[p, j]) * 128};"
                            for j in range(kc))
            cases.append(f"    case {q}: {sets} return {kc};")
        parts.append(_TILE.format(t=t, p0=t * ppt, p1=(t + 1) * ppt - 1,
                                  cases="\n".join(cases)))
    end_all = n_pad if nt == total else nt * rows_per_tile
    if one_kernel:
        tile_cases = "\n".join(
            f"      case {t}: kc = windows_{t}(q, b); break;"
            for t in range(nt))
        parts.append(_ONE.format(n_tiles=nt, end=end_all,
                                 tile_cases=tile_cases,
                                 blocks=-(-end_all // threads)))
    else:
        launches = []
        for t in range(nt):
            parts.append(_CHAIN.format(t=t, t1=t + 1))
            end = end_all if t == nt - 1 else (t + 1) * rows_per_tile
            launches.append(_CHAIN_LAUNCH.format(
                t=t, end=end, pdl=int(t > 0),
                blocks=-(-(end - t * rows_per_tile) // threads)))
        parts.append(_CHAIN_ENTRY.format(launches="\n".join(launches)))
    return "".join(parts)


class StaticSpMV:
    """f(x_pad) -> y_pad through one generated form. A CUDA x_pad launches
    the kernel (built when the object is made), a CPU one runs
    `_static_spmv_plain`. `nvcc_s` is the build's nvcc wall time (0 when
    the library was already built), `n_tiles` the tiles it covers and
    `n_out` the length of y_pad."""

    def __init__(self, packed: WSELL, starts_h, kc_h, *, one_kernel: bool,
                 n_tiles: Optional[int], device):
        device = resolve_device(device)
        total = packed.lanes.shape[0]
        self.packed, self.starts_h, self.kc_h = packed, starts_h, kc_h
        self.one_kernel = one_kernel
        self.n_tiles = total if n_tiles is None else int(n_tiles)
        rows = self.n_tiles * packed.ppt * packed.rows_per_pack
        self.n_out = _chain_pad(packed) if self.n_tiles == total else rows
        self.nvcc_s = 0.0
        self._fn = None
        if device.type == "cuda":
            source = generate_static_source(
                packed, starts_h, kc_h, one_kernel=one_kernel,
                n_tiles=self.n_tiles if one_kernel else None)
            name = "static_spmv_one" if one_kernel else "static_spmv_chain"
            lib, self.nvcc_s = _build.build_generated(name, source)
            self._fn = lib.g4s_static_spmv
            self._fn.argtypes = [ctypes.c_void_p] * 5
            self._fn.restype = ctypes.c_int

    def __call__(self, x_pad: torch.Tensor) -> torch.Tensor:
        global CHAIN_LAUNCHES, ONE_LAUNCHES
        p = self.packed
        if x_pad.device.type == "cpu":
            return _static_spmv_plain(p, self.starts_h, self.kc_h, x_pad,
                                      self.n_tiles)
        if not x_pad.is_cuda or self._fn is None:
            raise ValueError(f"static SpMV: built for the CPU, or device "
                             f"{x_pad.device} unsupported")
        n_pad = _chain_pad(p)
        if x_pad.dtype != torch.float32 or p.vals.dtype != torch.float32:
            raise TypeError("static SpMV: the kernel takes f32 x and f32 "
                            "vals only")
        if x_pad.shape != (n_pad,) or not x_pad.is_contiguous():
            raise ValueError(f"static SpMV: x_pad must be contiguous of "
                             f"shape ({n_pad},), not {tuple(x_pad.shape)}")
        for name, t in (("lanes", p.lanes), ("vals", p.vals)):
            if t.device != x_pad.device or not t.is_contiguous() \
                    or t.data_ptr() % 16:
                raise ValueError(f"static SpMV: {name} must be contiguous "
                                 f"and 16-byte aligned on {x_pad.device}")
        y = torch.empty((self.n_out,), dtype=torch.float32,
                        device=x_pad.device)
        with torch.cuda.device(x_pad.device):
            rc = self._fn(p.lanes.data_ptr(), p.vals.data_ptr(),
                          x_pad.data_ptr(), y.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
        if self.one_kernel:
            ONE_LAUNCHES += 1
        else:
            CHAIN_LAUNCHES += self.n_tiles
        _build.check(rc, "g4s_static_spmv")
        return y


def build_static_chain(packed: WSELL, starts_h, kc_h, *,
                       device="cuda") -> StaticSpMV:
    """One kernel per tile, launched in order (probe 1's form)."""
    return StaticSpMV(packed, starts_h, kc_h, one_kernel=False, n_tiles=None,
                      device=device)


def build_static_one_kernel(packed: WSELL, starts_h, kc_h,
                            n_tiles: Optional[int] = None, *,
                            device="cuda") -> StaticSpMV:
    """One kernel over the first `n_tiles` tiles (probe 2's form); over all
    of them it returns the chain-padded y, capped only their rows."""
    return StaticSpMV(packed, starts_h, kc_h, one_kernel=True,
                      n_tiles=n_tiles, device=device)
