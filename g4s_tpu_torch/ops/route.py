"""Static permutations: out[i] = z[sigma[i]] (counterpart of
g4s_tpu/ops/route.py).

The reference applies a static permutation on the TPU as a Clos network of
Benes butterflies (two Pallas kernels, `_lane_benes_kernel` and
`_mid_kernel`, around two XLA transposes) because TPU gathers are serial,
and routes the network on the host. On Hopper the same function is one
gather kernel over an int32 sigma (csrc/permute.cu), so a plan is the
permutation vector itself and no host routing is needed. The gather also
does the zero padding that the reference's callers do around it: z may be
shorter than the plan (sigma past its end reads 0) and the output longer
(n_out), so the SpMV paths pad with no launches of their own.

`PermutePlan` keeps the reference's padding: m is m0 rounded up to a
multiple of TILE with identity on the tail, and plans above MAX_M raise
NotImplementedError, so the dispatcher makes the reference's choices.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from g4s_tpu_torch.kernels import _build
from g4s_tpu_torch.sparse.containers import as_tensor, resolve_device

C = 128               # the reference's lane width
TILE = C * C          # plan granularity: m is padded to a multiple of 128^2
MAX_M = C * C * 2048  # the reference's single-plan limit

# launches of the permute_gather kernel (CUDA tensors only)
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """Executable plan for out[i] = in[sigma[i]] over m padded elements."""

    sigma: torch.Tensor   # (m,) int32, a bijection on [0, m)
    m: int


def build_permute_plan(sigma, *, device="cuda") -> PermutePlan:
    """Plan for out[i] = in[sigma[i]]; sigma (m0,) is a bijection on
    [0, m0). The plan pads to m = roundup(m0, TILE) with identity on the
    tail; callers pad the input with anything."""
    device = resolve_device(device)
    sigma = np.asarray(sigma, np.int64)
    m0 = sigma.size
    m = -(-m0 // TILE) * TILE
    if m > MAX_M:
        raise NotImplementedError(
            f"m={m} exceeds the single-plan limit {MAX_M}; chunk the "
            "stream or extend the middle to depth 2")
    if m0 and (sigma.min() < 0 or sigma.max() >= m0):
        raise ValueError("sigma must take values in [0, m0)")
    if m0 < m:
        sigma = np.concatenate([sigma, np.arange(m0, m, dtype=np.int64)])
    return PermutePlan(as_tensor(sigma, np.int32).to(device), m)


def _out_len(sigma: torch.Tensor, n_out) -> int:
    m = sigma.shape[0]
    n_out = m if n_out is None else int(n_out)
    if n_out < m:
        raise ValueError(f"permute_gather: n_out={n_out} is shorter than "
                         f"sigma ({m})")
    return n_out


def _apply_permute_plain(z: torch.Tensor, sigma: torch.Tensor, *,
                         n_out=None) -> torch.Tensor:
    """Plain PyTorch version of the permute_gather kernel: the same
    function, as torch indexing into zeros."""
    m, n_out = sigma.shape[0], _out_len(sigma, n_out)
    out = torch.zeros((n_out,), dtype=z.dtype, device=z.device)
    if z.shape[0]:
        idx = sigma.long()
        # sigma outside [0, len(z)) reads 0, as the kernel's unsigned compare
        hit = (idx >= 0) & (idx < z.shape[0])
        out[:m] = torch.where(hit, z[torch.where(hit, idx, 0)], 0)
    return out


def permute_gather(z: torch.Tensor, sigma: torch.Tensor, *,
                   n_out=None) -> torch.Tensor:
    """out[i] = z[sigma[i]] for i < len(sigma), with the zero padding of
    both sides fused in: sigma[i] outside [0, len(z)) reads 0 (what a z
    padded with zeros gives), and out[i] = 0 for len(sigma) <= i < n_out.
    n_out defaults to len(sigma) and may not be shorter.

    A CUDA tensor goes through the permute_gather kernel (f32 or f64 z,
    int32 sigma, both contiguous and 1-D); a CPU tensor through its plain
    PyTorch version. Anything else raises. Sigma is not range-checked
    here: the plans are, where they are built."""
    global LAUNCHES
    n_out = _out_len(sigma, n_out)
    if z.device.type == "cpu":
        return _apply_permute_plain(z, sigma, n_out=n_out)
    if not z.is_cuda:
        raise ValueError(f"permute_gather: unsupported device {z.device}")
    if z.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"permute_gather: z must be f32 or f64, not "
                        f"{z.dtype}")
    if sigma.dtype != torch.int32 or sigma.device != z.device:
        raise TypeError("permute_gather: sigma must be int32 on z's device")
    if z.dim() != 1 or sigma.dim() != 1 or not z.is_contiguous() \
            or not sigma.is_contiguous():
        raise ValueError("permute_gather: z and sigma must be contiguous "
                         "1-D tensors")
    out = torch.empty((n_out,), dtype=z.dtype, device=z.device)
    if n_out == 0:
        return out
    lib = _build.load()
    name = ("g4s_permute_gather_f32" if z.dtype == torch.float32
            else "g4s_permute_gather_f64")
    with torch.cuda.device(z.device):
        rc = getattr(lib, name)(z.data_ptr(), z.shape[0], sigma.data_ptr(),
                                sigma.shape[0], out.data_ptr(), n_out,
                                torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    _build.check(rc, name)
    return out


def permute_launch_shape(dtype, n_out: int, *, device="cuda") -> dict:
    """How permute_gather launches its kernel for an n_out-element output
    of `dtype` (f32 or f64) on a CUDA device, without launching it: the
    tile (outputs per block), threads per block, blocks per SM, the grid,
    and the dynamic shared memory per block in bytes."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"permute_launch_shape: {device} is not a CUDA "
                         f"device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"permute_launch_shape: dtype must be f32 or f64, "
                        f"not {dtype}")
    lib = _build.load()
    shape = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device):
        _build.check(lib.g4s_permute_gather_shape(
            int(dtype == torch.float64), int(n_out), shape),
            "g4s_permute_gather_shape")
    return dict(zip(("tile", "threads", "blocks_per_sm", "grid",
                     "smem_bytes"), shape))


def apply_permute(plan: PermutePlan, z: torch.Tensor) -> torch.Tensor:
    """out[i] = z[sigma[i]] for flat z of length plan.m."""
    if z.shape != (plan.m,):
        raise ValueError(f"apply_permute: z has shape {tuple(z.shape)}, "
                         f"plan expects ({plan.m},)")
    return permute_gather(z, plan.sigma)
