"""WSELL-K SpMV: the general windowed-ELL product (counterpart of
g4s_tpu/ops/pallas_spmv.py, its WSELL-K half).

The host packers are the reference's, unchanged, so a pack built here is
identical array for array: rows come in packs of 8*(128/W) rows, each pack
carries K 128-aligned x windows (`starts`), and each stored entry an int16
code slot*128 + offset into them. The reference evaluates the pack with the
Pallas kernel `_wsell_kernel`; here the csrc/wsell_spmv.cu kernel reads the
same arrays on Hopper, one thread per row. `groups` (tile runs sharing one
window count) exists to unroll TPU loops; it is kept for parity and the
kernel ignores it.

`spmv_wsell_chain` keeps the chain semantics: input and output are padded
to `_chain_pad(packed)` with zeros past n_rows, so solvers can chain
products with no per-call pad or slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.kernels import _build
from g4s_tpu_torch.sparse.containers import (CSR, as_numpy, as_tensor,
                                              resolve_device)
from g4s_tpu_torch.sparse.convert import ell_arrays

# launches of the wsell_spmv kernel (CUDA tensors only)
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class WSELL:
    """Packed K-windowed ELL operator."""

    starts: torch.Tensor   # (n_packs_pad*K,) int32 aligned block ids, flat
    lanes: torch.Tensor    # (n_tiles, PPT, 8, 128) int16: slot*128 + offset
    vals: torch.Tensor     # (n_tiles, PPT, 8, 128) dtype
    width: int             # W, padded entries/row, divides 128
    n_rows: int
    n_cols: int
    ppt: int               # packs per tile
    k: int                 # window slots per pack (max over packs)
    shape: Tuple[int, int]
    # consecutive tile runs (tile_count, K_g) needing at most K_g windows
    groups: Tuple[Tuple[int, int], ...]

    @property
    def rows_per_pack(self) -> int:
        return 8 * (128 // self.width)

    @property
    def rows_padded(self) -> int:
        """Number of packed rows (a multiple of the pack size)."""
        return self.lanes.shape[0] * self.ppt * self.rows_per_pack


def _width_for(deg: np.ndarray, width: Optional[int]) -> int:
    max_deg = int(deg.max()) if deg.size else 1
    if width is None:
        width = 1
        while width < max_deg:
            width *= 2
        width = min(width, 128)
    return width


def wsell_block_sort_perm(a: CSR, *, width: Optional[int] = None,
                          packs_per_tile: int = 64):
    """Row permutation sorting WSELL packs by their window count, at
    128-block granularity (None when packs aren't block-sized or already
    sorted). Window counts are invariant under a 128-block-granular
    symmetric permutation, so applying it before pack_wsell makes tiles
    K-homogeneous without altering any pack's cost. The tail partial block
    stays fixed."""
    indptr = as_numpy(a.indptr)
    deg = np.diff(indptr)
    width = _width_for(deg, width)
    rpp = 8 * (128 // width)
    n_rows = a.shape[0]
    if rpp % 128 or n_rows < 2 * rpp:
        return None
    n_full = (n_rows // rpp) * rpp           # rows in full packs
    cols = as_numpy(a.indices).astype(np.int64)
    rows_of = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    sel = rows_of < n_full
    key = (rows_of[sel] // rpp) * (1 << 40) + (cols[sel] >> 7)
    uniq = np.unique(key)
    counts = np.bincount((uniq >> 40).astype(np.int64),
                         minlength=n_full // rpp)
    order = np.argsort(counts, kind="stable")
    if (order == np.arange(order.size)).all():
        return None
    perm = np.concatenate(
        [(order[:, None] * rpp + np.arange(rpp)).reshape(-1),
         np.arange(n_full, n_rows, dtype=np.int64)])
    return perm.astype(np.int64)


def pack_wsell(a: CSR, *, device="cuda", width: Optional[int] = None,
               packs_per_tile: int = 128, k_max: int = 32,
               dtype=torch.float32) -> WSELL:
    """Host-side packer: choose W from the max degree, group rows into
    packs of 8*(128/W), and give each pack the sorted set of distinct
    128-aligned x-blocks its columns touch. Raises ValueError when any pack
    needs more than k_max windows (the caller picks another layout)."""
    device = resolve_device(device)
    if k_max > 255:
        raise ValueError("k_max > 255 overflows the int16 lane encoding")
    deg = np.diff(as_numpy(a.indptr))
    max_deg = int(deg.max()) if deg.size else 1
    width = _width_for(deg, width)
    if 128 % width or max_deg > width:
        raise ValueError(f"width {width} invalid for max degree {max_deg}")

    rpp = 8 * (128 // width)
    n_rows, n_cols = a.shape
    n_packs = -(-n_rows // rpp)
    n_tiles = -(-n_packs // packs_per_tile)
    if n_rows == n_cols:
        # chain mode needs the padded result to double as the next padded
        # input: rows_pad >= roundup(n_cols, 128) + 128 guard block
        need = -(-n_cols // 128) * 128 + 128
        while n_tiles * packs_per_tile * rpp < need:
            n_tiles += 1
    n_packs_pad = n_tiles * packs_per_tile
    rows_pad = n_packs_pad * rpp

    ell_cols, ell_vals = ell_arrays(a, width=width, pad_to=width)
    cols = np.zeros((rows_pad, width), np.int64)
    vals = np.zeros((rows_pad, width), np.float64)
    cols[: n_rows] = ell_cols
    vals[: n_rows] = ell_vals
    mask = vals != 0

    colsP = cols.reshape(n_packs_pad, rpp * width)
    maskP = mask.reshape(n_packs_pad, rpp * width)
    blocksP = colsP >> 7                       # 128-aligned block id

    # per-pack distinct blocks: unique (pack, block) pairs, by pack
    epp = rpp * width
    pack_of = np.repeat(np.arange(n_packs_pad, dtype=np.int64), epp)
    nb = int(blocksP.max(initial=0)) + 2
    key = pack_of * nb + np.where(maskP.reshape(-1), blocksP.reshape(-1), -1)
    uniq = np.unique(key[key >= (pack_of * nb)])     # masked-out dropped
    u_pack = uniq // nb
    u_block = uniq % nb
    seg_start = np.searchsorted(u_pack, np.arange(n_packs_pad))
    seg_end = np.searchsorted(u_pack, np.arange(n_packs_pad), side="right")
    counts = seg_end - seg_start
    K = max(int(counts.max(initial=1)), 1)
    if K > k_max:
        worst = int(counts.argmax())
        raise ValueError(
            f"pack {worst} touches {counts.max()} x-blocks > k_max={k_max}; "
            "use another layout or reorder rows")
    # starts[p, j] = j-th distinct block of pack p (unused slots repeat the
    # first block so every read stays in range)
    starts = np.zeros((n_packs_pad, K), np.int64)
    slot_j = np.arange(len(uniq)) - seg_start[u_pack]
    starts[u_pack, slot_j] = u_block
    first = np.where(counts > 0, starts[:, 0], 0)
    pad_cols = np.arange(K)[None, :] >= counts[:, None]
    starts = np.where(pad_cols, first[:, None], starts)
    # per-entry slot = searchsorted within its pack's sorted block list
    fill_block = np.where(maskP, blocksP, first[:, None])
    flat_key = pack_of * nb + fill_block.reshape(-1)
    slot = (np.searchsorted(uniq, flat_key) - seg_start[pack_of]) \
        .astype(np.int32).reshape(n_packs_pad, epp)

    loc = slot * 128 + (colsP & 127).astype(np.int32)
    loc = np.where(maskP, loc, 0)

    lanes8 = loc.reshape(n_packs_pad, 8, 128).astype(np.int16)
    vals8 = vals.reshape(n_packs_pad, 8, 128)

    # tile groups: consecutive tiles sharing the same max per-pack window
    # count (kept for parity with the reference pack)
    kc_pack = np.zeros(n_packs_pad, np.int64)
    np.maximum.at(kc_pack, np.nonzero(maskP)[0], slot[maskP] + 1)
    kc_tile = np.maximum(
        kc_pack.reshape(n_tiles, packs_per_tile).max(axis=1), 1)
    groups = []
    t = 0
    while t < n_tiles:
        t1 = t
        while t1 < n_tiles and kc_tile[t1] == kc_tile[t]:
            t1 += 1
        groups.append([t1 - t, int(kc_tile[t])])
        t = t1
    # merge the shortest run into a neighbor (max K wins) until few remain
    while len(groups) > 4:
        j = min(range(len(groups)), key=lambda q: groups[q][0])
        nb = j + 1 if j + 1 < len(groups) else j - 1
        lo_, hi_ = min(j, nb), max(j, nb)
        groups[lo_] = [groups[lo_][0] + groups[hi_][0],
                       max(groups[lo_][1], groups[hi_][1])]
        del groups[hi_]
    groups = [(c, k) for c, k in groups]

    shape4 = (n_tiles, packs_per_tile, 8, 128)
    return WSELL(
        as_tensor(starts.reshape(-1), np.int32).to(device),
        as_tensor(lanes8.reshape(shape4)).to(device),
        as_tensor(vals8.reshape(shape4)).to(device=device, dtype=dtype),
        width, n_rows, n_cols, packs_per_tile, K, a.shape, tuple(groups))


def _chain_pad(packed: WSELL) -> int:
    """Padded vector length of spmv_wsell_chain (input and output)."""
    return max(packed.rows_padded, -(-packed.n_cols // 128) * 128 + 128)


def _spmv_wsell_plain(packed: WSELL, x_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the wsell_spmv kernel: same pack, same
    chain-padded input and output."""
    code = packed.lanes.reshape(-1).long()
    pack = torch.arange(code.numel(), device=code.device) // 1024
    col = packed.starts.long()[pack * packed.k + (code >> 7)] * 128 \
        + (code & 127)
    y = (packed.vals.reshape(-1) * x_pad[col]) \
        .view(packed.rows_padded, packed.width).sum(dim=1)
    tail = _chain_pad(packed) - packed.rows_padded
    return torch.nn.functional.pad(y, (0, tail)) if tail else y


def spmv_wsell_chain(packed: WSELL, x_pad: torch.Tensor) -> torch.Tensor:
    """y_pad = A @ x_pad with no per-call pad/slice copies.

    x_pad: (_chain_pad(packed),) with x in [0, n_cols) and zeros beyond;
    returns the padded y of the same length, zero past n_rows. A CUDA
    tensor goes through the wsell_spmv kernel (f32 only, like the
    reference pack); a CPU tensor through its plain PyTorch version."""
    global LAUNCHES
    n_pad = _chain_pad(packed)
    if x_pad.device.type == "cpu":
        return _spmv_wsell_plain(packed, x_pad)
    if not x_pad.is_cuda:
        raise ValueError(f"spmv_wsell_chain: unsupported device "
                         f"{x_pad.device}")
    if x_pad.dtype != torch.float32 or packed.vals.dtype != torch.float32:
        raise TypeError("spmv_wsell_chain: the kernel takes f32 x and "
                        "f32 vals only")
    if x_pad.shape != (n_pad,) or not x_pad.is_contiguous():
        raise ValueError(f"spmv_wsell_chain: x_pad must be contiguous of "
                         f"shape ({n_pad},), not {tuple(x_pad.shape)}")
    for name, t, dt in (("starts", packed.starts, torch.int32),
                        ("lanes", packed.lanes, torch.int16),
                        ("vals", packed.vals, torch.float32)):
        if t.device != x_pad.device or t.dtype != dt \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"spmv_wsell_chain: {name} must be a "
                             f"contiguous, 16-byte aligned {dt} tensor on "
                             f"{x_pad.device}")
    y = torch.empty((n_pad,), dtype=torch.float32, device=x_pad.device)
    lib = _build.load()
    with torch.cuda.device(x_pad.device):
        rc = lib.g4s_wsell_spmv_f32(
            packed.starts.data_ptr(), packed.lanes.data_ptr(),
            packed.vals.data_ptr(), x_pad.data_ptr(), y.data_ptr(),
            packed.rows_padded, n_pad, packed.width, packed.rows_per_pack,
            packed.k, torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    _build.check(rc, "g4s_wsell_spmv_f32")
    return y


def spmv_wsell(packed: WSELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the WSELL-K pack. x: (n_cols,)."""
    x_pad = torch.zeros((_chain_pad(packed),), dtype=x.dtype,
                        device=x.device)
    x_pad[: packed.n_cols] = x
    return spmv_wsell_chain(packed, x_pad)[: packed.n_rows]
