"""BWELL SpMV: the packed windowed-ELL product (counterpart of
g4s_tpu/ops/pallas_spmv.py, its BWELL half).

The host packer is the reference's, unchanged, so a pack built here is
identical array for array: rows come in packs of 8*(128/W) rows and every
stored entry holds an int32 lane in [0, 256) into a 256-wide x window made
of two 128-aligned blocks, starting at block `starts[w]`. Mode "pack" gives
each pack one window; mode "row" gives each of a pack's 8 gather rows (128/W
consecutive matrix rows) its own. The reference evaluates the pack with the
Pallas kernel `_kernel`; here csrc/bwell_spmv.cu reads the same arrays on
Hopper, one thread per row: in flat order row r's W entries sit at
r*W .. r*W+W-1 and its window is

    mode "pack": w(r) = r // rows_per_pack
    mode "row":  w(r) = (r // rows_per_pack) * 8
                        + (r % rows_per_pack) // (128 / W)

so the one-hot segment matmul, the two-block staging and `packs_per_batch`
(which only tiled the TPU loop) have no counterpart.
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

# launches of the bwell_spmv kernel (CUDA tensors only)
LAUNCHES = 0

X_PAD = 256   # x is padded by two aligned blocks: every window is in range


@dataclasses.dataclass(frozen=True)
class BWELL:
    """Packed windowed-ELL operator."""

    starts: torch.Tensor   # int32 aligned block ids: (n_packs_pad,) for mode
                           # "pack", (n_packs_pad*8,) for mode "row"
    lanes: torch.Tensor    # (n_tiles, PPT, 8, 128) int32 in [0, 256)
    vals: torch.Tensor     # (n_tiles, PPT, 8, 128) f32
    width: int             # W, padded entries per row, divides 128
    n_rows: int
    n_cols: int
    ppt: int               # packs per tile
    shape: Tuple[int, int]
    mode: str              # "pack" | "row"

    @property
    def rows_per_pack(self) -> int:
        return 8 * (128 // self.width)

    @property
    def rows_padded(self) -> int:
        """Number of packed rows (a multiple of the pack size)."""
        return self.lanes.shape[0] * self.ppt * self.rows_per_pack


def _window_lanes(colsG, maskG, what):
    """Aligned window block per group and each entry's lane in it; raises
    when a group's columns do not fit two consecutive aligned blocks."""
    n_groups = colsG.shape[0]
    big = np.iinfo(np.int64).max
    cm = np.where(maskG, colsG, big)
    min_col = cm.reshape(n_groups, -1).min(axis=1)
    min_col[min_col == big] = 0
    b0 = min_col // 128
    base = (b0 * 128).reshape((n_groups,) + (1,) * (colsG.ndim - 1))
    lanes = np.where(maskG, colsG, base) - base
    if lanes.max(initial=0) >= 256 or lanes.min(initial=0) < 0:
        bad = int((lanes.reshape(n_groups, -1).max(axis=1) >= 256).sum())
        raise ValueError(f"{bad}/{n_groups} {what} exceed the 256-lane "
                         "aligned window; reorder/renumber rows or use "
                         "another layout")
    return b0, lanes


def pack_bwell(a: CSR, *, width: Optional[int] = None,
               packs_per_tile: int = 64, dtype=torch.float32,
               mode: str = "auto", device="cuda") -> BWELL:
    """Host-side packer, staged on `device`.

    mode "pack": one 256-lane aligned window per pack of 8*(128/W) rows.
    mode "row": one window per gather row (128/W consecutive matrix rows),
    8 windows per pack, admitting matrices whose columns cluster per few
    rows but not per whole pack. mode "auto" tries "pack" then "row".
    Raises ValueError if no mode fits (the caller picks another layout).
    Stored zeros count as absent entries, as in the reference."""
    device = resolve_device(device)
    if mode == "auto":
        try:
            return pack_bwell(a, width=width, packs_per_tile=packs_per_tile,
                              dtype=dtype, mode="pack", device=device)
        except ValueError:
            return pack_bwell(a, width=width, packs_per_tile=packs_per_tile,
                              dtype=dtype, mode="row", device=device)
    if mode not in ("pack", "row"):
        raise ValueError(f"mode must be 'pack', 'row' or 'auto': {mode}")
    deg = np.diff(as_numpy(a.indptr))
    max_deg = int(deg.max()) if deg.size else 1
    if width is None:
        width = 1
        while width < max_deg:
            width *= 2
        width = min(width, 128)
    if 128 % width or max_deg > width:
        raise ValueError(f"width {width} invalid for max degree {max_deg}")

    rpp = 8 * (128 // width)            # rows per pack
    n_rows, n_cols = a.shape
    n_packs = -(-n_rows // rpp)
    n_tiles = -(-n_packs // packs_per_tile)
    n_packs_pad = n_tiles * packs_per_tile
    rows_pad = n_packs_pad * rpp

    ell_cols, ell_vals = ell_arrays(a, width=width, pad_to=width)
    cols = np.zeros((rows_pad, width), np.int64)
    vals = np.zeros((rows_pad, width), np.float64)
    cols[: n_rows] = ell_cols
    vals[: n_rows] = ell_vals

    mask = vals != 0
    if mode == "row":
        shape_g = (n_packs_pad * 8, rpp // 8 * width)   # one gather row each
        b0, lanes = _window_lanes(cols.reshape(shape_g),
                                  mask.reshape(shape_g),
                                  "gather rows (8 per pack)")
    else:
        shape_g = (n_packs_pad, rpp * width)
        b0, lanes = _window_lanes(cols.reshape(shape_g),
                                  mask.reshape(shape_g), "packs")

    shape4 = (n_tiles, packs_per_tile, 8, 128)
    return BWELL(
        as_tensor(b0, np.int32).to(device),
        as_tensor(lanes.reshape(shape4), np.int32).to(device),
        as_tensor(vals.reshape(shape4)).to(device=device, dtype=dtype),
        width, n_rows, n_cols, packs_per_tile, tuple(a.shape), mode)


def bwell_from_reference(arrays: dict, meta: dict, *,
                         device="cuda") -> BWELL:
    """The port's BWELL from the parts of a g4s_tpu BWELL pack, so both
    packages compute from the same operator. `arrays` holds numpy "starts",
    "lanes", "vals"; `meta` the static fields "width", "n_rows", "n_cols",
    "ppt", "shape" and "mode". Lanes outside [0, 256) and windows past
    n_cols raise: they index the kernel's reads."""
    device = resolve_device(device)
    lanes = np.asarray(arrays["lanes"])
    if lanes.size and (lanes.min() < 0 or lanes.max() >= 256):
        raise ValueError("lanes must take values in [0, 256)")
    width = int(meta["width"])
    ppt = int(meta["ppt"])
    n_windows = lanes.shape[0] * ppt * (8 if meta["mode"] == "row" else 1)
    starts = np.asarray(arrays["starts"])
    if starts.shape != (n_windows,):
        raise ValueError(f"starts has shape {starts.shape}, the pack needs "
                         f"({n_windows},)")
    if starts.size and (starts.min() < 0
                        or starts.max() * 128 > int(meta["n_cols"])):
        raise ValueError("starts must name windows within [0, n_cols]")
    return BWELL(as_tensor(starts, np.int32).to(device),
                 as_tensor(lanes, np.int32).to(device),
                 as_tensor(arrays["vals"], np.float32).to(device),
                 width, int(meta["n_rows"]), int(meta["n_cols"]), ppt,
                 tuple(int(s) for s in meta["shape"]), str(meta["mode"]))


def _window_of_row(packed: BWELL, rows: torch.Tensor) -> torch.Tensor:
    rpp = packed.rows_per_pack
    if packed.mode == "row":
        return (rows // rpp) * 8 + (rows % rpp) // (128 // packed.width)
    return rows // rpp


def _spmv_bwell_plain(packed: BWELL, x_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the bwell_spmv kernel: y (rows_padded,)
    from x_pad (n_cols + 256,), the same pack read in the same way."""
    rows = torch.arange(packed.rows_padded, device=x_pad.device)
    w = _window_of_row(packed, rows)
    base = packed.starts.long()[w] * 128                      # (rows,)
    lanes = packed.lanes.reshape(packed.rows_padded, packed.width).long()
    vals = packed.vals.reshape(packed.rows_padded, packed.width)
    return (vals * x_pad[base[:, None] + lanes]).sum(dim=1)


def spmv_bwell_padded(packed: BWELL, x_pad: torch.Tensor) -> torch.Tensor:
    """y (rows_padded,) = A @ x from x_pad (n_cols + 256,): x followed by
    zeros, so every window read is in range and the kernel does no bound
    checks. A CUDA tensor goes through the bwell_spmv kernel (f32 only,
    like the reference); a CPU tensor through its plain PyTorch version."""
    global LAUNCHES
    if x_pad.shape != (packed.n_cols + X_PAD,):
        raise ValueError(f"spmv_bwell_padded: x_pad has shape "
                         f"{tuple(x_pad.shape)}, the pack needs "
                         f"({packed.n_cols + X_PAD},)")
    if x_pad.device.type == "cpu":
        return _spmv_bwell_plain(packed, x_pad)
    if not x_pad.is_cuda:
        raise ValueError(f"spmv_bwell: unsupported device {x_pad.device}")
    for name, t, dt in (("x_pad", x_pad, torch.float32),
                        ("starts", packed.starts, torch.int32),
                        ("lanes", packed.lanes, torch.int32),
                        ("vals", packed.vals, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"spmv_bwell: the kernel takes {name} as {dt}, "
                            f"not {t.dtype}")
        if t.device != x_pad.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"spmv_bwell: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {x_pad.device}")
    y = torch.empty((packed.rows_padded,), dtype=torch.float32,
                    device=x_pad.device)
    lib = _build.load()
    with torch.cuda.device(x_pad.device):
        rc = lib.g4s_bwell_spmv_f32(
            packed.starts.data_ptr(), packed.lanes.data_ptr(),
            packed.vals.data_ptr(), x_pad.data_ptr(), y.data_ptr(),
            packed.rows_padded, packed.width, packed.rows_per_pack,
            1 if packed.mode == "row" else 0,
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    _build.check(rc, "g4s_bwell_spmv_f32")
    return y


def spmv_bwell(packed: BWELL, x: torch.Tensor, *,
               packs_per_batch: int | None = None) -> torch.Tensor:
    """y = A @ x over the BWELL pack. x: (n_cols,).

    `packs_per_batch` only tiled the TPU kernel's loop: it is checked as
    the reference checks it (it must divide the packs per tile) and
    otherwise ignored."""
    pb = packs_per_batch or packed.ppt
    if packed.ppt % pb:
        raise ValueError(f"packs_per_batch {pb} must divide ppt {packed.ppt}")
    if x.shape != (packed.n_cols,):
        raise ValueError(f"spmv_bwell: x has shape {tuple(x.shape)}, the "
                         f"pack needs ({packed.n_cols},)")
    x_pad = torch.zeros((packed.n_cols + X_PAD,), dtype=x.dtype,
                        device=x.device)
    x_pad[: packed.n_cols] = x
    return spmv_bwell_padded(packed, x_pad)[: packed.n_rows]
