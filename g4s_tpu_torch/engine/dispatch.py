"""The graph engine: mxv/vxm dispatch over layout variants (counterpart of
g4s_tpu/engine/dispatch.py).

`build_graph` picks a layout from row statistics on the host, once, with
the reference's rules: DIA (banded, possibly after an RCM renumbering),
DENSE (small or dense-ish), then on CUDA the kernel layouts — WSELL-K after
RCM and a block sort, WSELL-K in the given numbering, or the streaming
schedule for unstructured patterns — and otherwise ELL or CSR. The
reference gates its kernel layouts on a TPU backend; the port gates them
on a CUDA `device`.

Semiring-generic: padded slots are neutralized with the semiring's
additive identity, so min-plus/or-and algebras run through the same paths.

`mxm` is the SpGEMM entry: the two-phase engine (ops/spgemm.py), or for
plus-times on a CUDA device with enough products the ESC engine
(ops/spgemm_esc.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.engine.semiring import PLUS_TIMES, Semiring
from g4s_tpu_torch.ops.route import build_permute_plan, permute_gather
from g4s_tpu_torch.ops.segment import segment_reduce
from g4s_tpu_torch.ops.stream_spmv import StreamPlan
from g4s_tpu_torch.ops.wsell_spmv import WSELL
from g4s_tpu_torch.sparse.containers import (CSR, DIA, ELL, as_numpy,
                                              as_tensor, resolve_device)
from g4s_tpu_torch.sparse.convert import csr_to_dense, csr_to_dia, csr_to_ell

_ADD_OPS = {"plus_times": "add", "min_plus": "min", "max_plus": "max",
            "max_times": "max", "or_and": "add"}


@dataclasses.dataclass(frozen=True)
class Graph:
    """A sparse operator staged for the engine: the chosen layout plus what
    any semiring needs. `deg` (per-row degree) is the padding mask source.
    """

    ell: Optional[ELL]              # padded layout
    csr: Optional[CSR]              # stored-entry layout
    dia: Optional[DIA]              # banded layout
    row_ids: Optional[torch.Tensor]  # (nnz,) row of each stored entry
    deg: torch.Tensor               # (n_rows,) true row degrees
    dense: Optional[torch.Tensor]   # materialized (n_rows, n_cols)
    wsell: Optional[WSELL]          # WSELL-K pack (kernel layout, CUDA)
    perm: Optional[torch.Tensor]    # RCM row/col order (layout stores A[p,p])
    iperm: Optional[torch.Tensor]   # inverse permutation
    variant: str                    # dense|dia|wsell|stream|ell|csr
    shape: Tuple[int, int]
    stream: Optional[StreamPlan] = None  # streaming schedule (CUDA)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]


def _i32(a, device) -> torch.Tensor:
    return as_tensor(a, np.int32).to(device)


def build_graph(a: CSR, *, device="cuda", variant: str | None = None,
                max_padding_waste: float = 1.5, pad_to: int = 8,
                max_diags: int = 48, dense_threshold: int = 1 << 21,
                dtype=None, reorder: bool = True) -> Graph:
    """Choose the execution layout from row statistics (host-side, once)
    and stage it on `device`. The kernel layouts (wsell, stream) are
    candidates only on a CUDA device.

    Order of preference: DIA (banded, gather-free), DENSE (small or
    dense-ish operators), RCM renumbering to DIA, then on CUDA WSELL-K or
    the streaming schedule, then ELL (uniform degrees) or CSR (skew)."""
    device = resolve_device(device)
    return _build_graph(a, device=device,
                        kernel_layouts=device.type == "cuda",
                        variant=variant, max_padding_waste=max_padding_waste,
                        pad_to=pad_to, max_diags=max_diags,
                        dense_threshold=dense_threshold, dtype=dtype,
                        reorder=reorder)


def _build_graph(a: CSR, *, device, kernel_layouts: bool, variant,
                 max_padding_waste, pad_to, max_diags, dense_threshold,
                 dtype, reorder) -> Graph:
    """build_graph with the kernel-layout gate made explicit: the CUDA
    rules run on any device's tensors when `kernel_layouts` is set."""
    indptr = as_numpy(a.indptr)
    deg = np.diff(indptr).astype(np.int32)
    nnz = max(int(deg.sum()), 1)
    width = int(deg.max()) if deg.size else 0
    waste = (width * a.shape[0] - nnz) / nnz if nnz else 0.0
    size = a.shape[0] * a.shape[1]
    deg_t = _i32(deg, device)

    def row_ids():
        return _i32(np.repeat(np.arange(a.shape[0], dtype=np.int32), deg),
                    device)

    if variant is None:
        if a.shape[0] == a.shape[1] and nnz > 1:
            offs = np.unique(as_numpy(a.indices).astype(np.int64)
                             - np.repeat(np.arange(a.shape[0],
                                                   dtype=np.int64), deg))
            dia_waste = offs.size * a.shape[0] / nnz
            if offs.size <= max_diags and dia_waste <= 2.0 + max_padding_waste:
                variant = "dia"
        if variant is None and 0 < size <= dense_threshold and (
                nnz / size >= 0.05 or size <= 1 << 18):
            variant = "dense"
        if variant is None and reorder and a.shape[0] == a.shape[1] \
                and nnz > 1:
            # no structured layout fits the given numbering: try RCM
            from scipy.sparse.csgraph import reverse_cuthill_mckee
            sp_a = a.to_scipy().tocsr()
            perm = np.asarray(reverse_cuthill_mckee(sp_a,
                                                    symmetric_mode=False))
            ap = sp_a[perm][:, perm].tocsr()
            deg_p = np.diff(ap.indptr).astype(np.int64)
            offs_p = np.unique(ap.indices.astype(np.int64)
                               - np.repeat(np.arange(ap.shape[0],
                                                     dtype=np.int64), deg_p))
            dia_waste_p = offs_p.size * ap.shape[0] / nnz
            if offs_p.size <= max_diags and \
                    dia_waste_p <= 2.0 + max_padding_waste:
                inv = np.empty_like(perm)
                inv[perm] = np.arange(perm.size)
                dia = csr_to_dia(CSR.from_scipy(ap)).to(device)
                return Graph(None, None, dia, None, deg_t, None, None,
                             _i32(perm, device), _i32(inv, device), "dia",
                             a.shape)
            if kernel_layouts:
                # RCM localized but not to a narrow band (mesh matrices:
                # bandwidth ~n^(2/3)) -> the general WSELL-K kernel, with
                # packs sorted by window count (block-granular, so counts
                # are invariant) to keep tiles K-homogeneous
                from g4s_tpu_torch.ops.wsell_spmv import (
                    pack_wsell, wsell_block_sort_perm)
                try:
                    sigma = wsell_block_sort_perm(CSR.from_scipy(ap))
                    if sigma is not None:
                        perm = perm[sigma]
                        ap = ap[sigma][:, sigma].tocsr()
                    packed = pack_wsell(CSR.from_scipy(ap), device=device)
                    inv = np.empty_like(perm)
                    inv[perm] = np.arange(perm.size)
                    return Graph(None, a.to(device), None, row_ids(), deg_t,
                                 None, packed, _i32(perm, device),
                                 _i32(inv, device), "wsell", a.shape)
                except ValueError:
                    pass
        if variant is None and kernel_layouts \
                and width <= 128 and nnz > 1 and size > dense_threshold:
            # already-local numbering (no reorder / rectangular): try the
            # WSELL pack directly, no permutation
            from g4s_tpu_torch.ops.wsell_spmv import pack_wsell
            try:
                packed = pack_wsell(a, device=device)
                return Graph(None, a.to(device), None, row_ids(), deg_t,
                             None, packed, None, None, "wsell", a.shape)
            except ValueError:
                pass
        if variant is None:
            variant = "ell" if waste <= max_padding_waste else "csr"
        if variant == "csr" and kernel_layouts and nnz >= (1 << 16):
            # unstructured pattern with no window locality: the streaming
            # schedule (expand -> permute -> reduce, ops/stream_spmv.py)
            from g4s_tpu_torch.ops.stream_spmv import build_stream_plan
            try:
                splan = build_stream_plan(a, device=device)
                return Graph(None, a.to(device), None, row_ids(), deg_t,
                             None, None, None, None, "stream", a.shape,
                             stream=splan)
            except NotImplementedError:
                pass
    if variant == "dense":
        d = as_tensor(csr_to_dense(a)).to(device)
        if dtype is not None:
            d = d.to(dtype)
        # keep the CSR too: non-plus_times semirings and reduce_vector must
        # see stored entries only (structural zeros would corrupt min/max)
        return Graph(None, a.to(device), None, row_ids(), deg_t, d, None,
                     None, None, "dense", a.shape)
    if variant == "wsell":
        from g4s_tpu_torch.ops.wsell_spmv import pack_wsell
        packed = pack_wsell(a, device=device)
        return Graph(None, a.to(device), None, row_ids(), deg_t, None,
                     packed, None, None, "wsell", a.shape)
    if variant == "dia":
        dia = csr_to_dia(a).to(device)
        return Graph(None, None, dia, None, deg_t, None, None, None, None,
                     "dia", a.shape)
    if variant == "ell":
        ell = csr_to_ell(a, pad_to=pad_to).to(device)
        return Graph(ell, None, None, None, deg_t, None, None, None, None,
                     "ell", a.shape)
    return Graph(None, a.to(device), None, row_ids(), deg_t, None, None,
                 None, None, "csr", a.shape)


def graph_from_reference(arrays: dict, meta: dict, *,
                         device="cuda") -> Graph:
    """Build the port's Graph from the parts of a g4s_tpu Graph, so both
    packages compute from the same operator.

    `arrays` maps names to numpy arrays, each optional:
      "csr.indptr", "csr.indices", "csr.data"; "ell.cols", "ell.vals";
      "dia.vals"; "row_ids", "deg", "dense", "perm", "iperm";
      "wsell.starts", "wsell.lanes", "wsell.vals";
      "stream.xplan", "stream.route2", "stream.rowplan" (each a plan's full
      permutation vector, of length plan.m), "stream.vals_e",
      "stream.hub_cols", "stream.hub_dense_c", "stream.hub_rows",
      "stream.hub_dense_r".
    `meta` holds the static fields: "variant", "shape", and where present
    "dia.offsets", "wsell" (a dict of width, ppt, k, groups) and "stream"
    (a dict of col_classes, slices, m, nc_pad, nr_pad).
    """
    device = resolve_device(device)

    def t(name):
        v = arrays.get(name)
        return None if v is None else as_tensor(v).to(device)

    def plan(name):
        # validates the range: these index the gather kernel's reads
        return build_permute_plan(arrays[name], device=device)

    shape = tuple(int(s) for s in meta["shape"])
    csr = ell = dia = wsell = stream = None
    if "csr.indptr" in arrays:
        csr = CSR(t("csr.indptr"), t("csr.indices"), t("csr.data"), shape)
    if "ell.cols" in arrays:
        ell = ELL(t("ell.cols"), t("ell.vals"), shape)
    if "dia.vals" in arrays:
        dia = DIA(t("dia.vals"), tuple(int(o) for o in meta["dia.offsets"]),
                  shape)
    if "wsell.starts" in arrays:
        w = meta["wsell"]
        wsell = WSELL(t("wsell.starts"), t("wsell.lanes"), t("wsell.vals"),
                      int(w["width"]), shape[0], shape[1], int(w["ppt"]),
                      int(w["k"]), shape,
                      tuple((int(c), int(k)) for c, k in w["groups"]))
    if "stream.xplan" in arrays:
        s = meta["stream"]
        stream = StreamPlan(
            plan("stream.xplan"), t("stream.vals_e"), plan("stream.route2"),
            plan("stream.rowplan"), t("stream.hub_cols"),
            t("stream.hub_dense_c"), t("stream.hub_rows"),
            t("stream.hub_dense_r"),
            tuple(tuple(int(v) for v in c) for c in s["col_classes"]),
            tuple(tuple(int(v) for v in c) for c in s["slices"]),
            shape[0], shape[1], int(s["m"]), int(s["nc_pad"]),
            int(s["nr_pad"]))
    for k in ("perm", "iperm"):
        v = arrays.get(k)
        if v is not None and v.size and (v.min() < 0 or v.max() >= shape[0]):
            raise ValueError(f"{k} must take values in [0, {shape[0]})")
    idx = {k: (None if arrays.get(k) is None else _i32(arrays[k], device))
           for k in ("row_ids", "deg", "perm", "iperm")}
    return Graph(ell, csr, dia, idx["row_ids"], idx["deg"], t("dense"),
                 wsell, idx["perm"], idx["iperm"], meta["variant"], shape,
                 stream=stream)


def permute_in(g: Graph, x: torch.Tensor, *, n_out=None) -> torch.Tensor:
    """x -> permuted space, x[perm] (permute_gather kernel on CUDA),
    followed by zeros up to n_out when it is given."""
    if g.perm is None:
        return x
    return permute_gather(x.contiguous(), g.perm, n_out=n_out)


def permute_out(g: Graph, y_p: torch.Tensor) -> torch.Tensor:
    """permuted-space result -> original numbering, y[perm[i]] = y_p[i],
    i.e. y = y_p[iperm]."""
    if g.perm is None:
        return y_p
    return permute_gather(y_p.contiguous(), g.iperm)


def _masked(y, mask, semiring: Semiring):
    if mask is None:
        return y
    return torch.where(mask, y, torch.tensor(semiring.zero, dtype=y.dtype,
                                             device=y.device))


def _csr_mxv(g: Graph, x, semiring: Semiring):
    """Stored-entry product over the CSR companion (any semiring)."""
    csr = g.csr
    prod = semiring.mul(csr.data, x[csr.indices.long()])
    return segment_reduce(prod, g.row_ids, g.shape[0],
                          op=_ADD_OPS[semiring.name], indices_are_sorted=True)


def mxv(g: Graph, x, *, semiring: Semiring = PLUS_TIMES, mask=None):
    """y = A (+.x) x over the chosen layout (GraphBLAS mxv)."""
    if x.shape[0] != g.shape[1]:
        # the permute gathers read a short x as if padded with zeros
        raise ValueError(f"mxv: x has {x.shape[0]} rows, the graph "
                         f"{g.shape[1]} columns")
    if g.variant == "dense" and semiring is PLUS_TIMES:
        from g4s_tpu_torch.engine.matmul import dense_matmul
        return _masked(dense_matmul(g.dense, x), mask, semiring)
    if g.variant == "dia":
        if semiring is not PLUS_TIMES:
            raise NotImplementedError(
                "DIA layout supports the plus_times semiring only; "
                "build the graph with variant='ell' or 'csr'")
        from g4s_tpu_torch.ops.spmv import spmv_dia
        y = permute_out(g, spmv_dia(g.dia, permute_in(g, x)))
        return _masked(y, mask, semiring)
    if g.variant == "stream" and semiring is PLUS_TIMES:
        from g4s_tpu_torch.ops.stream_spmv import spmv_stream
        return _masked(spmv_stream(g.stream, x), mask, semiring)
    if g.variant == "wsell" and semiring is PLUS_TIMES:
        from g4s_tpu_torch.ops.wsell_spmv import (_chain_pad, spmv_wsell,
                                                  spmv_wsell_chain)
        if g.perm is None:
            return _masked(spmv_wsell(g.wsell, x), mask, semiring)
        # the gather writes the chain-padded x, zeros included, and the
        # inverse gather reads the padded y: three launches in all
        x_pad = permute_in(g, x, n_out=_chain_pad(g.wsell))
        y = permute_out(g, spmv_wsell_chain(g.wsell, x_pad))
        return _masked(y, mask, semiring)
    if g.variant == "ell":
        ell = g.ell
        prod = semiring.mul(ell.vals, x[ell.cols.long()])
        if semiring is not PLUS_TIMES:
            lane = torch.arange(ell.cols.shape[1], device=prod.device)
            valid = lane[None, :] < g.deg[:, None]
            prod = torch.where(valid, prod, torch.tensor(
                semiring.zero, dtype=prod.dtype, device=prod.device))
        y = semiring.reduce(prod, axis=1)
    else:
        # csr, and the dense/stream/wsell layouts under other semirings:
        # their stored-entry CSR companion never sees structural zeros
        y = _csr_mxv(g, x, semiring)
    return _masked(y, mask, semiring)


def reduce_vector(g: Graph, *, semiring: Semiring = PLUS_TIMES):
    """Reduce all stored values of the operator (GraphBLAS reduce)."""
    if g.variant == "ell":
        vals = g.ell.vals
    elif g.variant == "dia":
        vals = g.dia.vals
    else:
        vals = g.csr.data        # stored entries only, not structural zeros
    return semiring.reduce(vals)


def vxm(g: Graph, x, *, semiring: Semiring = PLUS_TIMES, mask=None):
    """y = x (+.x) A — the GraphBLAS vxm dual of mxv
    (y_j = sum_i x_i A_ij)."""
    if g.variant == "dense" and semiring is PLUS_TIMES:
        from g4s_tpu_torch.engine.matmul import dense_matmul
        return _masked(dense_matmul(x, g.dense), mask, semiring)
    if g.variant == "dia":
        if semiring is not PLUS_TIMES:
            raise NotImplementedError(
                "DIA layout supports the plus_times semiring only")
        # y[c] = sum_o vals[o][c-o] * x[c-o]: spmv_dia with negated offsets
        n = g.shape[0]
        maxoff = max((abs(o) for o in g.dia.offsets), default=0)
        xp = permute_in(g, x)
        acc = torch.zeros((n,), dtype=torch.promote_types(g.dia.vals.dtype,
                                                          x.dtype),
                          device=x.device)
        for i, o in enumerate(g.dia.offsets):
            # row r stores A[r, r+o]; its contribution lands on column r+o
            shifted = torch.zeros((n + 2 * maxoff,), dtype=acc.dtype,
                                  device=acc.device)
            shifted[maxoff + o: maxoff + o + n] += g.dia.vals[i] * xp
            acc = acc + shifted[maxoff: maxoff + n]
        return _masked(permute_out(g, acc), mask, semiring)
    if g.variant == "ell":
        ell = g.ell
        prod = semiring.mul(ell.vals, x[:, None])
        lane = torch.arange(ell.cols.shape[1], device=prod.device)
        valid = lane[None, :] < g.deg[:, None]
        prod = torch.where(valid, prod, torch.tensor(
            semiring.zero, dtype=prod.dtype, device=prod.device))
        y = segment_reduce(prod.reshape(-1), ell.cols.reshape(-1),
                           g.shape[1], op=_ADD_OPS[semiring.name])
    else:
        csr = g.csr
        prod = semiring.mul(csr.data, x[g.row_ids.long()])
        y = segment_reduce(prod, csr.indices, g.shape[1],
                           op=_ADD_OPS[semiring.name])
    return _masked(y, mask, semiring)


_ESC_MIN_FLOPS = 1 << 18       # products; below this the take path wins


def mxm(a: CSR, b: CSR, *, semiring: Semiring = PLUS_TIMES, plan=None,
        device="cuda") -> CSR:
    """C = A (+.x) B through the two-phase symbolic/numeric engine.

    With no plan, plus-times on a CUDA device with at least
    _ESC_MIN_FLOPS products takes the ESC engine (ops/spgemm_esc.py);
    small products, the CPU and the other semirings take the gather path
    (ESC's broadcast expansion is specific to (+, *)). The reference gates
    ESC on a non-CPU JAX backend; the port on a CUDA `device`. Pass a
    SpGEMMPlan or an ESCPlan to pin the engine: the product then runs
    where the plan lives."""
    from g4s_tpu_torch.ops.spgemm import spgemm_flops, spgemm_plan
    from g4s_tpu_torch.ops.spgemm_esc import ESCPlan, esc_numeric, esc_plan
    if plan is None:
        device = resolve_device(device)
        if (semiring is PLUS_TIMES and device.type == "cuda"
                and spgemm_flops(a, b) // 2 >= _ESC_MIN_FLOPS):
            plan = esc_plan(a, b, device=device)
        else:
            plan = spgemm_plan(a, b, device=device)
    if isinstance(plan, ESCPlan):
        if semiring is not PLUS_TIMES:
            raise NotImplementedError("ESC plans implement plus_times only")
        c_data = esc_numeric(a.data, b.data, plan)
        return CSR(plan.c_indptr, plan.c_indices, c_data, plan.shape)
    dev = plan.device
    prod = semiring.mul(a.data.to(dev)[plan.src_a.long()],
                        b.data.to(dev)[plan.src_b.long()])
    c_data = segment_reduce(prod, plan.slot, plan.nnz,
                            op=_ADD_OPS[semiring.name],
                            indices_are_sorted=True)
    return CSR(plan.c_indptr, plan.c_indices, c_data, plan.shape)
