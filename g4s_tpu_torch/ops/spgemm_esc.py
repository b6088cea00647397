"""Expand / sort / compress SpGEMM with class-tiled broadcasting
(counterpart of g4s_tpu/ops/spgemm_esc.py, its sorted tier).

  expand   elementary products a_ik * b_kj are made by shape, not by
           index: the inner index k is partitioned into classes of equal
           padded (Mh = pow2-rounded A-column count, W = rounded B-row
           length); one class is a dense (nb, Mh, W) broadcast product of
           an (nb, Mh, 1) A slab and an (nb, 1, W) B slab. The slabs are
           filled by two monotone spreads (ops/shifts.py) from the value
           arrays after one small reorder (a stable sort on precomputed
           ranks).
  sort     products move to C-slot order by one stable sort under static
           keys (row * n + col; a (major, minor) pair when that overflows
           int32), so the merge metadata below is known at plan time.
  compress pad products drop via a monotone `compact`; equal-slot runs
           reduce with `runsum` (exact tree adds); head sums compact to
           C.data.

`esc_plan` is the symbolic phase on the host, O(flop): its heavy passes
run in the native plan core (runtime/native/host_kernels.cc's
g4s_esc_plan_core, a few fused loops and one radix sort), or in numpy with
use_native=False, which gives the same arrays bit for bit;
`esc_plan_device` runs those passes on the device; `esc_numeric` is the
value phase, reusable across value updates. Each class is one broadcast
multiply: on a GPU that is one launch per class. The reference's
Benes-routed tier and its family-bucketed symbolic are not ported: they
exist for TPU gathers and XLA recompiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.obs.timings import device_ms
from g4s_tpu_torch.ops.shifts import compact, runsum, spread, stages_for
from g4s_tpu_torch.sparse.containers import (CSC, CSR, _to, as_numpy,
                                              as_tensor, resolve_device)


@dataclasses.dataclass(frozen=True)
class ESCPlan:
    """Static schedule for C = A @ B at fixed sparsity."""

    a_rank: torch.Tensor     # (nnz_a,) stable-sort rank -> class-major order
    b_rank: torch.Tensor     # (nnz_b,)
    d_a: torch.Tensor        # (na,) spread dists into the A slabs (-1 dead)
    d_b: torch.Tensor        # (nb_len,)
    d_pad: torch.Tensor      # (m2,) pad-compaction dists
    keys: torch.Tensor       # (F,) static C-slot keys (flat int32, or the
                             # major key when keys_minor is present)
    keys_minor: Optional[torch.Tensor]   # (F,) int32 minor key, m*n >= 2^31
    off_c: torch.Tensor      # (F,) position within equal-key run after sort
    d_head: torch.Tensor     # (F,) head-compaction dists
    c_indptr: Optional[torch.Tensor]
    c_indices: Optional[torch.Tensor]
    # classes: (nb, Mh, W, a_off, b_off) per class, product regions in order
    classes: Tuple[Tuple[int, int, int, int, int], ...]
    na: int                  # sum nb*Mh
    nb_len: int              # sum nb*W
    m2: int                  # sum nb*Mh*W (padded product stream)
    flops: int               # F = number of real elementary products
    nnz: int
    t_a: int
    t_b: int
    t_pad: int
    t_sum: int
    t_head: int
    shape: Tuple[int, int]
    # merge order the plan was built with ('row' -> CSR, 'col' -> CSC)
    order_by: str = "row"
    # device plans only: the sorted key stream, for materialize_structure
    keys_sorted: Optional[torch.Tensor] = None
    keys_sorted_minor: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def to(self, device) -> "ESCPlan":
        return _to(self, device)


def _round_width(l: np.ndarray) -> np.ndarray:
    """Waste-bounded width levels: exact <= 8, mult-of-4 <= 32, mult-of-16
    <= 128, pow2 beyond (<= 17% pad waste, bounded class count)."""
    w = l.copy()
    m = (l > 8) & (l <= 32)
    w[m] = -(-l[m] // 4) * 4
    m = (l > 32) & (l <= 128)
    w[m] = -(-l[m] // 16) * 16
    m = l > 128
    if m.any():
        w[m] = 2 ** np.ceil(np.log2(l[m])).astype(np.int64)
    return w


def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ranges [starts[i], starts[i]+counts[i]) — O(total)
    via repeat (no per-element binary search)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    return (np.repeat(starts - (ends - counts), counts)
            + np.arange(total, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class _Partition:
    """Deterministic class partition of the inner index (host-side)."""

    m: int
    n: int
    kk: np.ndarray          # active inner indices, class-major order
    M: np.ndarray           # A-column counts per block
    L: np.ndarray           # B-row lengths per block
    Mh: np.ndarray          # pow2-rounded M
    W: np.ndarray           # rounded L
    a_off: np.ndarray       # (nblk+1,) slab offsets
    b_off: np.ndarray
    p_off: np.ndarray
    classes: tuple
    ac_indptr: np.ndarray   # A as CSC
    ac_rows: np.ndarray
    csc_of_csr: np.ndarray
    b_indptr: np.ndarray
    b_indices: np.ndarray

    @property
    def sizes(self):
        return (int(self.a_off[-1]), int(self.b_off[-1]),
                int(self.p_off[-1]))


def _partition(a: CSR, b: CSR) -> _Partition:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]
    a_sp = a.to_scipy().tocsc()
    a_sp.sort_indices()
    ac_indptr = a_sp.indptr.astype(np.int64)
    ac_rows = a_sp.indices.astype(np.int64)
    # CSC entry -> position in a.data (CSR): stable-sorting CSR entries by
    # column gives CSC order
    a_csr_cols = as_numpy(a.indices).astype(np.int64)
    csc_of_csr = np.argsort(a_csr_cols, kind="stable")

    b_indptr = as_numpy(b.indptr).astype(np.int64)
    b_indices = as_numpy(b.indices).astype(np.int64)

    M_all = np.diff(ac_indptr)
    L_all = np.diff(b_indptr)
    active = np.nonzero((M_all > 0) & (L_all > 0))[0]
    if active.size == 0:
        raise ValueError("empty product")
    M = M_all[active]
    L = L_all[active]
    Mh = np.maximum(1, 2 ** np.ceil(np.log2(M)).astype(np.int64))
    W = _round_width(L)

    # class-major block order
    order = np.lexsort((active, Mh * (1 << 40) + W))
    kk, M, L, Mh, W = active[order], M[order], L[order], Mh[order], W[order]
    cls_key = Mh * (1 << 40) + W
    cls_start = np.nonzero(np.concatenate(
        [[True], cls_key[1:] != cls_key[:-1]]))[0]
    cls_end = np.append(cls_start[1:], kk.size)

    a_off = np.concatenate([[0], np.cumsum(Mh)])        # per block
    b_off = np.concatenate([[0], np.cumsum(W)])
    p_off = np.concatenate([[0], np.cumsum(Mh * W)])

    classes = tuple(
        (int(e - s), int(Mh[s]), int(W[s]), int(a_off[s]), int(b_off[s]))
        for s, e in zip(cls_start, cls_end))
    return _Partition(m, n, kk, M, L, Mh, W, a_off, b_off, p_off, classes,
                      ac_indptr, ac_rows, csc_of_csr, b_indptr, b_indices)


def _check_order(order_by: str) -> None:
    if order_by not in ("row", "col"):
        raise ValueError(f"order_by must be 'row' or 'col': {order_by}")


def _check_nnz(a: CSR, b: CSR) -> None:
    if max(a.nnz, b.nnz) >= (1 << 31) - 1:
        raise NotImplementedError("nnz >= 2^31 needs int64 rank streams")


def _slab_streams(P: _Partition, a: CSR, b: CSR):
    """Host O(nnz): class-major orders of A's and B's entries (stable-sort
    ranks, inactive entries ranked to the tail by an int32 sentinel) and
    the spread distances that move them into the slabs."""
    na, nb_len, _ = P.sizes
    a_src = _expand(P.ac_indptr[P.kk], P.M)  # csc positions, class-major
    n_arows = a_src.size
    a_rank = np.full(a.nnz, np.iinfo(np.int32).max, np.int32)
    a_rank[P.csc_of_csr[a_src]] = np.arange(n_arows, dtype=np.int32)
    a_dest = _expand(P.a_off[:-1], P.M)      # slab dest per (block, r)
    d_a = np.full(na, -1, np.int32)
    d_a[:n_arows] = (a_dest - np.arange(n_arows)).astype(np.int32)
    t_a = stages_for(int(d_a[:n_arows].max(initial=0)))

    b_src = _expand(P.b_indptr[P.kk], P.L)   # b.data positions
    n_brows = b_src.size
    b_rank = np.full(b.nnz, np.iinfo(np.int32).max, np.int32)
    b_rank[b_src] = np.arange(n_brows, dtype=np.int32)
    b_dest = _expand(P.b_off[:-1], P.L)
    d_b = np.full(nb_len, -1, np.int32)
    d_b[:n_brows] = (b_dest - np.arange(n_brows)).astype(np.int32)
    t_b = stages_for(int(d_b[:n_brows].max(initial=0)))
    return a_src, a_rank, d_a, t_a, b_src, b_rank, d_b, t_b


def esc_plan(a: CSR, b: CSR, *, order_by: str = "row",
             device="cuda", use_native: bool = True) -> ESCPlan:
    """Symbolic phase: class partition, spread distances, sort metadata
    and C's exact structure on the host (O(flop)), staged on `device`.

    order_by="row" merges products in row-major slot order and emits CSR
    structure; order_by="col" merges column-major: the one stable sort
    under j*m+i keys is the k-way column merge of the reference's heap
    engine, and C comes out as CSC with rows sorted within columns.
    use_native=True runs the O(flop) passes in the native plan core
    (runtime/native_lib.esc_plan_core_native; it raises where the library
    cannot be built), use_native=False in numpy: the two plans are equal
    array for array."""
    _check_order(order_by)
    device = resolve_device(device)
    P = _partition(a, b)
    m, n = P.m, P.n
    kk, M, L, W = P.kk, P.M, P.L, P.W
    p_off, ac_rows = P.p_off, P.ac_rows
    na, nb_len, m2 = P.sizes
    _check_nnz(a, b)
    t = as_tensor
    if use_native:
        from g4s_tpu_torch.runtime.native_lib import esc_plan_core_native
        F = int((M * L).sum())
        (a_rank, b_rank, d_a, d_b, d_pad, keys, kmin, off_c, d_head,
         c_indices, c_indptr, nnz, meta) = esc_plan_core_native(
            kk, M, L, P.Mh, W, P.a_off[:-1], P.b_off[:-1], p_off[:-1],
            P.ac_indptr, ac_rows, P.csc_of_csr, P.b_indptr, P.b_indices,
            a.nnz, b.nnz, n if order_by == "row" else m,
            m if order_by == "row" else n, F, na, nb_len, m2,
            order_by == "row", m * n >= (1 << 31))
        return ESCPlan(
            a_rank=t(a_rank), b_rank=t(b_rank), d_a=t(d_a), d_b=t(d_b),
            d_pad=t(d_pad), keys=t(keys),
            keys_minor=None if kmin is None else t(kmin),
            off_c=t(off_c), d_head=t(d_head), c_indptr=t(c_indptr),
            c_indices=t(c_indices), classes=P.classes, na=na,
            nb_len=nb_len, m2=m2, flops=F, nnz=nnz,
            t_a=stages_for(int(meta[1])), t_b=stages_for(int(meta[2])),
            t_pad=stages_for(int(meta[3])), t_sum=stages_for(int(meta[4])),
            t_head=stages_for(int(meta[5])), shape=(m, n),
            order_by=order_by).to(device)
    a_src, a_rank, d_a, t_a, _, b_rank, d_b, t_b = _slab_streams(P, a, b)

    # ---- product stream: real positions, keys, pad compaction ----------
    # level 1: (block, r) rows, r < M
    row_block = np.repeat(np.arange(kk.size, dtype=np.int64), M)
    row_r = np.arange(row_block.size, dtype=np.int64) - \
        np.repeat(np.cumsum(M) - M, M)
    row_pos = p_off[row_block] + row_r * W[row_block]   # start of row's lane
    row_i = ac_rows[a_src]                              # C-row of each row
    # level 2: lanes l < L of each (block, r) row
    Lr = L[row_block]
    real_pos = _expand(row_pos, Lr)
    F = real_pos.size
    j_cols = P.b_indices[_expand(P.b_indptr[kk][row_block], Lr)]
    i_rows = np.repeat(row_i, Lr)

    if order_by == "row":
        kmaj, kmin, n_min = i_rows, j_cols, n
    else:                                   # column-major: CSC output
        kmaj, kmin, n_min = j_cols, i_rows, m
    # the host simulation uses the flat int64 key; the device sort uses one
    # int32 key when the flat key fits, else the (major, minor) int32 pair
    keys_real = kmaj * np.int64(n_min) + kmin
    if m * n < (1 << 31):
        keys_dev, keys_minor = keys_real.astype(np.int32), None
    else:
        keys_dev = kmaj.astype(np.int32)
        keys_minor = kmin.astype(np.int32)

    d_pad = np.zeros(m2, np.int32)
    d_pad[real_pos] = (real_pos - np.arange(F, dtype=np.int64)) \
        .astype(np.int32)
    t_pad = stages_for(int(d_pad.max(initial=0)))

    # ---- simulate the stable sort: merge metadata ----------------------
    s_ord = np.argsort(keys_real, kind="stable")
    keys_s = keys_real[s_ord]
    head = np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
    heads = np.nonzero(head)[0]
    nnz = heads.size
    grp = np.cumsum(head) - 1
    off_c = (np.arange(F, dtype=np.int64) - heads[grp]).astype(np.int32)
    t_sum = stages_for(int(off_c.max(initial=0)))
    d_head = np.zeros(F, np.int32)
    d_head[heads] = (heads - np.arange(nnz, dtype=np.int64)) \
        .astype(np.int32)
    t_head = stages_for(int(d_head.max(initial=0)))

    uniq = keys_s[heads].astype(np.int64)
    if order_by == "row":
        major, minor, n_major = uniq // n, uniq % n, m
    else:
        major, minor, n_major = uniq // m, uniq % m, n
    c_indices = minor.astype(np.int32)
    c_indptr = np.zeros(n_major + 1, np.int64)
    np.add.at(c_indptr, major + 1, 1)
    np.cumsum(c_indptr, out=c_indptr)

    return ESCPlan(
        a_rank=t(a_rank), b_rank=t(b_rank), d_a=t(d_a), d_b=t(d_b),
        d_pad=t(d_pad), keys=t(keys_dev),
        keys_minor=None if keys_minor is None else t(keys_minor),
        off_c=t(off_c), d_head=t(d_head), c_indptr=t(c_indptr),
        c_indices=t(c_indices), classes=P.classes, na=na, nb_len=nb_len,
        m2=m2, flops=F, nnz=nnz, t_a=t_a, t_b=t_b, t_pad=t_pad,
        t_sum=t_sum, t_head=t_head, shape=(m, n),
        order_by=order_by).to(device)


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


def _class_regions(classes):
    """(nb, Mh, W, a_off, b_off, p_off) per class, p_off being the class's
    offset in the padded product stream."""
    poff = 0
    for nb, mh, w, aoff, boff in classes:
        yield nb, mh, w, aoff, boff, poff
        poff += nb * mh * w


def _flat_key(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """One int64 key ordering (major, minor) int32 pairs (both >= 0) as a
    two-key lexicographic sort would."""
    return major.long() * (1 << 31) + minor.long()


def _esc_symbolic(rows_cm, cols_cm, d_a, d_b, M_d, L_d, *, classes, na,
                  nb_len, m2, flops, t_a, t_b, t_pad, order_row, two_key,
                  n_min):
    """Device O(flop) passes of the symbolic phase: build the product-
    stream keys by the same spread/expand the numeric uses on values,
    derive the pad-compaction distances from the block mask, run the one
    stable sort on the keys, and emit the merge metadata.

    Returns (keys, keys_minor, d_pad, off_c, d_head, keys_sorted,
    keys_sorted_minor, scalars[nnz, max_off, max_dh])."""
    dev = rows_cm.device
    ra = spread(_fit(rows_cm, na), d_a, t_a)
    rb = spread(_fit(cols_cm, nb_len), d_b, t_b)
    kmaj2 = torch.empty(m2, dtype=torch.int32, device=dev)
    kmin2 = torch.empty(m2, dtype=torch.int32, device=dev)
    mask2 = torch.empty(m2, dtype=torch.bool, device=dev)
    blk = 0
    for nb, mh, w, aoff, boff, poff in _class_regions(classes):
        shape = (nb, mh, w)
        am = ra[aoff:aoff + nb * mh].view(nb, mh, 1).expand(shape)
        bm = rb[boff:boff + nb * w].view(nb, 1, w).expand(shape)
        region = slice(poff, poff + nb * mh * w)
        kmaj2[region].view(shape).copy_(am if order_row else bm)
        kmin2[region].view(shape).copy_(bm if order_row else am)
        M_c = M_d[blk:blk + nb].view(nb, 1, 1)
        L_c = L_d[blk:blk + nb].view(nb, 1, 1)
        r_i = torch.arange(mh, device=dev).view(1, mh, 1)
        l_i = torch.arange(w, device=dev).view(1, 1, w)
        mask2[region].view(shape).copy_((r_i < M_c) & (l_i < L_c))
        blk += nb
    mask_i = mask2.to(torch.int32)
    iota2 = torch.arange(m2, dtype=torch.int32, device=dev)
    f_excl = torch.cumsum(mask_i, 0, dtype=torch.int32) - mask_i
    d_pad = torch.where(mask2, iota2 - f_excl, 0).to(torch.int32)
    kmaj, kmin = (k[:flops] for k in compact((kmaj2, kmin2), d_pad, t_pad))
    head = torch.ones(flops, dtype=torch.bool, device=dev)
    if two_key:
        keys, keys_minor = kmaj, kmin
        order = torch.sort(_flat_key(kmaj, kmin), stable=True).indices
        ks, ks_min = kmaj[order], kmin[order]
        head[1:] = (ks[1:] != ks[:-1]) | (ks_min[1:] != ks_min[:-1])
    else:
        # one flat int32 key, built from the compacted pair
        keys = kmaj * n_min + kmin
        keys_minor = ks_min = None
        ks = torch.sort(keys, stable=True).values
        head[1:] = ks[1:] != ks[:-1]
    head_i = head.to(torch.int32)
    iota_f = torch.arange(flops, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(head, iota_f, 0), 0).values
    off_c = (iota_f - seg_start).to(torch.int32)
    rank = torch.cumsum(head_i, 0, dtype=torch.int32) - head_i
    d_head = torch.where(head, iota_f - rank, 0).to(torch.int32)
    scal = torch.stack([head_i.sum(), off_c.max(), d_head.max()])
    return keys, keys_minor, d_pad, off_c, d_head, ks, ks_min, scal


def esc_plan_device(a: CSR, b: CSR, *, order_by: str = "row",
                    device="cuda") -> ESCPlan:
    """Symbolic phase with the O(flop) passes on `device`.

    The host keeps only the O(nnz)/O(n) work (class partition, class-major
    streams, spread distances); the product-stream expansion, pad
    distances, the stable key sort and the merge metadata run on the
    device, and the plan's arrays are born there. One 3-scalar fetch sizes
    the stages. C's structure stays on the device until
    `materialize_structure(plan)` asks for it."""
    _check_order(order_by)
    device = resolve_device(device)
    P = _partition(a, b)
    m, n = P.m, P.n
    M, L, W = P.M, P.L, P.W
    na, nb_len, m2 = P.sizes
    _check_nnz(a, b)
    a_src, a_rank, d_a, t_a, b_src, b_rank, d_b, t_b = \
        _slab_streams(P, a, b)
    rows_cm = P.ac_rows[a_src].astype(np.int32)     # class-major C-rows
    cols_cm = P.b_indices[b_src].astype(np.int32)   # class-major C-cols

    # t_pad without materializing the stream: within block b the pad
    # distance is p_off[b]-f_start[b]+r*(W-L), maximal at r=M-1
    F = int((M * L).sum())
    f_start = np.cumsum(M * L) - M * L
    d_max = P.p_off[:-1] - f_start + (M - 1) * (W - L)
    t_pad = stages_for(int(d_max.max(initial=0)))

    order_row = order_by == "row"
    put = lambda v, dt=None: as_tensor(v, dt).to(device)  # noqa: E731
    d_a_t, d_b_t = put(d_a), put(d_b)
    (keys, keys_minor, d_pad, off_c, d_head, ks, ks_min,
     scal) = _esc_symbolic(
        put(rows_cm), put(cols_cm), d_a_t, d_b_t, put(M, np.int32),
        put(L, np.int32), classes=P.classes, na=na, nb_len=nb_len, m2=m2,
        flops=F, t_a=t_a, t_b=t_b, t_pad=t_pad, order_row=order_row,
        two_key=m * n >= (1 << 31), n_min=n if order_row else m)
    nnz, max_off, max_dh = (int(v) for v in scal.tolist())

    return ESCPlan(
        a_rank=put(a_rank), b_rank=put(b_rank), d_a=d_a_t, d_b=d_b_t,
        d_pad=d_pad, keys=keys, keys_minor=keys_minor, off_c=off_c,
        d_head=d_head, c_indptr=None, c_indices=None, classes=P.classes,
        na=na, nb_len=nb_len, m2=m2, flops=F, nnz=nnz, t_a=t_a, t_b=t_b,
        t_pad=t_pad, t_sum=stages_for(max_off), t_head=stages_for(max_dh),
        shape=(m, n), order_by=order_by, keys_sorted=ks,
        keys_sorted_minor=ks_min)


def materialize_structure(plan: ESCPlan):
    """C's (indptr int64, indices int32) on the plan's device. Host plans
    carry them already; device plans decode the sorted key stream under
    the merge order the plan was built with."""
    if plan.c_indptr is not None:
        return plan.c_indptr, plan.c_indices
    m, n = plan.shape
    n_min = n if plan.order_by == "row" else m
    n_major = m if plan.order_by == "row" else n
    heads = compact(plan.keys_sorted, plan.d_head,
                    plan.t_head)[: plan.nnz].long()
    if plan.keys_sorted_minor is None:
        major, minor = heads // n_min, heads % n_min
    else:
        major = heads
        minor = compact(plan.keys_sorted_minor, plan.d_head,
                        plan.t_head)[: plan.nnz]
    indptr = torch.zeros(n_major + 1, dtype=torch.int64, device=heads.device)
    indptr[1:] = torch.cumsum(torch.bincount(major, minlength=n_major), 0)
    return indptr, minor.to(torch.int32)


def _slot_order(plan: ESCPlan) -> torch.Tensor:
    """Stable sort of the product stream into C-slot order."""
    if plan.keys_minor is None:
        return torch.sort(plan.keys, stable=True).indices
    # flat key would overflow int32: sort the (major, minor) pair
    return torch.sort(_flat_key(plan.keys, plan.keys_minor),
                      stable=True).indices


def _reorder(data: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """data in stable rank order (inactive entries, ranked INT32_MAX, keep
    their order at the tail)."""
    return data[torch.sort(rank, stable=True).indices]


def _expand_products(xa, xb, plan: ESCPlan) -> torch.Tensor:
    """The padded product stream (m2,): one broadcast multiply per class."""
    prod = torch.empty(plan.m2, dtype=torch.promote_types(xa.dtype,
                                                          xb.dtype),
                       device=xa.device)
    for nb, mh, w, aoff, boff, poff in _class_regions(plan.classes):
        torch.mul(xa[aoff:aoff + nb * mh].view(nb, mh, 1),
                  xb[boff:boff + nb * w].view(nb, 1, w),
                  out=prod[poff:poff + nb * mh * w].view(nb, mh, w))
    return prod


def esc_numeric(a_data: torch.Tensor, b_data: torch.Tensor,
                plan: ESCPlan) -> torch.Tensor:
    """Value phase on the plan's device: C.data (in the plan's C-structure
    order) from A's and B's values. Reusable across value updates."""
    dev = plan.device
    av = _reorder(a_data.to(dev), plan.a_rank)
    bv = _reorder(b_data.to(dev), plan.b_rank)
    xa = spread(_fit(av, plan.na), plan.d_a, plan.t_a)
    xb = spread(_fit(bv, plan.nb_len), plan.d_b, plan.t_b)
    prod = _expand_products(xa, xb, plan)
    prod = compact(prod, plan.d_pad, plan.t_pad)[: plan.flops]
    sums = runsum(prod[_slot_order(plan)], plan.off_c, plan.t_sum)
    return compact(sums, plan.d_head, plan.t_head)[: plan.nnz]


def spgemm_esc(a: CSR, b: CSR, *, plan: ESCPlan | None = None,
               device="cuda") -> CSR:
    """C = A @ B through the ESC engine (a plan pins the device)."""
    if plan is None:
        plan = esc_plan(a, b, device=device)
    c_data = esc_numeric(a.data, b.data, plan)
    return CSR(plan.c_indptr, plan.c_indices, c_data, plan.shape)


def esc_numeric_staged(a_data: torch.Tensor, b_data: torch.Tensor,
                       plan: ESCPlan):
    """Numeric phase with per-stage device times: returns
    (c_data, {stage: ms}). Each stage runs and is timed on its own, so the
    total exceeds one esc_numeric call: use it for attribution."""
    dev = plan.device
    out = {}

    def timed(name, f, *args):
        out[name] = device_ms(lambda: f(*args), device=dev, reps=4)
        return f(*args)

    av = timed("reorder_a", _reorder, a_data.to(dev), plan.a_rank)
    bv = timed("reorder_b", _reorder, b_data.to(dev), plan.b_rank)
    xa = timed("spread_a", lambda v: spread(_fit(v, plan.na), plan.d_a,
                                            plan.t_a), av)
    xb = timed("spread_b", lambda v: spread(_fit(v, plan.nb_len), plan.d_b,
                                            plan.t_b), bv)
    prod = timed("expand", _expand_products, xa, xb, plan)
    prod = timed("compact_pads", lambda p: compact(
        p, plan.d_pad, plan.t_pad)[: plan.flops], prod)
    prod_s = timed("sort", lambda p: p[_slot_order(plan)], prod)
    sums = timed("runsum", runsum, prod_s, plan.off_c, plan.t_sum)
    c = timed("compact_heads", lambda s: compact(
        s, plan.d_head, plan.t_head)[: plan.nnz], sums)
    return c, out


def spgemm_esc_col(a: CSR, b: CSR, *, plan: ESCPlan | None = None,
                   device="cuda") -> CSC:
    """Column-wise C = A @ B, the heap engine's role: the same expansion,
    but the merge sorts under column-major keys, so the one stable sort is
    a k-way merge of each C column's sorted contributions and the result
    is CSC with in-column rows sorted by construction."""
    if plan is None:
        plan = esc_plan(a, b, order_by="col", device=device)
    c_data = esc_numeric(a.data, b.data, plan)
    return CSC(plan.c_indptr, plan.c_indices, c_data, plan.shape)
