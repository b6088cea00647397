"""Two-phase SpGEMM, C = A @ B (counterpart of g4s_tpu/ops/spgemm.py).

The symbolic phase (host numpy, once per sparsity pattern) expands every
elementary product a_ik * b_kj into a (product -> output slot) map and
emits C's exact CSR structure; the numeric phase (device, reusable across
value updates) is one gather, multiply and sorted segment sum:

    c.data = segment_sum(A.data[src_a] * B.data[src_b], slot, nnz)

The expand/sort/merge variants find C's structure on the device instead,
for patterns that are not reused. `spgemm_plan` runs the symbolic phase in
the native C++ graph builder (runtime/native/host_kernels.cc, threaded
over flop-balanced row blocks) or, with use_native=False, in numpy: the two
plans are equal array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from g4s_tpu_torch.ops.segment import sorted_segment_sum
from g4s_tpu_torch.sparse.containers import (CSC, CSR, as_numpy, as_tensor,
                                              resolve_device)


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Symbolic-phase output: the product->slot map plus C's structure."""

    src_a: torch.Tensor      # (F,) product i uses A.data[src_a[i]]
    src_b: torch.Tensor      # (F,) ... and B.data[src_b[i]]
    slot: torch.Tensor       # (F,) int32 sorted output slot of product i
    c_indptr: torch.Tensor   # (m+1,) int32
    c_indices: torch.Tensor  # (nnz_c,) int32
    flops: int               # multiply count F
    nnz: int
    shape: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.slot.device


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Multiply-add flop count = 2 * sum over A's entries of the length of
    the B row they select."""
    deg_b = np.diff(as_numpy(b.indptr)).astype(np.int64)
    return int(2 * deg_b[as_numpy(a.indices)].sum())


def spgemm_plan(a: CSR, b: CSR, *, device="cuda",
                use_native: bool = True) -> SpGEMMPlan:
    """Symbolic phase (host): exact structure of C and the product->slot
    map, staged on `device`. use_native=True runs it in the native graph
    builder (runtime/native_lib.spgemm_symbolic_native; it raises where the
    library cannot be built), use_native=False in numpy."""
    device = resolve_device(device)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]
    if use_native:
        from g4s_tpu_torch.runtime.native_lib import spgemm_symbolic_native
        src_a, src_b, slot, c_rows, c_indices, nnz, F = \
            spgemm_symbolic_native(as_numpy(a.indptr), as_numpy(a.indices),
                                   as_numpy(b.indptr), as_numpy(b.indices),
                                   m, n)
    else:
        src_a, src_b, rows, F = spgemm_expand_map(a, b)
        cols = as_numpy(b.indices).astype(np.int64)[src_b]
        key = rows * n + cols
        order = np.argsort(key, kind="stable")
        src_a, src_b, key = src_a[order], src_b[order], key[order]
        uniq, slot = np.unique(key, return_inverse=True)
        nnz = int(uniq.size)
        c_rows, c_indices = uniq // n, uniq % n
    c_indptr = np.zeros(m + 1, dtype=np.int32)
    np.add.at(c_indptr, c_rows.astype(np.int64) + 1, 1)
    np.cumsum(c_indptr, out=c_indptr)

    idx_t = np.int32 if max(F, a.nnz, b.nnz, 1) < 2**31 else np.int64
    put = lambda v, dt: as_tensor(v, dt).to(device)  # noqa: E731
    return SpGEMMPlan(put(src_a, idx_t), put(src_b, idx_t),
                      put(slot, np.int32), put(c_indptr, np.int32),
                      put(c_indices, np.int32), F, nnz, (m, n))


def spgemm_numeric(a_data: torch.Tensor, b_data: torch.Tensor,
                   plan: SpGEMMPlan) -> torch.Tensor:
    """Numeric phase on the plan's device: C.data from A.data/B.data."""
    dev = plan.device
    prod = a_data.to(dev)[plan.src_a.long()] * b_data.to(dev)[
        plan.src_b.long()]
    return sorted_segment_sum(prod, plan.slot, plan.nnz)


def spgemm(a: CSR, b: CSR, *, plan: SpGEMMPlan | None = None,
           device="cuda") -> CSR:
    """C = A @ B: builds (or reuses) a symbolic plan on `device`, then runs
    the numeric phase where the plan lives."""
    if plan is None:
        plan = spgemm_plan(a, b, device=device)
    c_data = spgemm_numeric(a.data, b.data, plan)
    return CSR(plan.c_indptr, plan.c_indices, c_data, plan.shape)


def spgemm_expand_map(a: CSR, b: CSR):
    """Light symbolic phase: only the product expansion map (no sort or
    dedupe), O(F) prefix-sum work. Returns numpy (src_a, src_b, rows, F)."""
    a_indptr = as_numpy(a.indptr).astype(np.int64)
    a_indices = as_numpy(a.indices).astype(np.int64)
    b_indptr = as_numpy(b.indptr).astype(np.int64)
    m = a.shape[0]
    deg_a = np.diff(a_indptr)
    a_rows = np.repeat(np.arange(m, dtype=np.int64), deg_a)
    counts = b_indptr[a_indices + 1] - b_indptr[a_indices]
    F = int(counts.sum())
    offsets = np.zeros(a_indices.size + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    src_a = np.repeat(np.arange(a_indices.size, dtype=np.int64), counts)
    src_b = (np.arange(F, dtype=np.int64) - np.repeat(offsets[:-1], counts)
             + np.repeat(b_indptr[a_indices], counts))
    rows = a_rows[src_a]
    return src_a, src_b, rows, F


def _sort_merge_compact(key: torch.Tensor, val: torch.Tensor):
    """Sort (key, val), reduce equal-key runs, compact to the front.

    Output contract (the reference's): keys sorted ascending over
    [0, nnz), -1 beyond; merged values over [0, nnz), 0 beyond; nnz as a
    0-d tensor. The reference merges with a Hillis-Steele scan because TPU
    scatters are slow; here each run is summed in index order by
    sorted_segment_sum, so sums agree up to addition order."""
    F = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    head = torch.ones(F, dtype=torch.bool, device=key.device)
    head[1:] = key_s[1:] != key_s[:-1]
    run = torch.cumsum(head, 0) - 1
    out_key = torch.full((F,), -1, dtype=key.dtype, device=key.device)
    out_key.scatter_(0, run, key_s)          # all writers of a run agree
    out_val = sorted_segment_sum(val, run, F, order=order)
    return out_key, out_val, head.sum()


def _key_type(*sizes) -> torch.dtype:
    return torch.int32 if max(sizes) < 2**31 else torch.int64


def spgemm_device_merge(a: CSR, b: CSR, *, device="cuda"):
    """Expand/sort/merge SpGEMM with structure discovery on the device:
    the host contributes only the O(F) expansion map; the sort, duplicate
    merge and exact nnz happen on `device`. The right choice when the
    sparsity pattern is not reused.

    Returns (keys, values, nnz): `keys` (F,) = row * n_cols + col sorted
    ascending with -1 beyond `nnz`; `values` (F,) merged."""
    device = resolve_device(device)
    src_a, src_b, rows, F = spgemm_expand_map(a, b)
    m, n = a.shape[0], b.shape[1]
    kt = _key_type(m * n)
    src_a_t = as_tensor(src_a).to(device)
    src_b_t = as_tensor(src_b).to(device)
    cols = b.indices.to(device).to(kt)[src_b_t]
    key = as_tensor(rows * n).to(device).to(kt) + cols
    val = a.data.to(device)[src_a_t] * b.data.to(device)[src_b_t]
    return _sort_merge_compact(key, val)


def spgemm_via_csc(a: CSR, b: CSR, *, device="cuda") -> CSR:
    """Column-wise SpGEMM through the transposed operands,
    C = ((B^T)(A^T))^T: the column-major strategy of the reference's heap
    engine as the row-wise two-phase engine on the transposes; the final
    transpose restores row-major CSR with columns sorted by construction.
    The transposes run on the host; the product on `device`."""
    from g4s_tpu_torch.sparse.convert import csc_to_csr, csr_to_csc

    at = csr_to_csc(a)        # CSC of A == CSR of A^T (swapped shape)
    bt = csr_to_csc(b)
    a_t = CSR(bt.indptr, bt.indices, bt.data, (b.shape[1], b.shape[0]))
    b_t = CSR(at.indptr, at.indices, at.data, (a.shape[1], a.shape[0]))
    ct = spgemm(a_t, b_t, device=device)          # C^T as CSR
    return csc_to_csr(CSC(ct.indptr, ct.indices, ct.data,
                          (a.shape[0], b.shape[1])))


def _keys_to_csr(keys, vals, nnz, m: int, n: int) -> CSR:
    """CSR from the merged (keys, values, nnz) stream, on its device."""
    nnz = int(nnz)
    keys = keys[:nnz].long()
    rows = keys // n
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return CSR(indptr, keys % n, vals[:nnz], (m, n))


def spgemm_device_csr(a: CSR, b: CSR, *, device="cuda") -> CSR:
    """One-shot SpGEMM with device-side structure discovery
    (spgemm_device_merge), split into CSR on the device. Use when the
    sparsity pattern is not reused."""
    keys, vals, nnz = spgemm_device_merge(a, b, device=device)
    return _keys_to_csr(keys, vals, nnz, a.shape[0], b.shape[1])


def spgemm_device_full(a: CSR, b: CSR, *, device="cuda"):
    """One-shot SpGEMM with both the product expansion and the structure
    discovery on the device; the host counts flops only. Returns
    (keys, values, nnz) like spgemm_device_merge. The reference packs each
    side's per-entry state into one record so the TPU does one row gather
    per side; a GPU gathers each array directly."""
    device = resolve_device(device)
    m, n = a.shape[0], b.shape[1]
    F = spgemm_flops(a, b) // 2
    kt = _key_type(m * n, F, a.nnz, b.nnz)
    a_ptr = a.indptr.to(device).to(kt)
    a_idx = a.indices.to(device).long()
    b_ptr = b.indptr.to(device).to(kt)
    b_idx = b.indices.to(device).to(kt)
    deg_b = b_ptr[1:] - b_ptr[:-1]
    counts = deg_b[a_idx]                                  # (nnz_a,)
    starts = torch.cumsum(counts, 0) - counts
    # product p belongs to A-entry src_a[p]; runs are counts long
    src_a = torch.repeat_interleave(
        torch.arange(a_idx.shape[0], device=device), counts.long(),
        output_size=F)
    a_rows = torch.repeat_interleave(
        torch.arange(m, device=device, dtype=kt),
        (a_ptr[1:] - a_ptr[:-1]).long(), output_size=a_idx.shape[0])
    pos = torch.arange(F, device=device, dtype=kt)
    src_b = (pos + (b_ptr[:-1][a_idx] - starts)[src_a]).long()
    key = a_rows[src_a] * n + b_idx[src_b]
    val = a.data.to(device)[src_a] * b.data.to(device)[src_b]
    return _sort_merge_compact(key, val)
