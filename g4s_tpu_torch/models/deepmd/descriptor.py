"""se_e2_a environment-matrix descriptor (counterpart of
g4s_tpu/models/deepmd/descriptor.py).

The semantics of the reference's native pipeline (deepmd/source/lib/src/
{neighbor_list,fmt_nlist,env_mat}.cc behind the ProdEnvMatA op):

  - neighbor list: all-pairs minimum-image distances (a dense (N, N)
    distance matrix at the O(100)-atom sizes of the training systems),
  - per-type sorted truncation to sel[t] slots (fmt_nlist.cc layout),
  - smoothed env matrix rows s(r) * (1, x/r, y/r, z/r) with the quintic
    switch between rcut_smth and rcut (env_mat.cc, switcher spline5).

Every function takes one frame, coords (N, 3) and box (3, 3), or a batch
of frames, coords (B, N, 3) and box (B, 3, 3), sharing one types (N,).
Forces and virials come from torch.autograd through this whole function,
and training differentiates it twice (a force loss): every guard keeps the
unselected branch finite, so second derivatives stay finite at padded
slots too. `env_mat_nopbc` is the finite-system variant (no minimum
image, optional real-atom mask), `env_mat_celllist` the cell-list variant
for large frames, and `atomic_descriptor_ef` the electric-field
descriptor (se_a_ef).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class DescriptorSpec(NamedTuple):
    rcut: float
    rcut_smth: float
    sel: Tuple[int, ...]      # neighbors kept per type
    ntypes: int

    @property
    def nnei(self) -> int:
        return int(sum(self.sel))


def min_image_displacements(coords, box):
    """Pairwise displacement r_j - r_i with periodic minimum image.

    coords: (..., N, 3); box: (..., 3, 3) row-vector cell. Returns
    (..., N, N, 3). Exact for orthorhombic cells and cells with small skew
    (one-image wrap), as the reference's region.cc diffNearestNeighbor.
    """
    disp = coords[..., None, :, :] - coords[..., :, None, :]
    # inv_ex: torch.linalg.inv reads its error flag back to the host, a
    # device sync in every eval
    inv = torch.linalg.inv_ex(box)[0][..., None, :, :]
    frac = disp @ inv
    frac = frac - torch.round(frac)          # half to even, as jnp.round
    return frac @ box[..., None, :, :]


def switch_fn(r, rmin, rmax):
    """DeePMD quintic switching: 1 for r<rmin, ->0 at rmax
    (source/lib/include/switcher.h spline5_switch)."""
    u = (r - rmin) / (rmax - rmin)
    sw = 1.0 + u * u * u * (-10.0 + u * (15.0 - 6.0 * u))
    return torch.where(r < rmin, 1.0, torch.where(r > rmax, 0.0, sw))


def env_mat(coords, box, types, spec: DescriptorSpec, *,
            efield=None, ef_mode: str = "none"):
    """Environment matrix of one frame or a batch of frames.

    coords: (..., N, 3) Angstrom; box: (..., 3, 3); types: (N,) int.
    Returns R: (..., N, nnei, 4) and nlist: (..., N, nnei) neighbor
    indices (-1 pad). Slots are laid out per type section (sel[0] slots of
    type 0, ...), each section sorted by distance: fmt_nlist's layout.

    efield/ef_mode give the se_a_ef variants (ComputeDescriptor.h
    compute_descriptor_se_a_ef_para/_vert): the vector channels use the
    component of r parallel ("para") or perpendicular ("vert") to the
    per-atom unit field, (..., N, 3), while channel 0 keeps 1/r of the
    full distance.
    """
    disp = min_image_displacements(coords, box)          # (..., N, N, 3)
    return _env_sections(disp, types, spec, efield=efield, ef_mode=ef_mode)


def env_mat_nopbc(coords, types, spec: DescriptorSpec, *, atom_mask=None):
    """Environment matrix of a FINITE (non-periodic) system, one frame or a
    batch, with an optional real-atom mask (N,) (DescrptSeAMask,
    deepmd/descriptor/se_a_mask.py: aparam marks real against virtual
    atoms so one graph serves molecules of several sizes).

    No minimum image; masked-out (virtual) atoms are excluded as neighbors
    and their own rows are zero. As in the reference, the switch keeps the
    declared rcut, so the descriptor stays continuous when real atoms
    leave the radius. Returns (R, nlist) laid out as env_mat's."""
    disp = coords[..., None, :, :] - coords[..., :, None, :]  # no PBC
    am = None
    if atom_mask is not None:
        am = torch.as_tensor(atom_mask, device=coords.device).bool()
    R, nlist = _env_sections(disp, types, spec, neighbor_mask=am)
    if am is not None:
        R = R * am[:, None, None]                        # virtual centers
        nlist = torch.where(am[:, None], nlist, -1)
    return R, nlist


def _env_sections(disp, types, spec: DescriptorSpec, *, neighbor_mask=None,
                  efield=None, ef_mode: str = "none"):
    """R and nlist from the pair displacements disp (..., N, N, 3): per
    type, the sel[t] nearest within rcut, sorted by distance, as fmt_nlist
    lays them out; neighbors where neighbor_mask (N,) is False never
    count."""
    n = disp.shape[-2]
    r2 = torch.sum(disp * disp, dim=-1)
    big = 1e10
    r2 = r2 + big * torch.eye(n, dtype=r2.dtype, device=r2.device)
    if neighbor_mask is not None:
        r2 = torch.where(neighbor_mask[None, :], r2, big)
    types = torch.as_tensor(types, device=disp.device)

    R_secs, nl_secs = [], []
    for t in range(spec.ntypes):
        k = spec.sel[t]
        r2_t = torch.where(types[None, :] == t, r2, big)
        if r2_t.shape[-1] < k:
            # fewer atoms than sel slots (tiny systems): pad candidates
            # with far-away dummies; they fail the rcut test and mask out
            r2_t = F.pad(r2_t, (0, k - r2_t.shape[-1]), value=big)
        # ties occur only among `big` entries, which fail the rcut test
        # below: their order does not reach R or nlist
        d2, idx = torch.topk(r2_t, k, dim=-1, largest=False, sorted=True)
        valid = d2 < spec.rcut ** 2
        # the unselected branch must stay finite: sqrt'(0) = inf times the
        # where's zero cotangent would give NaN in the backward pass
        d = torch.sqrt(torch.where(valid, d2, 1.0))
        # clamp pad indices (past N on the padded path) before the gather
        idx_g = torch.where(valid, idx, 0)
        vec = torch.gather(disp, -2,
                           idx_g[..., None].expand(*idx_g.shape, 3))
        sw = switch_fn(d, spec.rcut_smth, spec.rcut)
        s = torch.where(valid, sw / d, 0.0)
        row0 = s
        if efield is not None and ef_mode != "none":
            ef = efield / torch.linalg.norm(efield, dim=-1, keepdim=True)
            dot = torch.sum(vec * ef[..., None, :], dim=-1, keepdim=True)
            para = dot * ef[..., None, :]
            vec_eff = para if ef_mode == "para" else vec - para
        else:
            vec_eff = vec
        rows = s[..., None] * vec_eff \
            / torch.where(valid, d, 1.0)[..., None]
        R_secs.append(torch.cat([row0[..., None], rows], dim=-1)
                      * valid[..., None])
        nl_secs.append(torch.where(valid, idx, -1))
    R = torch.cat(R_secs, dim=-2)                        # (..., N, nnei, 4)
    nlist = torch.cat(nl_secs, dim=-1)
    return R, nlist


def env_mat_celllist(coords, box, types, spec: DescriptorSpec, *,
                     max_per_cell: int = 64):
    """Cell-list variant of env_mat for one large frame (the role of the
    reference's cell-list build, source/lib/src/neighbor_list.cc): the same
    (R, nlist), up to the order of equidistant neighbors.

    Atoms are binned into cells of side >= rcut, the cell counts taken from
    the box on the host; each atom's candidates are the atoms of its 27
    surrounding cells (max_per_cell slots per cell, padded), not all N.
    Orthorhombic boxes only. Unlike the reference, which then counts an
    atom two or three times or drops it, this raises ValueError where a
    side holds fewer than 3 cells or a cell more than max_per_cell atoms.
    The occupancy check reads one number back from the device per call.
    """
    if coords.dim() != 2:
        raise ValueError("env_mat_celllist takes one frame, coords (N, 3)")
    box_h = _host(box).reshape(3, 3)
    if np.any(box_h - np.diag(np.diag(box_h))):
        raise ValueError("env_mat_celllist takes orthorhombic boxes only")
    box_d = np.diag(box_h).copy()
    n_cells = np.maximum((box_d / spec.rcut).astype(int), 1)
    if np.any(n_cells < 3):
        raise ValueError(
            f"env_mat_celllist: the box {box_d.tolist()} holds "
            f"{n_cells.tolist()} cells of side >= rcut {spec.rcut} per side; "
            f"fewer than 3 would count neighbors twice: use env_mat")
    ncx, ncy, ncz = (int(c) for c in n_cells)
    n_cell_total = ncx * ncy * ncz
    n = coords.shape[0]
    dev = coords.device
    types = torch.as_tensor(types, device=dev).long()
    bd = torch.as_tensor(box_d, dtype=coords.dtype, device=dev)
    nc = torch.tensor([ncx, ncy, ncz], device=dev)

    frac = coords.detach() / bd
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * nc).long(), nc - 1)
    cell_id = (ci[:, 0] * ncy + ci[:, 1]) * ncz + ci[:, 2]
    if int(torch.bincount(cell_id, minlength=n_cell_total).max()) \
            > max_per_cell:
        raise ValueError(f"env_mat_celllist: a cell holds more than "
                         f"max_per_cell={max_per_cell} atoms")

    # bucket atoms per cell: sort by cell, rank within each run of equal ids
    order = torch.argsort(cell_id, stable=True)
    sorted_cells = cell_id[order]
    ar = torch.arange(n, device=dev)
    run_first = torch.full((n_cell_total,), n, device=dev).scatter_reduce(
        0, sorted_cells, ar, "amin")
    rank = ar - run_first[sorted_cells]
    buckets = torch.full((n_cell_total, max_per_cell), -1, device=dev)
    buckets[sorted_cells, rank] = order

    # 27-cell candidate lists per atom
    offs = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                        device=dev)
    nb = torch.remainder(ci[:, None, :] + offs[None], nc)
    nb_cells = (nb[..., 0] * ncy + nb[..., 1]) * ncz + nb[..., 2]
    cand = buckets[nb_cells].reshape(n, -1)            # (N, 27 * occ)

    # distances to the candidates, minimum image
    disp = coords[cand.clamp(min=0)] - coords[:, None, :]
    disp = disp - torch.round(disp / bd) * bd
    r2 = torch.sum(disp * disp, dim=-1)
    big = 1e10
    r2 = torch.where((cand < 0) | (cand == ar[:, None]), big, r2)
    cand_type = torch.where(cand >= 0, types[cand.clamp(min=0)], -1)

    R_secs, nl_secs = [], []
    for t in range(spec.ntypes):
        k = spec.sel[t]
        r2_t = torch.where(cand_type == t, r2, big)
        if r2_t.shape[-1] < k:
            r2_t = F.pad(r2_t, (0, k - r2_t.shape[-1]), value=big)
        d2, idx = torch.topk(r2_t, k, dim=-1, largest=False, sorted=True)
        valid = d2 < spec.rcut ** 2
        d = torch.sqrt(torch.where(valid, d2, 1.0))
        idx_g = torch.where(valid, idx, 0)
        vec = torch.gather(disp, -2,
                           idx_g[..., None].expand(*idx_g.shape, 3))
        sw = switch_fn(d, spec.rcut_smth, spec.rcut)
        s = torch.where(valid, sw / d, 0.0)
        rows = s[..., None] * vec / torch.where(valid, d, 1.0)[..., None]
        R_secs.append(torch.cat([s[..., None], rows], dim=-1)
                      * valid[..., None])
        nl_secs.append(torch.where(valid, torch.gather(cand, -1, idx_g), -1))
    return torch.cat(R_secs, dim=-2), torch.cat(nl_secs, dim=-1)


def atomic_descriptor_ef(params_para, params_vert, spec, coords, box,
                         types, efield):
    """se_a_ef descriptor (deepmd/descriptor/se_a_ef.py DescrptSeAEf): two
    se_e2_a-style sub-descriptors, each with its own embedding nets and
    stats, over the field-parallel and field-perpendicular environment
    matrices, concatenated per atom. efield: (..., N, 3) per-atom field
    vectors (normalized inside)."""
    from g4s_tpu_torch.models.deepmd.model import atomic_descriptor
    outs = []
    for prm, mode in ((params_para, "para"), (params_vert, "vert")):
        R, nlist = env_mat(coords, box, types, spec.descriptor,
                           efield=efield, ef_mode=mode)
        outs.append(atomic_descriptor(prm, spec, R, types, nlist))
    return torch.cat(outs, dim=-1)


def normalize_env_mat(R, types, davg, dstd):
    """Per-center-type standardization (the trained davg/dstd constants of
    DescrptSeA, se_a.py:227-253)."""
    types = torch.as_tensor(types, device=R.device).long()
    return (R - davg[types]) / dstd[types]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute_stats(frames_R: Sequence, frames_types, ntypes: int,
                  nnei: int) -> Tuple[np.ndarray, np.ndarray]:
    """compute_input_stats (se_a.py:304-420): davg=(r̄,0,0,0), dstd from
    radial/angular second moments, broadcast over neighbor slots.
    frames_R holds one (N, nnei, 4) env mat per frame (tensors or arrays)."""
    sumr = np.zeros(ntypes); sumr2 = np.zeros(ntypes)
    suma = np.zeros(ntypes); suma2 = np.zeros(ntypes)
    sumn = np.zeros(ntypes)
    for R, types in zip(frames_R, frames_types):
        R = _host(R); types = _host(types)
        for t in range(ntypes):
            sub = R[types == t]                           # (nt, nnei, 4)
            sumr[t] += sub[..., 0].sum()
            sumr2[t] += (sub[..., 0] ** 2).sum()
            suma[t] += sub[..., 1:].sum()
            suma2[t] += (sub[..., 1:] ** 2).sum()
            sumn[t] += sub.shape[0] * sub.shape[1]
    davg = np.zeros((ntypes, nnei, 4))
    dstd = np.ones((ntypes, nnei, 4))
    for t in range(ntypes):
        if sumn[t] == 0:
            continue
        r_avg = sumr[t] / sumn[t]
        std_r = np.sqrt(max(sumr2[t] / sumn[t] - r_avg ** 2, 0.0))
        std_a = np.sqrt(max(suma2[t] / (3 * sumn[t]), 0.0))
        davg[t, :, 0] = r_avg
        dstd[t, :, 0] = max(std_r, 1e-2)
        dstd[t, :, 1:] = max(std_a, 1e-2)
    return davg, dstd


def neighbor_stat(frames_coord, frames_box, types, rcut: float,
                  ntypes: int):
    """Max neighbor count per type over sample frames: the auto-`sel`
    helper (deepmd/deepmd/utils/neighbor_stat.py + source/op/
    neighbor_stat.cc). Returns (max_per_type, suggested_sel)."""
    types = np.asarray(types)
    max_nbor = np.zeros(ntypes, dtype=np.int64)
    for coord, box in zip(frames_coord, frames_box):
        c = np.asarray(coord).reshape(-1, 3)
        b = np.asarray(box).reshape(3, 3)
        d = c[None] - c[:, None]
        f = d @ np.linalg.inv(b)
        f -= np.round(f)
        r = np.linalg.norm(f @ b, axis=-1)
        np.fill_diagonal(r, np.inf)
        within = r < rcut
        for t in range(ntypes):
            cnt = within[:, types == t].sum(axis=1)
            max_nbor[t] = max(max_nbor[t], int(cnt.max()))
    # suggested sel: ~10% headroom rounded up to a multiple of 4
    sel = (np.ceil(max_nbor * 1.1 / 4) * 4).astype(int)
    return max_nbor, tuple(int(s) for s in sel)
