"""Nodal (stencil) form of the velocity stiffness operator and the colored
Gauss-Seidel smoother (counterpart of g4s_tpu/models/citcoms/nodal.py).

The reference keeps two interchangeable forms of K u (assemble_del2_u
dispatch, Element_calculations.c:428-443): element-by-element (the graph
engine path) and node-by-node via the preassembled nodal equations Eqn_k /
Node_map (n_assemble_del2_u:516-577, 81 entries per dof row = 27 neighbor
nodes x 3 dofs).

On a regular tensor grid the nodal operator is exactly a 27-point stencil
of 3x3 blocks. One stencil build per viscosity update (a single segment
sum over element contributions) amortizes over the hundreds of CG
iterations that follow, like the reference's construct_node_maps/Eqn_k
precompute (Construct_arrays.c). A matvec is one gather of each node's 27
neighbours through a precomputed (nno, 27) index and one batched
(3 x 81) @ (81 x 1) product per node: three device kernels with the
strip, where 27 shifted slices and products would launch about 55.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from g4s_tpu_torch.ops.segment import sorted_segment_sum

# local corner offsets (dy, dx, dz) matching mesh.build_regional_mesh IEN
_LOCAL = np.array([(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0),
                   (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)])
_OFFSETS = [(dy, dx, dz) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            for dz in (-1, 0, 1)]


class StencilPlan(NamedTuple):
    order: torch.Tensor     # sorts (nel*64) block contributions by target
    seg_ids: torch.Tensor   # target = node_flat * 27 + slot (both int32)
    nbr: torch.Tensor       # (nno, 27) neighbour node per slot; a slot
                            # outside the grid names the node itself (its
                            # block is 0: no element couples the two)
    grid: Tuple[int, int, int]

    @staticmethod
    def build(cfg, device) -> "StencilPlan":
        noy, nox, noz = cfg.nodey, cfg.nodex, cfg.nodez
        ey, ex, ez = noy - 1, nox - 1, noz - 1
        iy, ix, iz = np.meshgrid(np.arange(ey), np.arange(ex), np.arange(ez),
                                 indexing="ij")
        origin = np.stack([iy.ravel(), ix.ravel(), iz.ravel()], 1)  # (nel,3)
        targets = np.empty((origin.shape[0], 8, 8), np.int64)
        for a in range(8):
            na = origin + _LOCAL[a]
            node_flat = (na[:, 0] * nox + na[:, 1]) * noz + na[:, 2]
            for b in range(8):
                d = _LOCAL[b] - _LOCAL[a]
                slot = (d[0] + 1) * 9 + (d[1] + 1) * 3 + (d[2] + 1)
                targets[:, a, b] = node_flat * 27 + slot
        flat = targets.reshape(-1)
        order = np.argsort(flat, kind="stable")

        Y, X, Z = np.meshgrid(np.arange(noy), np.arange(nox), np.arange(noz),
                              indexing="ij")
        node = np.stack([Y.ravel(), X.ravel(), Z.ravel()], 1)     # (nno, 3)
        nb = node[:, None, :] + np.asarray(_OFFSETS)[None]       # (nno,27,3)
        inside = ((nb >= 0) & (nb < np.array([noy, nox, noz]))).all(-1)
        nb_flat = (nb[..., 0] * nox + nb[..., 1]) * noz + nb[..., 2]
        self_flat = np.broadcast_to(np.arange(noy * nox * noz)[:, None],
                                    nb_flat.shape)
        nbr = np.where(inside, nb_flat, self_flat)
        # int32 order and ids: the sum reads half the index bytes
        return StencilPlan(torch.from_numpy(order.astype(np.int32)).to(device),
                           torch.from_numpy(flat[order].astype(np.int32))
                           .to(device),
                           torch.from_numpy(nbr).to(device),
                           (noy, nox, noz))


class Stencil(NamedTuple):
    """The assembled stencil: W[n, i, 3*o + j] couples dof i of node n with
    dof j of its neighbour in slot o (slot o = (dy+1)*9 + (dx+1)*3 + dz+1)."""
    W: torch.Tensor         # (nno, 3, 81)
    nbr: torch.Tensor       # (nno, 27), the plan's


def build_stencil(elt_k, plan: StencilPlan) -> Stencil:
    """elt_k (nel, 24, 24) -> the (nno, 3, 81) stencil blocks."""
    noy, nox, noz = plan.grid
    nno = noy * nox * noz
    nel = elt_k.shape[0]
    blocks = elt_k.reshape(nel, 8, 3, 8, 3).permute(0, 1, 3, 2, 4)
    flat = blocks.reshape(nel * 64, 9)
    W = sorted_segment_sum(flat, plan.seg_ids, nno * 27, order=plan.order)
    W = W.reshape(nno, 27, 3, 3).permute(0, 2, 1, 3).reshape(nno, 3, 81)
    return Stencil(W, plan.nbr)


def apply_stencil(st: Stencil, u):
    """Au = sum_o W[:, :, o] @ u(neighbour o); u (nno, 3)."""
    nb = u[st.nbr].reshape(-1, 81, 1)                        # (nno, 81, 1)
    return torch.bmm(st.W, nb).reshape(-1, 3)


def nodal_matvec(st: Stencil, u, vbc_mask, *, strip: bool = True):
    """K u through the stencil; u (nno, 3) flat, node order (iy, ix, iz)."""
    au = apply_stencil(st, u)
    if strip:
        au = torch.where(vbc_mask, 0.0, au)
    return au


# ---------------------------------------------------------------------------
# Colored Gauss-Seidel smoother (gauss_seidel, General_matrix_functions.c:606;
# the CUDA port's colored split, multigrid_kernel.cu:236-478). On the
# 27-point stencil the 2x2x2 node coloring gives 8 colors whose members
# never neighbor each other, so each color updates simultaneously and the
# color sequence is an exact Gauss-Seidel sweep. Each color's residual is
# evaluated only on its own strided subgrid: one gather of its nodes' 27
# neighbours and one batched product, so a sweep costs about one matvec.
# ---------------------------------------------------------------------------

_COLORS = [(cy, cx, cz) for cy in (0, 1) for cx in (0, 1) for cz in (0, 1)]


class GSPlan(NamedTuple):
    """Per-color gather plans for the 8-color sweep, built once: each
    color's nodes in (iy, ix, iz) order and their 27 neighbours (the
    stencil plan's, so a slot outside the grid names the node itself,
    whose block there is 0), int32 on the stencil plan's device."""
    nodes: Tuple[torch.Tensor, ...]    # per color: (m,) node ids
    nbr: Tuple[torch.Tensor, ...]      # per color: (m, 27) neighbour ids
    sizes: Tuple[Tuple[int, int, int], ...]
    grid: Tuple[int, int, int]

    @staticmethod
    def build(plan: StencilPlan) -> "GSPlan":
        noy, nox, noz = plan.grid
        ids = np.arange(noy * nox * noz).reshape(noy, nox, noz)
        dev = plan.nbr.device
        nodes, nbrs, sizes = [], [], []
        for cy, cx, cz in _COLORS:
            sub = ids[cy::2, cx::2, cz::2]
            flat = torch.from_numpy(sub.ravel().astype(np.int32)).to(dev)
            nodes.append(flat)
            nbrs.append(plan.nbr[flat].to(torch.int32))
            sizes.append(sub.shape)
        return GSPlan(tuple(nodes), tuple(nbrs), tuple(sizes), plan.grid)


def stencil_block_dinv(st: Stencil, vbc_mask):
    """Per-node inverse of the 3x3 diagonal block (slot 13 = zero offset),
    (nno, 3, 3). BC-constrained dofs get identity rows/cols so the update
    there is the plain (masked-to-zero) residual. vbc_mask: (nno, 3)."""
    nno = st.W.shape[0]
    D = st.W.reshape(nno, 3, 27, 3)[:, :, 13, :]
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    free = ~vbc_mask
    D = torch.where(free[..., :, None] & free[..., None, :], D, 0.0)
    D = D + torch.where(vbc_mask[..., :, None] & (eye > 0), 1.0, 0.0) * eye
    det = torch.linalg.det(D)
    D = torch.where((det.abs() > 1e-30)[..., None, None], D, eye)
    # inv_ex: inv would read its error flag back to the host
    return torch.linalg.inv_ex(D)[0]


class GSColors(NamedTuple):
    """A GS smoother's fixed per-color slices, built once per viscosity
    update: each color's stencil rows, 3x3 block inverses and bc mask."""
    W: Tuple[torch.Tensor, ...]        # per color: (m, 3, 81)
    Dinv: Tuple[torch.Tensor, ...]     # per color: (m, 3, 3)
    mask: Tuple[torch.Tensor, ...]     # per color: (m, 3) bool
    plan: GSPlan

    @staticmethod
    def build(st: Stencil, Dinv, vbc_mask, plan: GSPlan) -> "GSColors":
        return GSColors(tuple(st.W[n] for n in plan.nodes),
                        tuple(Dinv[n] for n in plan.nodes),
                        tuple(vbc_mask[n] for n in plan.nodes), plan)


def gauss_seidel_colored(colors: GSColors, F, u, n_sweeps: int):
    """n_sweeps of 8-color block Gauss-Seidel on K u = F (u, F (nno, 3)).

    Colors update simultaneously (2x2x2 coloring has no intra-color
    neighbors on the 27-point stencil); the color sequence is an exact
    Gauss-Seidel sweep. The sweep count is fixed: nothing is read back to
    the host.
    """
    plan = colors.plan
    noy, nox, noz = plan.grid
    u = u.clone(memory_format=torch.contiguous_format)
    ug = u.view(noy, nox, noz, 3)
    Fs = [F[nodes] for nodes in plan.nodes]
    for _ in range(n_sweeps):
        for ci, (cy, cx, cz) in enumerate(_COLORS):
            mc = colors.mask[ci]
            au = torch.bmm(colors.W[ci],
                           u[plan.nbr[ci]].reshape(-1, 81, 1)).reshape(-1, 3)
            r = torch.where(mc, 0.0, Fs[ci] - au)
            du = torch.bmm(colors.Dinv[ci], r[:, :, None]).reshape(-1, 3)
            du = torch.where(mc, 0.0, du)
            ug[cy::2, cx::2, cz::2].add_(du.reshape(*plan.sizes[ci], 3))
    return u
