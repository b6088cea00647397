"""Nodal (stencil) form of the velocity stiffness operator (counterpart of
the stencil half of g4s_tpu/models/citcoms/nodal.py; the colored
Gauss-Seidel smoother comes with multigrid).

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
