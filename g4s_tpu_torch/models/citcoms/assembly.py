"""Batched FE assembly and operator application (counterpart of
g4s_tpu/models/citcoms/assembly.py, the Stokes hot path).

The reference applies the element stiffness through the G4S graph engine:
`e_assemble_del2_u` gathers per-element dofs, multiplies by the dense 24x24
elt_k blocks and scatter-adds (Element_calculations.c:475-509 via the
spmm_dense engine call at :500). Here the whole pattern is

    u_el  = u[ien]                        (one gather)
    Au_el = bmm(K, u_el)                  (batched 24x24 products)
    Au    = sorted_segment_sum(Au_el)     (scatter-add)

elt_k itself is one einsum over the B tensors (get_elt_k:282-419 isotropic
branch: contraction weights diag(2,2,2,1,1,1)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from g4s_tpu_torch.ops.segment import sorted_segment_sum


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Host-precomputed sorted scatter-add plan: (nel*8) element-node slots
    -> nno nodes, built once so every assembly is one gather and one
    sorted segment sum."""

    order: torch.Tensor     # (nel*8,) int32 permutation sorting slots by node
    seg_ids: torch.Tensor   # (nel*8,) int32 node id per sorted slot
    nno: int

    @staticmethod
    def build(ien: np.ndarray, nno: int, device) -> "ScatterPlan":
        flat = np.asarray(ien).ravel()
        order = np.argsort(flat, kind="stable")
        # int32 order and ids: the sum reads half the index bytes
        return ScatterPlan(torch.from_numpy(order.astype(np.int32)).to(device),
                           torch.from_numpy(flat[order].astype(np.int32))
                           .to(device), nno)

    def scatter(self, contrib):
        """contrib: (nel, 8, ...) -> (nno, ...) additive assembly."""
        flat = contrib.reshape((-1,) + tuple(contrib.shape[2:]))
        return sorted_segment_sum(flat, self.seg_ids, self.nno,
                                  order=self.order)


@dataclasses.dataclass(frozen=True)
class StokesOperators:
    """Device-resident FE tensors for one viscosity state."""

    ien: torch.Tensor       # (nel, 8) int64
    elt_k: torch.Tensor     # (nel, 24, 24)
    G: torch.Tensor         # (nel, 8, 3) element gradient operator
    vbc_mask: torch.Tensor  # (nno, 3) bool
    vbc_val: torch.Tensor   # (nno, 3)
    BI: torch.Tensor        # (nno, 3) 1/diag(K)
    BPI: torch.Tensor       # (nel,)   pressure preconditioner
    plan: ScatterPlan
    elt_c: Optional[torch.Tensor] = None  # (nel, 8, 3) anelastic continuity


def build_elt_k(B, gda, gweight, evisc):
    """elt_k[e,(a i),(b j)] = sum_g W[e,g] B^T D B   with
    W = w_g * |J|_g * eta_g and D = diag(2,2,2,1,1,1)."""
    W = gweight[None, :] * gda * evisc                        # (nel, g)
    # filled on the device: a tensor made from a host list would be a
    # copy that waits for the device
    D = torch.ones(6, dtype=B.dtype, device=B.device)
    D[:3].fill_(2.0)
    BW = B * (W[:, :, None, None, None] * D[None, None, :, None, None])
    K = torch.einsum("egsai,egsbj->eaibj", BW, B)
    return K.reshape(B.shape[0], 24, 24)


def strip_bcs(u, vbc_mask):
    """Zero residual/search components at prescribed dofs
    (strip_bcs_from_residual semantics)."""
    return torch.where(vbc_mask, 0.0, u)


def apply_vbc(u, vbc_mask, vbc_val):
    """Impose prescribed velocity values (velocities_conform_bcs)."""
    return torch.where(vbc_mask, vbc_val, u)


def assemble_del2_u(ops: StokesOperators, u, *, strip: bool = True):
    """Au = K u element-by-element (e_assemble_del2_u). u: (nno, 3)."""
    u_el = u[ops.ien].reshape(-1, 24, 1)                      # (nel, 24, 1)
    au_el = torch.bmm(ops.elt_k, u_el)
    au = ops.plan.scatter(au_el.reshape(-1, 8, 3))
    if strip:
        au = strip_bcs(au, ops.vbc_mask)
    return au


def assemble_grad_p(ops: StokesOperators, p, *, strip: bool = True):
    """F = G p: scatter element-pressure gradients to nodes
    (assemble_grad_p, Element_calculations.c:737-783)."""
    f = ops.plan.scatter(ops.G * p[:, None, None])            # (nno, 3)
    if strip:
        f = strip_bcs(f, ops.vbc_mask)
    return f


def assemble_div_u(ops: StokesOperators, u):
    """r_e = G_e^T u_el (assemble_div_u, Element_calculations.c:701-730).
    With elt_c present this is the ANELASTIC divergence
    div(rho_ref u)/rho_ref = div u + (dln rho/dr) u_r
    (assemble_div_rho_u, Element_calculations.c:682-693)."""
    u_el = u[ops.ien]                                         # (nel, 8, 3)
    d = torch.einsum("eai,eai->e", ops.G, u_el)
    if ops.elt_c is not None:
        d = d + torch.einsum("eai,eai->e", ops.elt_c, u_el)
    return d


def build_elt_c(cc, volume, beta):
    """Element operator for (dln rho/dr) u_r at the pressure point
    (get_elt_c, Element_calculations.c:840-880, refstate choice 1:
    rho = exp((1-r) Di/gamma) so beta = dln(rho)/dr = -Di/gamma).

    elt_c[e, a, i] = -beta * V_e * N_a(center) * cc_r[e, i, a] where cc_r
    is the radial row of the node->gauss frame rotation (center mean);
    the minus matches the reference's divergence sign convention
    (elt_c[p][0] = -x * temp * beta, Element_calculations.c:870-872).
    """
    cc_r = cc.mean(dim=1)[:, 2]                               # (nel, 3i, 8a)
    return -beta * volume[:, None, None] / 8.0 * cc_r.transpose(1, 2)


def build_diag_K(elt_k, plan: ScatterPlan):
    """1/diag(K) Jacobi preconditioner (build_diagonal_of_K)."""
    d = torch.diagonal(elt_k, dim1=1, dim2=2).reshape(-1, 8, 3)
    diag = plan.scatter(d)
    return torch.where(diag != 0.0, 1.0 / diag, 1.0)


def build_bpi(G, BI, ien, vbc_mask):
    """Pressure preconditioner BPI[e] = 1/(G_e^T diag(K)^-1 G_e)
    (assemble_dAhatp_entry, Element_calculations.c:785-833). Prescribed dofs
    carry no inverse-diagonal weight (their residuals are stripped)."""
    bi_el = torch.where(vbc_mask, 0.0, BI)[ien]               # (nel, 8, 3)
    bu = torch.einsum("eai,eai,eai->e", G, G, bi_el)
    return torch.where(bu != 0.0, 1.0 / bu, 1.0)


def assemble_forces(ops: StokesOperators, geo_N, gda, gweight, cc, buoy):
    """Momentum RHS from nodal buoyancy + Dirichlet lifting
    (assemble_forces / get_elt_f, Element_calculations.c:80-143, 1015-1092).

    geo_N: (8a, 8g); gda: (nel, 8g); cc: (nel, 8g, 3p, 3n, 8a);
    buoy: (nno,) radial buoyancy per node.
    """
    f_nodes = buoy[ops.ien]                                   # (nel, 8)
    f_gs = torch.einsum("ea,ag->eg", f_nodes, geo_N)          # (nel, 8g)
    w = f_gs * gda * gweight[None, :]
    # radial (gauss-frame e_r) component projected on node-frame dir i
    contrib = torch.einsum("eg,ag,egia->eai", w, geo_N, cc[:, :, 2])
    f = ops.plan.scatter(contrib)

    # Dirichlet lifting: F -= K * vb  (get_elt_f bcs branch)
    vb = torch.where(ops.vbc_mask, ops.vbc_val, 0.0)
    f = f - assemble_del2_u(ops, vb, strip=False)
    return strip_bcs(f, ops.vbc_mask)


def build_tmass(plan: ScatterPlan, geo_N, gda, gweight):
    """Inverse lumped mass for the energy equation (mass_matrix,
    Size_does_matter.c:1123-1147)."""
    contrib = torch.einsum("ag,eg,g->ea", geo_N, gda, gweight)  # (nel, 8a)
    return 1.0 / plan.scatter(contrib)
