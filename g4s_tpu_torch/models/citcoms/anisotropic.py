"""Anisotropic (orthotropic / transversely isotropic) viscosity
(counterpart of g4s_tpu/models/citcoms/anisotropic.py).

Reference: citcoms/lib/Anisotropic_viscosity.c — get_constitutive:55
dispatches isotropic / orthotropic (Muehlhaus et al. 2002, get_orth_delta
:~240: Delta_ijkl = (n_i n_k d_lj + n_j n_k d_il + n_i n_l d_jk
+ n_j n_l d_ik)/2 - 2 n_i n_j n_k n_l) / transversely isotropic (Han &
Wahr) 6x6 stiffness matrices, applied inside the B^T D B element
stiffness.

Directors are given directly in the LOCAL spherical components
(theta, phi, r) that the B tensor rows use (a radial director is
n = (0, 0, 1) everywhere), so the reference's Cartesian->local rotation
is not needed.

Voigt order matches the reference comments (s_tt, s_pp, s_rr, s_tp,
s_tr, s_pr) and the isotropic D = diag(2,2,2,1,1,1) of
assembly.build_elt_k.
"""

from __future__ import annotations

import torch

_VOIGT = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]


def _director(n, dtype=None, device=None):
    n = torch.as_tensor(n, dtype=dtype if dtype is not None
                        else torch.float64, device=device)
    return n / torch.linalg.vector_norm(n)


def orth_delta(n):
    """Muehlhaus Delta tensor (3,3,3,3) for unit director n (3,)."""
    n = _director(n, n.dtype if isinstance(n, torch.Tensor) else None,
                  n.device if isinstance(n, torch.Tensor) else None)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    t = (torch.einsum("i,k,lj->ijkl", n, n, eye)
         + torch.einsum("j,k,il->ijkl", n, n, eye)
         + torch.einsum("i,l,kj->ijkl", n, n, eye)
         + torch.einsum("j,l,ik->ijkl", n, n, eye)) * 0.5
    return t - 2.0 * torch.einsum("i,j,k,l->ijkl", n, n, n, n)


def constitutive_isotropic(dtype=torch.float64, device=None):
    return torch.diag(torch.tensor([2.0, 2.0, 2.0, 1.0, 1.0, 1.0],
                                   dtype=dtype, device=device))


def constitutive_orthotropic(delta_vis, n):
    """Relative 6x6 D for orthotropic ("weak shear plane") viscosity:
    shear on planes normal to the director is reduced by delta_vis
    = 1 - eta_S/eta (get_constitutive_orthotropic_viscosity)."""
    d = orth_delta(n)
    D = constitutive_isotropic(d.dtype, d.device)
    rows = []
    for (i, j) in _VOIGT:
        row = []
        for cidx, (k, l) in enumerate(_VOIGT):
            if cidx < 3:
                row.append(2.0 * delta_vis * d[i, j, k, l])
            else:
                row.append(delta_vis * (d[i, j, k, l] + d[i, j, l, k]))
        rows.append(torch.stack(row))
    return D - torch.stack(rows)


def constitutive_ti(delta_vis, gamma_vis, n):
    """Transversely isotropic D (Han & Wahr form,
    get_constitutive_ti_viscosity): shear softening delta_vis on planes
    containing the director plus normal-viscosity contrast gamma_vis.
    For gamma_vis = 0 this reduces to the orthotropic matrix."""
    D = constitutive_orthotropic(delta_vis, n)
    if float(gamma_vis) != 0.0:
        n = _director(n, D.dtype, D.device)
        nn = torch.einsum("i,j->ij", n, n)
        corr = []
        for (i, j) in _VOIGT:
            corr.append(torch.stack([nn[i, j] * nn[k, l]
                                     for (k, l) in _VOIGT]))
        D = D + 2.0 * gamma_vis * torch.stack(corr)
    return D


def build_elt_k_aniso(B, gda, gweight, evisc, Dmat):
    """elt_k with a full 6x6 constitutive matrix: sum_g w |J| eta B^T D B.

    Dmat: (6, 6) shared, or (nel, 6, 6) per element. The isotropic fast
    path (assembly.build_elt_k) is the diagonal special case."""
    W = gweight[None, :] * gda * evisc                        # (nel, g)
    if Dmat.ndim == 2:
        DB = torch.einsum("st,egtai->egsai", Dmat, B)
    else:
        DB = torch.einsum("est,egtai->egsai", Dmat, B)
    BW = DB * W[:, :, None, None, None]
    K = torch.einsum("egsai,egsbj->eaibj", BW, B)
    return K.reshape(B.shape[0], 24, 24)
