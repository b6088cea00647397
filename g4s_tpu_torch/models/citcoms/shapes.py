"""Shape functions, quadrature and strain-displacement tensors (the port's
own copy of g4s_tpu/models/citcoms/shapes.py, numpy only, with the general
isoparametric geometry of the full-sphere caps).

Host-side precompute (numpy, f64) of everything the reference derives in
Size_does_matter.c (jacobians/GDA), construct_c3x3matrix_el (the node-frame
to gauss-frame rotations cc/ccx) and get_ba/get_ba_p
(Element_calculations.c:145-276): the 6-row spherical strain-displacement
tensor B for every (element, gauss point, node, dof direction).

Batched: instead of per-element scalar loops, everything is one batched
tensor; the stiffness later reduces to a single einsum over these arrays.

Velocity dofs follow the reference convention: components in the *local
spherical frame of each node* (e_theta, e_fi, e_r at the node's coordinates),
rotated to the gauss-point frame by cc. Strain rows are ordered
(tt, ff, rr, tf, tr, fr) with engineering shear (matching the isotropic
contraction weights diag(2,2,2,1,1,1) in get_elt_k:368-377).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from g4s_tpu_torch.models.citcoms.mesh import RegionalMesh

_S = 1.0 / np.sqrt(3.0)
# local corner offsets matching mesh.build_regional_mesh's IEN ordering
_CORNERS = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], dtype=np.float64)
# gauss points: 2x2x2, same (x, y, z) ordering as corners
_GAUSS = np.array([(sx * _S, sy * _S, sz * _S)
                   for (sx, sy, sz) in 2 * _CORNERS - 1])
_GWEIGHT = np.ones(8)
_PPOINT = np.zeros((1, 3))
_PWEIGHT = np.array([8.0])


def shape_n(xi: np.ndarray) -> np.ndarray:
    """Trilinear shape functions N_a(xi) for xi (npts, 3) -> (8, npts)."""
    s = 2 * _CORNERS - 1  # corner signs
    return np.prod(0.5 * (1.0 + s[:, None, :] * xi[None, :, :]), axis=2)


def shape_dn(xi: np.ndarray) -> np.ndarray:
    """dN_a/dxi_d -> (8, npts, 3)."""
    s = 2 * _CORNERS - 1
    half = 0.5 * (1.0 + s[:, None, :] * xi[None, :, :])  # (8, npts, 3)
    out = np.empty((8, xi.shape[0], 3))
    for d in range(3):
        term = 0.5 * s[:, None, d]
        others = np.prod(np.delete(half, d, axis=2), axis=2)
        out[:, :, d] = term * others
    return out


def spherical_basis(theta, fi):
    """Cartesian components of (e_theta, e_fi, e_r): (..., 3basis, 3xyz)."""
    st, ct = np.sin(theta), np.cos(theta)
    sf, cf = np.sin(fi), np.cos(fi)
    e_t = np.stack([ct * cf, ct * sf, -st], axis=-1)
    e_f = np.stack([-sf, cf, np.zeros_like(sf)], axis=-1)
    e_r = np.stack([st * cf, st * sf, ct], axis=-1)
    return np.stack([e_t, e_f, e_r], axis=-2)


def spherical_basis_derivs(theta, fi):
    """d(e_p)/dtheta and d(e_p)/dfi of the gauss-frame basis:
    returns (..., 2deriv, 3basis, 3xyz)."""
    st, ct = np.sin(theta), np.cos(theta)
    sf, cf = np.sin(fi), np.cos(fi)
    zero = np.zeros_like(st)
    # d/dtheta
    de_t_dt = np.stack([-st * cf, -st * sf, -ct], axis=-1)      # = -e_r
    de_f_dt = np.stack([zero, zero, zero], axis=-1)
    de_r_dt = np.stack([ct * cf, ct * sf, -st], axis=-1)        # = e_t
    # d/dfi
    de_t_df = np.stack([-ct * sf, ct * cf, zero], axis=-1)
    de_f_df = np.stack([-cf, -sf, zero], axis=-1)
    de_r_df = np.stack([-st * sf, st * cf, zero], axis=-1)
    ddt = np.stack([de_t_dt, de_f_dt, de_r_dt], axis=-2)
    ddf = np.stack([de_t_df, de_f_df, de_r_df], axis=-2)
    return np.stack([ddt, ddf], axis=-3)


@dataclasses.dataclass(frozen=True)
class FEMGeometry:
    """Batched per-element FE tensors (host numpy; the model stages them
    on its device in its dtype)."""

    N: np.ndarray        # (8a, 8g) shape fns at vpts
    N_p: np.ndarray      # (8a, 1) at pressure point
    gweight: np.ndarray  # (8g,)
    rtf: np.ndarray      # (nel, 8g, 3): theta, fi, r at vpts
    gda: np.ndarray      # (nel, 8g): |J| r^2 sin(theta) at vpts
    gda_p: np.ndarray    # (nel, 1)
    cc: np.ndarray       # (nel, 8g, 3p, 3n, 8a): gauss-frame p of node-frame n
    B: np.ndarray        # (nel, 8g, 6, 8a, 3i) strain-displacement
    G: np.ndarray        # (nel, 8a, 3i) element gradient operator (get_elt_g)
    volume: np.ndarray   # (nel,)
    gradN_phys: np.ndarray = None  # (nel, 8g, 3, 8a) physical gradient rows
                                   # ((1/r)d/dth, 1/(r sin th)d/dfi, d/dr);
                                   # filled by build_geometry_general


def _cc_ccx(th_g, fi_g, th_n, fi_n):
    """cc[..., p, n, a] and ccx[..., j, p, n, a] for gauss pts x nodes.

    th_g/fi_g: (nel, ng); th_n/fi_n: (nel, 8).
    cc[p, n] = e_p(gauss) . e_n(node); ccx = d(e_p(gauss))/dx_j . e_n(node)
    (construct_c3x3matrix_el semantics).
    """
    eg = spherical_basis(th_g, fi_g)              # (nel, ng, 3p, 3xyz)
    en = spherical_basis(th_n, fi_n)              # (nel, 8a, 3n, 3xyz)
    dg = spherical_basis_derivs(th_g, fi_g)       # (nel, ng, 2j, 3p, 3xyz)
    cc = np.einsum("egpx,eanx->egpna", eg, en)
    ccx = np.einsum("egjpx,eanx->egjpna", dg, en)
    return cc, ccx


def build_geometry(mesh: RegionalMesh) -> FEMGeometry:
    ien = mesh.ien
    coords = mesh.sx[ien]                       # (nel, 8, 3)
    nel = ien.shape[0]

    N = shape_n(_GAUSS)                          # (8a, 8g)
    dN = shape_dn(_GAUSS)                        # (8a, 8g, 3d)
    N_p = shape_n(_PPOINT)                       # (8a, 1)
    dN_p = shape_dn(_PPOINT)                     # (8a, 1, 3d)

    # tensor-grid elements: diagonal jacobian from local xi to (theta, fi, r)
    dth = coords[:, 1, 0] - coords[:, 0, 0]      # (nel,)
    dfi = coords[:, 3, 1] - coords[:, 0, 1]
    dr = coords[:, 4, 2] - coords[:, 0, 2]
    half = 0.5 * np.stack([dth, dfi, dr], axis=1)  # (nel, 3)

    # coordinates at quadrature points
    rtf = np.einsum("ag,ead->egd", N, coords)     # (nel, 8g, 3)
    rtf_p = np.einsum("ag,ead->egd", N_p, coords)  # (nel, 1, 3)

    # physical derivatives dN/d(theta, fi, r) per element
    gnx = dN[None] / half[:, None, None, :]       # (nel, 8a, 8g, 3d)
    gnx_p = dN_p[None] / half[:, None, None, :]   # (nel, 8a, 1, 3d)

    det = np.prod(half, axis=1)                   # |J| of the box map
    gda = det[:, None] * rtf[:, :, 2] ** 2 * np.sin(rtf[:, :, 0])
    gda_p = det[:, None] * rtf_p[:, :, 2] ** 2 * np.sin(rtf_p[:, :, 0])

    th_n, fi_n = coords[:, :, 0], coords[:, :, 1]
    cc, ccx = _cc_ccx(rtf[:, :, 0], rtf[:, :, 1], th_n, fi_n)
    cc_p, ccx_p = _cc_ccx(rtf_p[:, :, 0], rtf_p[:, :, 1], th_n, fi_n)

    B = _build_ba(N, gnx, cc, ccx, rtf)           # (nel, 8g, 6, 8a, 3i)
    B_ppt = _build_ba(N_p, gnx_p, cc_p, ccx_p, rtf_p)  # (nel, 1, 6, 8a, 3i)

    # element gradient operator: G[a,i] = -w_p * gda_p * div(N_a e_i)|_ppt,
    # div = B_tt + B_ff + B_rr  (get_elt_g:913-1008)
    divB = B_ppt[:, 0, 0] + B_ppt[:, 0, 1] + B_ppt[:, 0, 2]  # (nel, 8a, 3i)
    G = -_PWEIGHT[0] * gda_p[:, 0, None, None] * divB

    volume = (gda * _GWEIGHT[None, :]).sum(axis=1)

    return FEMGeometry(N, N_p, _GWEIGHT, rtf, gda, gda_p, cc, B, G, volume)


def _build_ba(N, gnx, cc, ccx, rtf):
    """Spherical strain-displacement rows (get_ba, Element_calculations.c:145).

    N: (8a, ng); gnx: (nel, 8a, ng, 3); cc: (nel, ng, 3p, 3n, 8a);
    ccx: (nel, ng, 2j, 3p, 3n, 8a); rtf: (nel, ng, 3).
    Returns B: (nel, ng, 6, 8a, 3n).
    """
    ra = 1.0 / rtf[:, :, 2]                       # 1/r  (nel, ng)
    isi = 1.0 / np.sin(rtf[:, :, 0])
    ct = np.cos(rtf[:, :, 0]) * isi               # cot(theta)

    # index helpers: cc[e,g,p,n,a], gnx[e,a,g,d], N[a,g]
    cc1 = cc[:, :, 0]                             # (nel, ng, 3n, 8a)
    cc2 = cc[:, :, 1]
    cc3 = cc[:, :, 2]
    cx = lambda p, j: ccx[:, :, j, p]             # (nel, ng, 3n, 8a)

    g_t = gnx[:, :, :, 0].transpose(0, 2, 1)      # (nel, ng, 8a) dN/dtheta
    g_f = gnx[:, :, :, 1].transpose(0, 2, 1)      # dN/dfi
    g_r = gnx[:, :, :, 2].transpose(0, 2, 1)      # dN/dr
    shp = N.T[None, :, :]                         # (1, ng, 8a)

    def E(x):  # expand (nel, ng, 8a) -> (nel, ng, 1, 8a)
        return x[:, :, None, :]

    ra_ = ra[:, :, None, None]
    isi_ = isi[:, :, None, None]
    ct_ = ct[:, :, None, None]

    b1 = (E(g_t) * cc1 + E(shp) * cx(0, 0) + E(shp) * cc3) * ra_
    b2 = (E(shp) * cc1 * ct_ + E(shp) * cc3
          + (E(g_f) * cc2 + E(shp) * cx(1, 1)) * isi_) * ra_
    b3 = E(g_r) * cc3
    b4 = (E(g_t) * cc2 + E(shp) * cx(1, 0) - E(shp) * cc2 * ct_
          + (E(g_f) * cc1 + E(shp) * cx(0, 1)) * isi_) * ra_
    b5 = (E(g_r) * cc1
          + (E(g_t) * cc3 + E(shp) * (cx(2, 0) - cc1)) * ra_)
    b6 = (E(g_r) * cc2 - ra_ * E(shp) * cc2
          + (E(g_f) * cc3 + E(shp) * cx(2, 1)) * isi_ * ra_)

    B = np.stack([b1, b2, b3, b4, b5, b6], axis=2)  # (nel, ng, 6, 3n, 8a)
    return B.transpose(0, 1, 2, 4, 3)               # -> (..., 8a, 3n)


def build_geometry_general(sx: np.ndarray, ien: np.ndarray) -> FEMGeometry:
    """Isoparametric geometry for NON-tensor meshes (the full-sphere caps).

    Unlike build_geometry (which exploits the regional mesh's boxes in
    (theta, fi, r)), this computes the full 3x3 jacobian d(theta,fi,r)/dxi
    per gauss point — the general path of the reference's
    get_global_shape_fn (Size_does_matter.c). The strain tensors (cc/ccx/B)
    and the element gradient operator are the same spherical formulas.
    """
    coords = sx[ien].copy()                     # (nel, 8, 3)
    # unwrap fi within each element (seam elements straddle 0/2pi)
    f0 = coords[:, 0:1, 1]
    coords[:, :, 1] = f0 + np.mod(coords[:, :, 1] - f0 + np.pi,
                                  2 * np.pi) - np.pi

    N = shape_n(_GAUSS)
    dN = shape_dn(_GAUSS)                        # (8a, 8g, 3xi)
    N_p = shape_n(_PPOINT)
    dN_p = shape_dn(_PPOINT)

    def geom_at(dNq):
        # J[e,g,xi,d] = sum_a dN[a,g,xi] coords[e,a,d]; the gradient in
        # y = (theta, fi, r): d/dy_d = sum_xi dN/dxi * Jinv[e,g,xi,d]
        J = np.einsum("agx,ead->egxd", dNq, coords)
        gnx = np.einsum("agx,egxd->eagd", dNq, np.linalg.inv(J))
        return np.abs(np.linalg.det(J)), gnx

    detJ, gnx = geom_at(dN)
    detJ_p, gnx_p = geom_at(dN_p)

    rtf = np.einsum("ag,ead->egd", N, coords)
    rtf_p = np.einsum("ag,ead->egd", N_p, coords)
    gda = detJ * rtf[:, :, 2] ** 2 * np.sin(rtf[:, :, 0])
    gda_p = detJ_p * rtf_p[:, :, 2] ** 2 * np.sin(rtf_p[:, :, 0])

    th_n, fi_n = coords[:, :, 0], coords[:, :, 1]
    cc, ccx = _cc_ccx(rtf[:, :, 0], rtf[:, :, 1], th_n, fi_n)
    cc_p, ccx_p = _cc_ccx(rtf_p[:, :, 0], rtf_p[:, :, 1], th_n, fi_n)

    B = _build_ba(N, gnx, cc, ccx, rtf)
    B_ppt = _build_ba(N_p, gnx_p, cc_p, ccx_p, rtf_p)
    divB = B_ppt[:, 0, 0] + B_ppt[:, 0, 1] + B_ppt[:, 0, 2]
    G = -_PWEIGHT[0] * gda_p[:, 0, None, None] * divB
    volume = (gda * _GWEIGHT[None, :]).sum(axis=1)
    ra = 1.0 / rtf[:, :, 2]
    isi = 1.0 / np.sin(rtf[:, :, 0])
    grad = np.stack([
        gnx[:, :, :, 0].transpose(0, 2, 1) * ra[:, :, None],
        gnx[:, :, :, 1].transpose(0, 2, 1) * (ra * isi)[:, :, None],
        gnx[:, :, :, 2].transpose(0, 2, 1)], axis=2)
    return FEMGeometry(N, N_p, _GWEIGHT, rtf, gda, gda_p, cc, B, G, volume,
                       grad)
