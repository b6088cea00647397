"""Regional spherical-shell FE mesh (host-side precompute; the port's own
copy of g4s_tpu/models/citcoms/mesh.py, numpy only).

Rebuilds the capability of the reference's regional mesher + incidence
construction (citcoms/lib/Regional_version_dependent.c node layout,
construct_ien / construct_id in Instructions.c:57-66, element geometry in
Size_does_matter.c mass_matrix) as vectorized numpy:

  - nodes on a tensor grid (theta_j, fi_i, r_k); flat node index
    = (i_y * nox + j_x) * noz + k_z (k fastest, matching the reference's
    `node = k + (j-1)*noz + (i-1)*nox*noz`).
  - IEN: 8-node hexahedra; local nodes 0-3 on the lower-r face
    (0:(x,y) 1:(x+1,y) 2:(x+1,y+1) 3:(x,y+1)), 4-7 above.
  - boundary-condition masks/values for Cookbook2-class regional models:
    reflecting sides (zero normal velocity), free-slip or prescribed-velocity
    top/bottom (topvbc, Instructions.c:442-462), fixed top/bottom
    temperature (toptbc/bottbc).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from g4s_tpu_torch.models.citcoms.config import CitcomConfig


@dataclasses.dataclass(frozen=True)
class RegionalMesh:
    cfg: CitcomConfig
    theta: np.ndarray   # (nox,)
    fi: np.ndarray      # (noy,)
    r: np.ndarray       # (noz,)
    sx: np.ndarray      # (nno, 3): theta, fi, r per node
    ien: np.ndarray     # (nel, 8) node ids
    # element geometry
    e_center: np.ndarray  # (nel, 3) theta, fi, r of element center
    e_size: np.ndarray    # (nel, 3) physical arc/radial lengths (eco.size)
    # boundary conditions
    vbc_mask: np.ndarray  # (nno, 3) True where velocity dof is prescribed
    vbc_val: np.ndarray   # (nno, 3)
    tbc_mask: np.ndarray  # (nno,)  True where T prescribed
    tbc_val: np.ndarray   # (nno,)

    @property
    def shape_grid(self) -> Tuple[int, int, int]:
        return (self.cfg.nodey, self.cfg.nodex, self.cfg.nodez)

    @property
    def nno(self) -> int:
        return self.sx.shape[0]

    @property
    def nel(self) -> int:
        return self.ien.shape[0]


def node_index(i_y, j_x, k_z, nox, noz):
    return (np.asarray(i_y) * nox + np.asarray(j_x)) * noz + np.asarray(k_z)


def build_regional_mesh(cfg: CitcomConfig) -> RegionalMesh:
    nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
    theta = np.linspace(cfg.theta_min, cfg.theta_max, nox)
    fi = np.linspace(cfg.fi_min, cfg.fi_max, noy)
    r = np.linspace(cfg.radius_inner, cfg.radius_outer, noz)

    # node coords, k fastest then x then y
    TH, FI, R = np.meshgrid(theta, fi, r, indexing="ij")   # (nox, noy, noz)
    TH = TH.transpose(1, 0, 2)                              # (noy, nox, noz)
    FI = FI.transpose(1, 0, 2)
    R = R.transpose(1, 0, 2)
    sx = np.stack([TH.ravel(), FI.ravel(), R.ravel()], axis=1)

    # IEN
    ex, ey, ez = nox - 1, noy - 1, noz - 1
    iy, jx, kz = np.meshgrid(np.arange(ey), np.arange(ex), np.arange(ez),
                             indexing="ij")                 # (ey, ex, ez)
    corners = []
    for (dy, dx, dz) in [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0),
                         (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)]:
        corners.append(node_index(iy + dy, jx + dx, kz + dz, nox, noz).ravel())
    ien = np.stack(corners, axis=1).astype(np.int32)        # (nel, 8)

    # element geometry (Size_does_matter.c mass_matrix element-size logic)
    exy = sx[ien]                                           # (nel, 8, 3)
    center = exy.mean(axis=1)
    dth = np.abs(exy[:, 1, 0] - exy[:, 0, 0])
    dfi = np.abs(exy[:, 3, 1] - exy[:, 0, 1])
    dr = np.abs(exy[:, 4, 2] - exy[:, 0, 2])
    size = np.stack([dth * center[:, 2],
                     dfi * center[:, 2] * np.sin(center[:, 0]),
                     dr], axis=1)

    # ---- velocity boundary conditions ----
    # Exact replication of the regional BC flag logic:
    #   horizontal_bc top/bottom (Regional_boundary_conditions.c:77-123),
    #   velocity_refl_vert_bc value overrides (:209-260),
    #   side-wall flag assignment incl. selective clearing (:268-345).
    nno = nox * noy * noz
    vbc_mask = np.zeros((nno, 3), dtype=bool)
    vbc_val = np.zeros((nno, 3))
    IY, JX, KZ = np.meshgrid(np.arange(noy), np.arange(nox), np.arange(noz),
                             indexing="ij")
    flat = node_index(IY, JX, KZ, nox, noz).ravel()
    xwall = ((JX == 0) | (JX == nox - 1)).ravel()
    ywall = ((IY == 0) | (IY == noy - 1)).ravel()
    bot = (KZ == 0).ravel()
    top = (KZ == noz - 1).ravel()
    interior_z = ~(bot | top)

    # 1) top/bottom horizontal_bc
    if cfg.topvbc == 1:     # prescribed velocity
        vbc_mask[flat[top], :] = True
        vbc_val[flat[top], 0] = cfg.topvbxval
        vbc_val[flat[top], 1] = cfg.topvbyval
    else:                   # free slip: radial fixed only
        vbc_mask[flat[top], 2] = True
    if cfg.botvbc == 1:
        vbc_mask[flat[bot], :] = True
        vbc_val[flat[bot], 0] = cfg.botvbxval
        vbc_val[flat[bot], 1] = cfg.botvbyval
    else:
        vbc_mask[flat[bot], 2] = True

    # 2) velocity_refl_vert_bc: wall values forced to zero (overrides the
    #    lid value on the shared top edge)
    vbc_val[flat[xwall], 0] = 0.0
    vbc_val[flat[xwall & interior_z], 2] = 0.0
    vbc_val[flat[ywall], 1] = 0.0
    vbc_val[flat[ywall & interior_z], 2] = 0.0

    # 3) theta-wall flags: fix u_theta; at interior-z rows free u_fi and u_r
    vbc_mask[flat[xwall], 0] = True
    vbc_mask[flat[xwall & interior_z], 1] = False
    vbc_mask[flat[xwall & interior_z], 2] = False
    # 4) fi-wall flags: fix u_fi; interior-z rows free u_r; and free u_theta
    #    unless also on a theta wall or top/bottom
    vbc_mask[flat[ywall], 1] = True
    vbc_mask[flat[ywall & interior_z], 2] = False
    vbc_mask[flat[ywall & interior_z & ~xwall], 0] = False
    vbc_val = np.where(vbc_mask, vbc_val, 0.0)

    tbc_mask = np.zeros(nno, dtype=bool)
    tbc_val = np.zeros(nno)
    if cfg.toptbc != 0:
        tbc_mask[flat[top]] = True
        tbc_val[flat[top]] = cfg.toptbcval
    if cfg.bottbc != 0:
        tbc_mask[flat[bot]] = True
        tbc_val[flat[bot]] = cfg.bottbcval

    return RegionalMesh(cfg, theta, fi, r, sx, ien, center, size,
                        vbc_mask, vbc_val, tbc_mask, tbc_val)


def initial_temperature(mesh: RegionalMesh) -> np.ndarray:
    """tic_method 0: linear profile + layer perturbations
    (Initial_temperature.c:306-327 linear_temperature_profile +
    :422-487 add_perturbations_at_layers)."""
    cfg = mesh.cfg
    r = mesh.sx[:, 2]
    ri, ro = cfg.radius_inner, cfg.radius_outer
    T = cfg.bottbcval - (cfg.toptbcval + cfg.bottbcval) * (r - ri) / (ro - ri)
    for p in range(cfg.num_perturbations):
        mag = cfg.perturbmag[p]
        if mag == 0.0:
            continue
        ll, mm = cfg.perturbl[p], cfg.perturbm[p]
        k_layer = cfg.perturblayer[p] - 1  # 1-based layer in config
        th, ph = mesh.sx[:, 0], mesh.sx[:, 1]
        # regional convention: cosine perturbation in the box coordinates
        # (Initial_temperature.c:455-470 regional branch)
        tlen = np.pi / (cfg.theta_max - cfg.theta_min)
        flen = np.pi / (cfg.fi_max - cfg.fi_min)
        on_layer = np.isclose(r, mesh.r[k_layer])
        T = T + np.where(
            on_layer,
            mag * np.cos(ll * tlen * (th - cfg.theta_min))
            * np.cos(mm * flen * (ph - cfg.fi_min)),
            0.0)
    T = np.clip(T, 0.0, 1.0)
    # conform to TBCs
    T = np.where(mesh.tbc_mask, mesh.tbc_val, T)
    return T
