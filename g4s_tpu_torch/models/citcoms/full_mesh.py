"""Full-sphere 12-cap mesh generation (the port's own copy of
g4s_tpu/models/citcoms/full_mesh.py, numpy only).

Reference: citcoms/lib/Full_sphere_related.c — the sphere is tiled by 12
quadrilateral caps (4 around the north pole, 4 equatorial, 4 around the
south pole, corner tables at :213-244 with the 9.736-degree area-equalizing
offset), and each cap is meshed by evenly dividing the great-circle arcs
between corners and intersecting the two families of edge-connecting lines
in the cap's gnomonic (u, v) projection plane (:245-420,
spherical_to_uv2/uv_to_spherical/find_intersection).

This module reproduces that construction in vectorized numpy and then
merges the 12 caps' shared seam nodes into one global node set (the role
the reference's inter-cap MPI exchange tables play is collapsed into
direct node identification for the single-device solver).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

OFFSET = 9.736 / 180.0 * np.pi


def cap_corners() -> np.ndarray:
    """(12, 4, 2) (theta, fi) corners; order 1-2-3-4 = the reference's
    (corner 1 top-left going down then across: 1-4 / 2-3 picture)."""
    caps = np.zeros((12, 4, 2))
    for i in range(1, 5):
        c = (i - 1) * 3      # polar cap (1, 4, 7, 10 in 1-based = index c)
        caps[c, :, 0] = [0.0, np.pi / 4 + OFFSET, np.pi / 2,
                         np.pi / 4 + OFFSET]
        caps[c, :, 1] = [0.0, (i - 1) * np.pi / 2,
                         (i - 1) * np.pi / 2 + np.pi / 4, i * np.pi / 2]
        c = (i - 1) * 3 + 1  # equatorial cap
        caps[c, :, 0] = [np.pi / 4 + OFFSET, np.pi / 2,
                         3 * np.pi / 4 - OFFSET, np.pi / 2]
        caps[c, :, 1] = [i * np.pi / 2, i * np.pi / 2 - np.pi / 4,
                         i * np.pi / 2, i * np.pi / 2 + np.pi / 4]
        c = 11 if i == 1 else (i - 1) * 3 - 1   # south cap (12, 3, 6, 9)
        caps[c, :, 0] = [np.pi / 2, 3 * np.pi / 4 - OFFSET, np.pi,
                         3 * np.pi / 4 - OFFSET]
        caps[c, :, 1] = [(i - 1) * np.pi / 2 + np.pi / 4,
                         (i - 1) * np.pi / 2, 0.0, i * np.pi / 2]
    return caps


def _sph_to_xyz(theta, fi):
    st = np.sin(theta)
    return np.stack([st * np.cos(fi), st * np.sin(fi), np.cos(theta)],
                    axis=-1)


def _xyz_to_sph(p):
    r = np.linalg.norm(p, axis=-1)
    theta = np.arccos(np.clip(p[..., 2] / r, -1, 1))
    fi = np.mod(np.arctan2(p[..., 1], p[..., 0]), 2 * np.pi)
    return theta, fi


def even_divide_arc(n_seg: int, p0, p1):
    """n_seg+1 points evenly spaced on the great circle from p0 to p1
    (even_divide_arc12 semantics: equal angular steps)."""
    dot = np.dot(p0, p1) / (np.linalg.norm(p0) * np.linalg.norm(p1))
    ang = np.arccos(np.clip(dot, -1, 1))
    t = np.linspace(0.0, 1.0, n_seg + 1)
    # slerp
    s0 = np.sin((1 - t) * ang) / np.sin(ang)
    s1 = np.sin(t * ang) / np.sin(ang)
    pts = s0[:, None] * p0[None, :] + s1[:, None] * p1[None, :]
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def _to_uv(center_tf, theta, fi):
    """Gnomonic projection about center (theta_f, fi_f)
    (spherical_to_uv2)."""
    tf, ff = center_tf
    cost, sint = np.cos(theta), np.sin(theta)
    cosp2, sinp2 = np.cos(fi - ff), np.sin(fi - ff)
    cosc = np.cos(tf) * cost + np.sin(tf) * sint * cosp2
    inv = 1.0 / cosc
    u = sint * sinp2 * inv
    v = (np.sin(tf) * cost - np.cos(tf) * sint * cosp2) * inv
    return u, v


def _from_uv(center_tf, u, v):
    """Inverse gnomonic (uv_to_spherical)."""
    tf, ff = center_tf
    r = np.sqrt(u * u + v * v)
    cosc = 1.0 / np.sqrt(1 + r * r)
    sinc = np.sqrt(np.clip(1 - cosc * cosc, 0, 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        theta = np.arccos(np.clip(
            cosc * np.cos(tf) + v * sinc * np.sin(tf) / np.where(r == 0, 1, r),
            -1, 1))
        fi = ff + np.arctan2(u * sinc,
                             (r * np.sin(tf) * cosc - v * np.cos(tf) * sinc))
    theta = np.where(r == 0, tf, theta)
    fi = np.where(r == 0, ff, fi)
    return theta, np.mod(fi, 2 * np.pi)


def cap_surface_nodes(icap: int, nox: int, noy: int) -> np.ndarray:
    """(noy, nox, 2) (theta, fi) surface nodes of one cap
    (full_coord_of_cap)."""
    corners = cap_corners()[icap]
    P = _sph_to_xyz(corners[:, 0], corners[:, 1])   # corners 1..4 -> 0..3
    center = P.mean(axis=0)
    center /= np.linalg.norm(center)
    ctf = _xyz_to_sph(center)

    elx, ely = nox - 1, noy - 1
    # edge arcs: 1->2 and 4->3 bound the x direction; 1->4 and 2->3 the y
    e12 = even_divide_arc(elx, P[0], P[1])
    e43 = even_divide_arc(elx, P[3], P[2])
    e14 = even_divide_arc(ely, P[0], P[3])
    e23 = even_divide_arc(ely, P[1], P[2])

    def uv(pts):
        th, ff = _xyz_to_sph(pts)
        # unwrap fi near the cap center to avoid 0/2pi seams
        ff = ctf[1] + np.mod(ff - ctf[1] + np.pi, 2 * np.pi) - np.pi
        return np.stack(_to_uv(ctf, th, ff), axis=-1)

    u12, u43, u14, u23 = uv(e12), uv(e43), uv(e14), uv(e23)

    # interior nodes: intersect line (u12[i] -> u43[i]) with
    # (u14[j] -> u23[j])  (find_intersection of the gnomonic grid lines)
    nodes = np.zeros((noy, nox, 2))
    for i in range(nox):
        a1 = u43[i, 1] - u12[i, 1]
        b1 = u12[i, 0] - u43[i, 0]
        c1 = u43[i, 0] * u12[i, 1] - u12[i, 0] * u43[i, 1]
        for j in range(noy):
            a2 = u23[j, 1] - u14[j, 1]
            b2 = u14[j, 0] - u23[j, 0]
            c2 = u23[j, 0] * u14[j, 1] - u14[j, 0] * u23[j, 1]
            den = a1 * b2 - a2 * b1
            nodes[j, i, 0] = (b1 * c2 - b2 * c1) / den
            nodes[j, i, 1] = (a2 * c1 - a1 * c2) / den
    th, ff = _from_uv(ctf, nodes[..., 0], nodes[..., 1])
    return np.stack([th, ff], axis=-1)


class FullSphereMesh(NamedTuple):
    sx: np.ndarray        # (nno, 3) theta, fi, r (deduped global nodes)
    ien: np.ndarray       # (nel, 8) global node ids
    cap_of_element: np.ndarray   # (nel,)
    r: np.ndarray         # radial grid
    nno: int
    nel: int
    surf_ids: np.ndarray  # (n_surf_nodes,) global ids on the top surface
    bot_ids: np.ndarray
    surf_inverse: np.ndarray = None  # (12, noy, nox) cap grid -> surf node
    nodex: int = 0        # per-cap surface grid (for tracers/VTK)
    nodey: int = 0


def build_full_sphere_mesh(nodex: int, nodey: int, nodez: int,
                           radius_inner: float, radius_outer: float
                           ) -> FullSphereMesh:
    """12-cap shell mesh with seam nodes merged.

    nodex/nodey are per-cap surface node counts; nodez radial nodes.
    """
    r = np.linspace(radius_inner, radius_outer, nodez)
    all_xyz = []
    all_sph = []
    for c in range(12):
        s = cap_surface_nodes(c, nodex, nodey)          # (noy, nox, 2)
        all_sph.append(s)
        all_xyz.append(_sph_to_xyz(s[..., 0], s[..., 1]))

    # global dedupe of surface nodes by rounded Cartesian coordinates
    flat = np.concatenate([x.reshape(-1, 3) for x in all_xyz])
    key = np.round(flat * 1e9).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    n_surf = first.size
    surf_sph = np.concatenate([s.reshape(-1, 2) for s in all_sph])[first]

    # global node = surface node x radial level (r fastest)
    nno = n_surf * nodez
    sx = np.zeros((nno, 3))
    sx[:, 0] = np.repeat(surf_sph[:, 0], nodez)
    sx[:, 1] = np.repeat(surf_sph[:, 1], nodez)
    sx[:, 2] = np.tile(r, n_surf)

    # elements per cap
    ien_list = []
    cap_ids = []
    per_cap = nodex * nodey
    for c in range(12):
        inv = inverse[c * per_cap:(c + 1) * per_cap].reshape(nodey, nodex)
        for iy in range(nodey - 1):
            for ix in range(nodex - 1):
                s00 = inv[iy, ix]
                s10 = inv[iy, ix + 1]
                s11 = inv[iy + 1, ix + 1]
                s01 = inv[iy + 1, ix]
                for kz in range(nodez - 1):
                    base = np.array([s00, s10, s11, s01]) * nodez + kz
                    ien_list.append(np.concatenate([base, base + 1]))
                    cap_ids.append(c)
    ien = np.asarray(ien_list, dtype=np.int32)
    cap_of_element = np.asarray(cap_ids, dtype=np.int32)

    surf_ids = np.arange(n_surf) * nodez + (nodez - 1)
    bot_ids = np.arange(n_surf) * nodez
    surf_inverse = inverse.reshape(12, nodey, nodex).astype(np.int32)
    return FullSphereMesh(sx, ien, cap_of_element, r, nno, ien.shape[0],
                          surf_ids, bot_ids, surf_inverse, nodex, nodey)
