"""Full-sphere tracer advection + composition (counterpart of
g4s_tpu/models/citcoms/full_tracers.py, the reference's
Full_tracer_advection.c capability).

The reference's full-sphere tracer subsystem finds, per tracer per step,
the cap containing the point (icheck_cap / icheck_all_caps), locates the
element inside the cap through a regular-grid overlay of the gnomonic plane
(make_regular_grid / iget_element), interpolates velocity with cap shape
functions (full_get_velocity), advances with a predictor-corrector step and
exchanges tracers that crossed cap/processor boundaries (lost_souls).

Here everything is closed-form batched math over the whole tracer array:

  * tracers live in Cartesian xyz (pole-safe);
  * cap membership: the gnomonic projection of each cap is evaluated for
    all 12 caps at once as three dot products (u = p.e_u / p.n etc.), and
    the cap with the largest interior margin wins;
  * element location: each cap's surface grid lines are straight lines in
    its own gnomonic plane (that is how the mesh is built), so the (ix, iy)
    cell indices are sign counts of oriented line equations;
  * local coordinates: 3 Newton steps invert the bilinear cell map in the
    gnomonic plane; the radial level is closed-form on the uniform r grid;
  * velocity: nodal spherical components are rotated to Cartesian with
    per-node bases built once, and interpolated bilinearly x linear-in-r;
  * crossing a seam just changes the computed cap index.

Composition follows the regional ratio method (Composition_related.c):
element counts are integer sums (int64 index_add_, exact in any order of
addition and with no host read), divided in float32 as the reference
divides them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.models.citcoms.full_mesh import (FullSphereMesh,
                                                    _sph_to_xyz, _xyz_to_sph,
                                                    cap_corners,
                                                    cap_surface_nodes)
from g4s_tpu_torch.sparse.containers import resolve_device


def _cap_frames() -> np.ndarray:
    """(12, 3, 3) rows = (n_hat, e_u, e_v) of each cap's gnomonic frame,
    matching _to_uv's convention: u = p.e_u / p.n, v = p.e_v / p.n."""
    frames = np.zeros((12, 3, 3))
    corners = cap_corners()
    for c in range(12):
        P = _sph_to_xyz(corners[c, :, 0], corners[c, :, 1])
        n = P.mean(axis=0)
        n /= np.linalg.norm(n)
        tf, ff = _xyz_to_sph(n)
        e_u = np.array([-np.sin(ff), np.cos(ff), 0.0])
        e_v = np.array([-np.cos(tf) * np.cos(ff),
                        -np.cos(tf) * np.sin(ff), np.sin(tf)])
        frames[c] = np.stack([n, e_u, e_v])
    return frames


def _grid_lines(uv: np.ndarray):
    """Oriented line equations of both grid families of one cap.

    uv: (noy, nox, 2) node coordinates in the cap's gnomonic plane.
    Returns (lx (nox, 3), ly (noy, 3)) with (a, b, c) normalized and
    oriented so that a point in cell (iy, ix) has positive values on
    lines 0..ix (family x) / 0..iy (family y) and negative beyond.
    """
    def fam(p0s, p1s):
        a = p1s[:, 1] - p0s[:, 1]
        b = p0s[:, 0] - p1s[:, 0]
        c = p1s[:, 0] * p0s[:, 1] - p0s[:, 0] * p1s[:, 1]
        norm = np.hypot(a, b)
        a, b, c = a / norm, b / norm, c / norm
        # orient: line i positive toward the LAST line's midpoint
        mids = 0.5 * (p0s + p1s)
        ref_last, ref_first = mids[-1], mids[0]
        for i in range(len(a)):
            ref = ref_last if i < len(a) - 1 else ref_first
            s = a[i] * ref[0] + b[i] * ref[1] + c[i]
            if i == len(a) - 1:
                s = -s      # last line: first line's side is the interior
            if s < 0:
                a[i], b[i], c[i] = -a[i], -b[i], -c[i]
        return np.stack([a, b, c], axis=1)

    lx = fam(uv[0, :, :], uv[-1, :, :])       # lines of constant ix
    ly = fam(uv[:, 0, :], uv[:, -1, :])       # lines of constant iy
    return lx, ly


class FullTracerField(NamedTuple):
    """Static location/interpolation tables for the 12-cap shell, built in
    f64 on the host and held on the model's device in its dtype."""
    frames: torch.Tensor        # (12, 3, 3) gnomonic frames
    lines_x: torch.Tensor       # (12, nox, 3)
    lines_y: torch.Tensor       # (12, noy, 3)
    uv_nodes: torch.Tensor      # (12, noy, nox, 2)
    surf_inverse: torch.Tensor  # (12, noy, nox) -> global surface node
    sph_basis: torch.Tensor     # (nno, 3, 3) cols e_theta, e_fi, e_r
    nox: int
    noy: int
    noz: int
    r0: float
    dr: float
    r1: float

    @staticmethod
    def build(mesh: FullSphereMesh, *, dtype=torch.float64,
              device="cuda") -> "FullTracerField":
        dev = resolve_device(device)
        nox, noy, noz = mesh.nodex, mesh.nodey, len(mesh.r)
        frames = _cap_frames()
        lxs, lys, uvs = [], [], []
        for c in range(12):
            s = cap_surface_nodes(c, nox, noy)          # (noy, nox, 2)
            n, e_u, e_v = frames[c]
            p = _sph_to_xyz(s[..., 0], s[..., 1])
            uv = np.stack([p @ e_u, p @ e_v], axis=-1) / (p @ n)[..., None]
            lx, ly = _grid_lines(uv)
            lxs.append(lx)
            lys.append(ly)
            uvs.append(uv)
        th, ff = mesh.sx[:, 0], mesh.sx[:, 1]
        st, ct = np.sin(th), np.cos(th)
        sf, cf = np.sin(ff), np.cos(ff)
        e_t = np.stack([ct * cf, ct * sf, -st], 1)
        e_f = np.stack([-sf, cf, np.zeros_like(sf)], 1)
        e_r = np.stack([st * cf, st * sf, ct], 1)
        basis = np.stack([e_t, e_f, e_r], axis=2)        # (nno, 3, 3)
        r = mesh.r
        # locate() uses the closed form (r - r0)/dr for the radial level,
        # which would mislocate tracers on a graded radial mesh
        if r.size > 2 and not np.allclose(np.diff(r), r[1] - r[0],
                                          rtol=1e-6, atol=0.0):
            raise NotImplementedError(
                "FullTracerField requires a uniform radial grid; graded "
                "meshes need searchsorted-based radial location")

        def to(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        return FullTracerField(
            to(frames), to(np.stack(lxs)), to(np.stack(lys)),
            to(np.stack(uvs)),
            torch.from_numpy(mesh.surf_inverse.astype(np.int64)).to(dev),
            to(basis), nox, noy, noz, float(r[0]), float(r[1] - r[0]),
            float(r[-1]))


def locate(tf: FullTracerField, pos):
    """pos (n, 3) Cartesian -> (cap, iy, ix, kz, uv, wz).

    cap by largest interior margin over all 12 gnomonic frames (the
    icheck_all_caps role); (iy, ix) by oriented-line sign counts."""
    pn = pos @ tf.frames[:, 0].T                 # (n, 12)
    pu = pos @ tf.frames[:, 1].T
    pv = pos @ tf.frames[:, 2].T
    safe = torch.where(pn > 1e-9, pn, 1e-9)
    u = pu / safe                                # (n, 12)
    v = pv / safe

    # signed values on all lines of each family: (n, 12, nox/noy)
    lx, ly = tf.lines_x[None], tf.lines_y[None]
    sx = (u[..., None] * lx[..., 0] + v[..., None] * lx[..., 1]
          + lx[..., 2])
    sy = (u[..., None] * ly[..., 0] + v[..., None] * ly[..., 1]
          + ly[..., 2])
    # interior margin per cap: min signed distance to the 4 boundary
    # lines (first lines are positive-inside, last lines negative-inside
    # by _grid_lines' orientation); hemisphere guard via pn
    margin = torch.minimum(
        torch.minimum(torch.minimum(sx[:, :, 0], -sx[:, :, -1]),
                      torch.minimum(sy[:, :, 0], -sy[:, :, -1])),
        pn * 10.0)
    cap = torch.argmax(margin, dim=1)                       # (n,) int64

    def take(arr):
        idx = cap[:, None, None].expand(-1, 1, arr.shape[2])
        return torch.gather(arr, 1, idx)[:, 0]

    sxc = take(sx)                                # (n, nox)
    syc = take(sy)                                # (n, noy)
    ix = ((sxc > 0).sum(dim=1) - 1).clamp(0, tf.nox - 2)
    iy = ((syc > 0).sum(dim=1) - 1).clamp(0, tf.noy - 2)
    uv = torch.stack([torch.gather(u, 1, cap[:, None])[:, 0],
                      torch.gather(v, 1, cap[:, None])[:, 0]], dim=1)

    r = torch.linalg.vector_norm(pos, dim=1)
    tz = (r - tf.r0) / tf.dr
    kz = tz.to(torch.int32).clamp(0, tf.noz - 2).long()
    wz = (tz - kz).clamp(0.0, 1.0)
    return cap, iy, ix, kz, uv, wz


def _cell_corners_uv(tf: FullTracerField, cap, iy, ix):
    """(n, 4, 2) cell corner uv in order s00, s10, s11, s01."""
    flat = tf.uv_nodes.reshape(12 * tf.noy * tf.nox, 2)
    base = (cap * tf.noy + iy) * tf.nox + ix
    ids = torch.stack([base, base + 1, base + tf.nox + 1, base + tf.nox], 1)
    return flat[ids]


def _bilinear_inverse(corners, p, iters: int = 3):
    """Local (xi, eta) in [-1,1]^2 with p = sum_k w_k(xi,eta) corners_k.

    Newton on the 2x2 system; cells are near-parallelograms in the
    gnomonic plane so 3 iterations reach machine precision.
    """
    c00, c10, c11, c01 = (corners[:, 0], corners[:, 1],
                          corners[:, 2], corners[:, 3])
    a0 = 0.25 * (c00 + c10 + c11 + c01)
    ax = 0.25 * (-c00 + c10 + c11 - c01)
    ay = 0.25 * (-c00 - c10 + c11 + c01)
    axy = 0.25 * (c00 - c10 + c11 - c01)
    xi = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    eta = torch.zeros_like(xi)
    for _ in range(iters):
        F = a0 + ax * xi[:, None] + ay * eta[:, None] \
            + axy * (xi * eta)[:, None] - p
        Jx = ax + axy * eta[:, None]
        Jy = ay + axy * xi[:, None]
        det = Jx[:, 0] * Jy[:, 1] - Jx[:, 1] * Jy[:, 0]
        det = torch.where(det.abs() > 1e-30, det, 1e-30)
        dxi = (F[:, 0] * Jy[:, 1] - F[:, 1] * Jy[:, 0]) / det
        deta = (Jx[:, 0] * F[:, 1] - Jx[:, 1] * F[:, 0]) / det
        xi, eta = xi - dxi, eta - deta
    return xi.clamp(-1.0, 1.0), eta.clamp(-1.0, 1.0)


def interp_weights(tf: FullTracerField, pos):
    """(node_ids (n, 8), weights (n, 8)) of the trilinear interpolation
    stencil at arbitrary Cartesian positions: the sampling primitive the
    Exchanger coupler also uses (the Exchanger's FEMInterpolator role)."""
    cap, iy, ix, kz, uv, wz = locate(tf, pos)
    corners = _cell_corners_uv(tf, cap, iy, ix)
    xi, eta = _bilinear_inverse(corners, uv)
    wx = torch.stack([0.5 * (1 - xi), 0.5 * (1 + xi)], 1)     # along ix
    wy = torch.stack([0.5 * (1 - eta), 0.5 * (1 + eta)], 1)   # along iy
    wr = torch.stack([1 - wz, wz], 1)
    flat_inv = tf.surf_inverse.reshape(-1)
    ids, wts = [], []
    for dy in range(2):
        for dx in range(2):
            sid = flat_inv[(cap * tf.noy + iy + dy) * tf.nox + ix + dx]
            for dz in range(2):
                ids.append(sid * tf.noz + kz + dz)
                wts.append(wy[:, dy] * wx[:, dx] * wr[:, dz])
    return torch.stack(ids, 1), torch.stack(wts, 1)


def interp_field(tf: FullTracerField, F, pos):
    """Sample a nodal field F (nno,) or (nno, m) at Cartesian positions."""
    ids, w = interp_weights(tf, pos)
    vals = F[ids]                                   # (n, 8[, m])
    if vals.dim() == 3:
        return (w[:, :, None] * vals).sum(dim=1)
    return (w * vals).sum(dim=1)


def interp_velocity(tf: FullTracerField, V, pos):
    """Cartesian velocity at tracer positions.

    V (nno, 3) spherical components at nodes -> rotated to Cartesian with
    the static per-node basis, then bilinear (gnomonic cell) x linear (r).
    """
    ids, w = interp_weights(tf, pos)
    vc = torch.einsum("nkij,nkj->nki", tf.sph_basis[ids], V[ids])
    return (w[:, :, None] * vc).sum(dim=1)


def clip_radius(tf: FullTracerField, pos):
    r = torch.linalg.vector_norm(pos, dim=1, keepdim=True)
    eps = 1e-9
    rc = r.clamp(tf.r0 + eps, tf.r1 - eps)
    return pos * (rc / r)


def advect_tracers(tf: FullTracerField, V, pos, dt):
    """Predictor-corrector midpoint step in Cartesian coordinates
    (the reference's predict_tracers/correct_tracers pair)."""
    v1 = interp_velocity(tf, V, pos)
    mid = clip_radius(tf, pos + 0.5 * dt * v1)
    v2 = interp_velocity(tf, V, mid)
    return clip_radius(tf, pos + dt * v2)


def seed_tracers(mesh: FullSphereMesh, tracers_per_element: int,
                 *, seed: int = 0,
                 flavor_boundary_r: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-in-volume seeding over the shell (make_tracer_array) with
    depth-based two-flavor init (ic_method_for_flavors=0). The reference's
    draws exactly: numpy's default_rng(seed), on the host."""
    rng = np.random.default_rng(seed)
    n = mesh.nel * tracers_per_element
    # uniform on sphere x uniform in r^3 for volume uniformity
    zs = rng.uniform(-1.0, 1.0, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    s = np.sqrt(1 - zs ** 2)
    r0, r1 = float(mesh.r[0]), float(mesh.r[-1])
    r = (rng.uniform(r0 ** 3, r1 ** 3, n)) ** (1.0 / 3.0)
    pos = np.stack([s * np.cos(ph), s * np.sin(ph), zs], 1) * r[:, None]
    if flavor_boundary_r is None:
        flavor_boundary_r = 0.5 * (r0 + r1)
    flavors = (r < flavor_boundary_r).astype(np.int32)
    return pos, flavors


def element_composition(tf: FullTracerField, mesh: FullSphereMesh,
                        pos, flavors, n_flavors: int = 2):
    """Ratio-method composition per element (Composition_related.c);
    element index follows the mesh build order
    (((cap*(noy-1)+iy)*(nox-1)+ix)*(noz-1)+kz).

    The counts are int64 index_add_ sums; the reference counts in float32
    and divides there, so the ratios are float32 whatever the positions'
    dtype. Returns (comp_el (n_flavors, nel), total (nel,)), float32."""
    cap, iy, ix, kz, _, _ = locate(tf, pos)
    el = ((cap * (tf.noy - 1) + iy) * (tf.nox - 1) + ix) * (tf.noz - 1) + kz
    nel = mesh.nel
    # one count per (element, flavor); a flavor outside 0..n_flavors-1
    # counts in the total only (slot nel * n_flavors)
    fl = flavors.long()
    valid = (fl >= 0) & (fl < n_flavors)
    key = torch.where(valid, el * n_flavors + fl, nel * n_flavors)
    ones = torch.ones_like(el)
    counts = torch.zeros(nel * n_flavors + 1, dtype=torch.int64,
                         device=pos.device).index_add_(0, key, ones)
    total_i = torch.zeros(nel, dtype=torch.int64,
                          device=pos.device).index_add_(0, el, ones)
    total = total_i.to(torch.float32)
    per = counts[:-1].reshape(nel, n_flavors).to(torch.float32)
    den = total.clamp(min=1.0)
    return torch.stack([per[:, f] / den for f in range(n_flavors)]), total
