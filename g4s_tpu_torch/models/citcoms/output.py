"""Field output writers (counterpart of g4s_tpu/models/citcoms/output.py,
the reference's Output.c capability; the writers are the port's own copy).

CitcomS writes per-processor ASCII snapshots every storage_spacing steps:
coordinates (output_coord), velocity+temperature (output_velo), viscosity
(output_visc), surface observables (output_surf_botm) — citcoms/lib/
Output.c:41-50 dispatch. The same field files, single-rank layout
(<datafile>.<field>.<rank>.<step> naming), plus an optional compact npz
snapshot. Fields are brought to host numpy arrays first and written with
the reference's numpy calls, so a state gives the reference's bytes.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import torch


def host(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _path(cfg, field: str, step: int, rank: int = 0) -> str:
    os.makedirs(cfg.datadir, exist_ok=True)
    p = os.path.join(cfg.datadir, f"{cfg.datafile}.{field}.{rank}.{step}")
    return p + ".gz" if getattr(cfg, "output_format", "") == "ascii-gz" else p


def _open(path: str):
    """ascii-gz support (the reference's Output_gzdir.c gzipped variant)."""
    return gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")


def element_viscosity(model, state) -> np.ndarray:
    """(nel,) vpt-mean viscosity of the state's temperature."""
    from g4s_tpu_torch.models.citcoms.viscosity import viscosity_at_vpts
    return host(viscosity_at_vpts(model.cfg, model.mat, state.T, model.ien,
                                  model.N)).mean(axis=1)


def output_coord(model, rank: int = 0) -> str:
    """coordinates: node count then (theta, fi, r) rows (output_coord)."""
    p = _path(model.cfg, "coord", 0, rank)
    sx = model.mesh.sx
    with _open(p) as f:
        f.write(f"{sx.shape[0]}\n")
        np.savetxt(f, sx, fmt="%.6e")
    return p


def output_velo(model, state, step: int, rank: int = 0) -> str:
    """velocity + temperature rows (output_velo layout: Vt Vf Vr T)."""
    p = _path(model.cfg, "velo", step, rank)
    V = host(state.V)
    T = host(state.T)
    with _open(p) as f:
        f.write(f"{float(state.time):.6e} {V.shape[0]}\n")
        np.savetxt(f, np.column_stack([V, T]), fmt="%.6e")
    return p


def output_visc(model, state, step: int, rank: int = 0) -> str:
    """element-averaged viscosity per node layer (output_visc role)."""
    p = _path(model.cfg, "visc", step, rank)
    evisc = element_viscosity(model, state)
    with _open(p) as f:
        f.write(f"{evisc.shape[0]}\n")
        np.savetxt(f, evisc[:, None], fmt="%.6e")
    return p


def output_snapshot_npz(model, state, step: int) -> str:
    """One-file snapshot (the practical analog of the HDF5 writer,
    Output_h5.c): coords + all fields."""
    p = _path(model.cfg, "snap", step) + ".npz"
    np.savez(p, sx=model.mesh.sx, T=host(state.T), V=host(state.V),
             P=host(state.P), time=float(state.time), step=int(state.step))
    return p


def output(model, state, step: int) -> list:
    """Per-step output dispatch (Output.c output()): format selected by
    cfg.output_format — ascii field files (default), ascii-gz
    (Output_gzdir.c role), vtk StructuredGrid (Output_vtk.c role) or hdf5
    (needs h5py)."""
    fmt = getattr(model.cfg, "output_format", "ascii")
    if fmt == "hdf5":
        return [output_h5(model, state, step)]
    if fmt == "vtk":
        from g4s_tpu_torch.models.citcoms.vtk import output_vts, write_pvd
        vts = output_vts(model, state, step)
        log = getattr(model, "_vtk_series", None)
        if log is None:
            log = model._vtk_series = []
        log.append((float(state.time), vts))
        return [vts, write_pvd(model.cfg, log)]
    files = [output_velo(model, state, step), output_visc(model, state, step)]
    if step == 0:
        files.insert(0, output_coord(model))
    return files


def output_h5(model, state, step: int) -> str:
    """HDF5 snapshot (Output_h5.c role): /coord, /velocity, /temperature,
    /viscosity (+ scalar attrs time/step) in one file per step. Needs
    h5py, imported here only."""
    import h5py

    from g4s_tpu_torch.models.citcoms.vtk import nodal_viscosity
    p = _path(model.cfg, "h5", step).replace(".gz", "") + ".h5"
    with h5py.File(p, "w") as f:
        f.attrs["time"] = float(state.time)
        f.attrs["step"] = int(state.step)
        f.create_dataset("coord", data=np.asarray(model.mesh.sx))
        f.create_dataset("velocity", data=host(state.V))
        f.create_dataset("temperature", data=host(state.T))
        f.create_dataset("pressure", data=host(state.P))
        f.create_dataset("viscosity", data=nodal_viscosity(model, state))
    return p


def output_surf_botm(model, state, ops, step: int, rank: int = 0) -> list:
    """surf/botm files (Output.c output_surf_botm:394-440): 4 columns per
    surface node — topography, heat flux, V_theta, V_fi — at the top and
    bottom boundaries."""
    from g4s_tpu_torch.models.citcoms.observables import (dynamic_topography,
                                                          surface_heat_flux)
    cfg = model.cfg
    noz = cfg.nodez
    V = host(state.V)
    files = []
    for tag, top in (("surf", True), ("botm", False)):
        p = _path(model.cfg, tag, step, rank)
        hf = host(surface_heat_flux(model, state.T, top=top)[0]).ravel()
        if top:
            topo = host(dynamic_topography(model, state, ops)).ravel()
        else:
            # bottom radial stress analog: element-constant pressure of
            # the bottom layer scaled like the top writer
            P = host(state.P).reshape(cfg.nodey - 1, cfg.nodex - 1,
                                      cfg.nodez - 1)[:, :, 0]
            pn = np.zeros((cfg.nodey, cfg.nodex))
            cnt = np.zeros((cfg.nodey, cfg.nodex))
            for dy in (0, 1):
                for dx in (0, 1):
                    pn[dy:cfg.nodey - 1 + dy, dx:cfg.nodex - 1 + dx] += P
                    cnt[dy:cfg.nodey - 1 + dy, dx:cfg.nodex - 1 + dx] += 1
            topo = (pn / np.maximum(cnt, 1)).ravel() \
                / max(cfg.rayleigh, 1.0)
        k = noz - 1 if top else 0
        Vs = V.reshape(cfg.nodey, cfg.nodex, noz, 3)[:, :, k, :]
        with _open(p) as f:
            f.write(f"{rank} {cfg.nodex * cfg.nodey}\n")
            np.savetxt(f, np.column_stack(
                [topo, hf, Vs[..., 0].ravel(), Vs[..., 1].ravel()]),
                fmt="%.4e")
        files.append(p)
    return files


def output_horiz_avg(model, state, step: int, rank: int = 0) -> str:
    """Layer horizontal averages (Output.c output_horiz_avg +
    Process_buoyancy.c compute_horiz_avg): r, <T>, <|Vxy|>, <|Vr|> per
    z-layer, surface-area weighted."""
    cfg = model.cfg
    noz = cfg.nodez
    layer = np.arange(model.mesh.nno) % noz
    w = host(model._layer_weights)
    wsum = np.bincount(layer, weights=w, minlength=noz)

    def ave(f):
        return np.bincount(layer, weights=host(f) * w,
                           minlength=noz) / wsum

    V = host(state.V)
    vxy = np.sqrt(V[:, 0] ** 2 + V[:, 1] ** 2)
    p = _path(model.cfg, "horiz_avg", step, rank)
    with _open(p) as f:
        np.savetxt(f, np.column_stack(
            [np.asarray(model.mesh.r), ave(state.T), ave(vxy),
             ave(np.abs(V[:, 2]))]), fmt="%.6e")
    return p


def output_pressure(model, state, step: int, rank: int = 0) -> str:
    """Element pressures (Output.c output_pressure)."""
    p = _path(model.cfg, "pressure", step, rank)
    P = host(state.P)
    with _open(p) as f:
        f.write(f"{float(state.time):.6e} {P.shape[0]}\n")
        np.savetxt(f, P[:, None], fmt="%.6e")
    return p


def output_tracer(model, pos, flavors, step: int, rank: int = 0) -> str:
    """Tracer positions + flavors (Output.c output_tracer)."""
    p = _path(model.cfg, "tracer", step, rank)
    pos = host(pos)
    with _open(p) as f:
        f.write(f"{pos.shape[0]}\n")
        np.savetxt(f, np.column_stack([pos, host(flavors)]),
                   fmt="%.6e %.6e %.6e %d")
    return p


def output_stress(model, state, ops, step: int, rank: int = 0) -> str:
    """Nodal deviatoric stress, 6 Voigt components (Output.c
    output_stress / get_STD_topo's stress assembly): sigma = 2 eta eps
    from the B tensor, vpt-averaged per element, volume-weighted to
    nodes."""
    from g4s_tpu_torch.models.citcoms.viscosity import viscosity_at_vpts
    u_el = state.V[model.ien]
    eps = torch.einsum("egsai,eai->egs", model.B, u_el)      # (nel, 8g, 6)
    evisc = viscosity_at_vpts(model.cfg, model.mat, state.T, model.ien,
                              model.N)
    sig = (2.0 * evisc[:, :, None] * eps).mean(dim=1)        # (nel, 6)
    ien = host(model.ien)
    nno = model.mesh.nno
    acc = np.zeros((nno, 6))
    cnt = np.zeros(nno)
    np.add.at(acc, ien.ravel(), np.repeat(host(sig), 8, axis=0))
    np.add.at(cnt, ien.ravel(), 1.0)
    snode = acc / np.maximum(cnt, 1.0)[:, None]
    p = _path(model.cfg, "stress", step, rank)
    with _open(p) as f:
        f.write(f"{float(state.time):.6e} {nno}\n")
        np.savetxt(f, snode, fmt="%.6e")
    return p
