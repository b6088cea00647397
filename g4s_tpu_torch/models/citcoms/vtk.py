"""VTK XML snapshots (counterpart of g4s_tpu/models/citcoms/vtk.py, the
reference's Output_vtk.c; the writers are the port's own copy).

The reference writes one `.vts` per processor cap with temperature,
Cartesian velocity, viscosity and Cartesian coordinates
(citcoms/lib/Output_vtk.c:48-66 header, :119-129 temperature,
:144-167 spherical->Cartesian velocity, :171-186 viscosity,
:190-214 coordinates), plus a `.pvts`/`.visit` master per step.

Single rank: the same `.vts` layout — VTK point order is "x fastest",
which maps directly onto the (noy, nox, noz) z-fastest node ordering by
declaring extent (noz, nox, noy) — with inline base64 ("binary") or ascii
DataArrays, and a `.pvd` time-series master that ParaView/VisIt open
directly.
"""

from __future__ import annotations

import base64
import os

import numpy as np

from g4s_tpu_torch.models.citcoms.output import element_viscosity, host


def _data_array(f, name: str, arr: np.ndarray, fmt: str,
                ncomp: int | None = None) -> None:
    comp = f' NumberOfComponents="{ncomp}"' if ncomp else ""
    f.write(f'        <DataArray type="Float32" Name="{name}"{comp} '
            f'format="{fmt}">\n')
    flat = np.ascontiguousarray(arr, dtype=np.float32)
    if fmt == "binary":
        payload = flat.tobytes()
        blob = np.uint32(len(payload)).tobytes() + payload
        f.write(base64.b64encode(blob).decode("ascii"))
        f.write("\n")
    else:
        np.savetxt(f, flat.reshape(-1, ncomp or 1), fmt="%.7e")
    f.write("        </DataArray>\n")


def sphere_to_cart_velocity(sx: np.ndarray, V: np.ndarray) -> np.ndarray:
    """(u_theta, u_fi, u_r) -> (u_x, u_y, u_z) per node (Output_vtk.c:
    144-167 sint/cost/sinf/cosf rotation)."""
    t, p = sx[:, 0], sx[:, 1]
    st, ct, sp_, cp = np.sin(t), np.cos(t), np.sin(p), np.cos(p)
    ut, up, ur = V[:, 0], V[:, 1], V[:, 2]
    return np.column_stack([
        ct * cp * ut - sp_ * up + st * cp * ur,
        ct * sp_ * ut + cp * up + st * sp_ * ur,
        -st * ut + ct * ur,
    ])


def nodal_viscosity(model, state) -> np.ndarray:
    """Element vpt-mean viscosity scattered to nodes (the role of the
    nodal VI field the reference outputs)."""
    evisc = element_viscosity(model, state)
    ien = host(model.ien)
    nno = model.mesh.nno
    acc = np.zeros(nno)
    cnt = np.zeros(nno)
    np.add.at(acc, ien.ravel(), np.repeat(evisc, ien.shape[1]))
    np.add.at(cnt, ien.ravel(), 1.0)
    return acc / np.maximum(cnt, 1.0)


def _xyz(sx: np.ndarray) -> np.ndarray:
    t, p, r = sx[:, 0], sx[:, 1], sx[:, 2]
    return np.column_stack([r * np.sin(t) * np.cos(p),
                            r * np.sin(t) * np.sin(p),
                            r * np.cos(t)])


def output_vts(model, state, step: int, rank: int = 0) -> str:
    """Write one StructuredGrid snapshot; returns the path."""
    cfg = model.cfg
    os.makedirs(cfg.datadir, exist_ok=True)
    path = os.path.join(cfg.datadir,
                        f"{cfg.datafile}.proc{rank}.{step}.vts")
    fmt = getattr(cfg, "vtk_format", "binary")
    nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
    extent = f"0 {noz - 1} 0 {nox - 1} 0 {noy - 1}"
    sx = np.asarray(model.mesh.sx)
    with open(path, "w") as f:
        f.write('<VTKFile type="StructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write(f'  <StructuredGrid WholeExtent="{extent}">\n')
        f.write(f'    <Piece Extent="{extent}">\n')
        f.write('      <PointData Scalars="temperature" '
                'Vectors="velocity">\n')
        _data_array(f, "temperature", host(state.T), fmt)
        _data_array(f, "velocity",
                    sphere_to_cart_velocity(sx, host(state.V)),
                    fmt, ncomp=3)
        _data_array(f, "viscosity", nodal_viscosity(model, state), fmt)
        f.write('      </PointData>\n')
        f.write('      <CellData>\n      </CellData>\n')
        f.write('      <Points>\n')
        _data_array(f, "coordinate", _xyz(sx), fmt, ncomp=3)
        f.write('      </Points>\n')
        f.write('    </Piece>\n  </StructuredGrid>\n</VTKFile>\n')
    return path


def write_pvd(cfg, entries) -> str:
    """Time-series master (`.pvd`): [(time, vts_path), ...] — the
    single-rank analog of the reference's .visit/.pvts masters
    (Output_vtk.c:329-360)."""
    path = os.path.join(cfg.datadir, f"{cfg.datafile}.pvd")
    with open(path, "w") as f:
        f.write('<VTKFile type="Collection" version="0.1" '
                'byte_order="LittleEndian">\n  <Collection>\n')
        for tm, vts in entries:
            f.write(f'    <DataSet timestep="{tm:.6e}" '
                    f'file="{os.path.basename(vts)}"/>\n')
        f.write('  </Collection>\n</VTKFile>\n')
    return path


def read_vts_points(path: str) -> dict:
    """Minimal reader for round-trip checks: returns the named float32
    arrays of a file written by output_vts."""
    import re
    out = {}
    with open(path) as fh:
        text = fh.read()
    for m in re.finditer(
            r'<DataArray type="Float32" Name="([^"]+)"'
            r'(?: NumberOfComponents="(\d+)")? format="(\w+)">\n(.*?)'
            r'\s*</DataArray>', text, re.S):
        name, ncomp, fmt, body = m.groups()
        if fmt == "binary":
            blob = base64.b64decode(body.strip())
            n = np.frombuffer(blob[:4], np.uint32)[0]
            arr = np.frombuffer(blob[4:4 + int(n)], np.float32)
        else:
            arr = np.array(body.split(), dtype=np.float64).astype(np.float32)
        if ncomp:
            arr = arr.reshape(-1, int(ncomp))
        out[name] = arr
    return out


def output_vtu(model, state, path, *, fmt="binary") -> str:
    """UnstructuredGrid snapshot (hexahedral cells from the global ien):
    the analog of output_vts for any hexahedral mesh, a merged global
    mesh being naturally a .vtu."""
    m = model.mesh
    sx = np.asarray(m.sx)
    ien = np.asarray(m.ien)
    nel, nno = ien.shape[0], sx.shape[0]
    with open(path, "w") as f:
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n  <UnstructuredGrid>\n')
        f.write(f'    <Piece NumberOfPoints="{nno}" '
                f'NumberOfCells="{nel}">\n')
        f.write('      <PointData Scalars="temperature" '
                'Vectors="velocity">\n')
        _data_array(f, "temperature", host(state.T), fmt)
        _data_array(f, "velocity",
                    sphere_to_cart_velocity(sx, host(state.V)),
                    fmt, ncomp=3)
        f.write('      </PointData>\n      <Points>\n')
        _data_array(f, "coordinate", _xyz(sx), fmt, ncomp=3)
        f.write('      </Points>\n      <Cells>\n')
        f.write('        <DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        np.savetxt(f, ien, fmt="%d")
        f.write('        </DataArray>\n')
        f.write('        <DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        np.savetxt(f, 8 * np.arange(1, nel + 1)[:, None], fmt="%d")
        f.write('        </DataArray>\n')
        f.write('        <DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        np.savetxt(f, np.full((nel, 1), 12, np.uint8), fmt="%d")
        f.write('        </DataArray>\n      </Cells>\n')
        f.write('    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n')
    return path
