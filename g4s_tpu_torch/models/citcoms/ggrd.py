"""Gridded initial-condition input (counterpart of
g4s_tpu/models/citcoms/ggrd.py, the reference's Ggrd_handling.c role;
numpy only).

The reference interpolates GMT/netCDF grd files onto the mesh for initial
temperature / tracer flavors / viscosity prefactors
(ggrd_temp_init_general, Ggrd_handling.c:196-300: per-depth-layer grids,
grdtrack bilinear interpolation at each node, optional scaling/offset and
PREM-based density-to-temperature conversion).

The loaders accept:
  - .npz with arrays {"lon" (nx,), "lat" (ny,), "depth" (nd,),
    "field" (nd, ny, nx)}   [degrees, degrees, nondim depth]
  - classic netCDF .grd files, through the pure-Python netcdf3 reader
    (one file with a depth dimension, or one file per depth layer)
and interpolation is trilinear (theta, fi, r) onto mesh nodes — the same
math grdtrack performs per layer plus linear blending between layers.
"""

from __future__ import annotations

import numpy as np

from g4s_tpu_torch.models.citcoms.mesh import initial_temperature
from g4s_tpu_torch.models.citcoms.netcdf3 import read_grd, read_netcdf3


def load_grid(path):
    """-> (lon_deg, lat_deg, depth, field[nd, ny, nx])."""
    if str(path).endswith(".npz"):
        z = np.load(path)
        return (np.asarray(z["lon"], np.float64),
                np.asarray(z["lat"], np.float64),
                np.asarray(z["depth"], np.float64),
                np.asarray(z["field"], np.float64))
    # netCDF grd: single file with a depth dimension, or use
    # load_grd_layers for the reference's one-file-per-depth convention
    dims, vars_ = read_netcdf3(path)

    def pick(*names):
        for nm in names:
            if nm in vars_:
                return np.asarray(vars_[nm][0], np.float64)
        return None
    lon = pick("lon", "x")
    lat = pick("lat", "y")
    dep = pick("depth", "z_levels")
    fld = pick("field", "z", "w")
    if lon is None or lat is None or fld is None:
        raise ValueError(f"unrecognized grd layout in {path}: {list(vars_)}")
    if fld.ndim == 2:
        fld = fld[None]
        dep = np.zeros(1) if dep is None else dep
    return lon, lat, dep, fld


def load_grd_layers(paths, depths):
    """The reference's per-depth-layer convention (Ggrd_handling.c:196:
    one GMT grd file per radial layer) -> stacked (lon, lat, depth,
    field[nd, ny, nx])."""
    lons, lats, zs = None, None, []
    for p in paths:
        lon, lat, z = read_grd(p)
        if lons is None:
            lons, lats = lon, lat
        else:
            if not (np.allclose(lon, lons) and np.allclose(lat, lats)):
                raise ValueError("layer grids must share lon/lat axes")
        zs.append(z)
    return (np.asarray(lons), np.asarray(lats),
            np.asarray(depths, np.float64), np.stack(zs))


def _interp1_weights(grid, x):
    """Clamped linear-interp indices/weights along one axis."""
    i = np.searchsorted(grid, x) - 1
    i = np.clip(i, 0, len(grid) - 2)
    w = (x - grid[i]) / (grid[i + 1] - grid[i])
    return i, np.clip(w, 0.0, 1.0)


def interpolate_to_mesh(mesh, lon, lat, depth, field,
                        *, scale=1.0, offset=0.0):
    """Trilinear interpolation of field(depth, lat, lon) onto mesh nodes.

    mesh.sx columns are (theta, fi, r); geographic conversion is
    lat = 90 - theta*180/pi, lon = fi*180/pi (Ggrd_handling.c:150-158).
    Returns (nno,) values scale*f + offset.
    """
    sx = np.asarray(mesh.sx)
    node_lat = 90.0 - np.degrees(sx[:, 0])
    node_lon = np.degrees(sx[:, 1])
    node_dep = 1.0 - sx[:, 2] / sx[:, 2].max()
    ilo, wlo = _interp1_weights(lon, node_lon)
    ila, wla = _interp1_weights(lat, node_lat)
    idp, wdp = _interp1_weights(depth, node_dep) if len(depth) > 1 else \
        (np.zeros(sx.shape[0], int), np.zeros(sx.shape[0]))

    def at(d, a, o):
        return field[d, a, o]

    out = np.zeros(sx.shape[0])
    for dd, wd in ((0, 1.0 - wdp), (1, wdp)):
        d = np.clip(idp + dd, 0, field.shape[0] - 1)
        for aa, wa in ((0, 1.0 - wla), (1, wla)):
            a = ila + aa
            for oo, wo in ((0, 1.0 - wlo), (1, wlo)):
                o = ilo + oo
                out += wd * wa * wo * at(d, a, o)
    return scale * out + offset


def ggrd_temp_init(model, path, *, scale=1.0, offset=0.0,
                   clip=(0.0, 1.0)):
    """Initial temperature from a gridded anomaly file added onto the
    conductive profile (ggrd_temp_init_general semantics: grid supplies
    the anomaly; background is the mean profile). `model` is a regional
    CitcomModel; returns the host (nno,) f64 temperature, which
    state_from_numpy or dataclasses.replace puts on the model's device."""
    lon, lat, depth, field = load_grid(path)
    anom = interpolate_to_mesh(model.mesh, lon, lat, depth, field,
                               scale=scale, offset=offset)
    T = np.asarray(initial_temperature(model.mesh)) + anom
    return np.clip(T, *clip)
