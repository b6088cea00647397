"""Minimal pure-Python netCDF-3 (classic / 64-bit-offset) reader (the
port's own copy of g4s_tpu/models/citcoms/netcdf3.py, numpy only).

The reference reads GMT grd files through libgmt/netCDF
(citcoms/lib/Ggrd_handling.c via the hc/ggrd library). The port needs no
netCDF library: GMT grd files (netCDF classic) follow the public
CDF-1/CDF-2 container format — a few dozen lines of header
parsing plus big-endian array reads. Only what grd input needs is
implemented: dimensions, variables (all numeric types), attributes
(for scale_factor/add_offset/actual_range), no record dimension
streaming beyond the classic layout, no HDF5-backed netCDF-4 (raises
with a clear message).

Format: https://www.unidata.ucar.edu/software/netcdf/docs (classic
format spec); this is an independent implementation of that public
specification.
"""

from __future__ import annotations

import struct

import numpy as np

_NC_BYTE, _NC_CHAR, _NC_SHORT, _NC_INT, _NC_FLOAT, _NC_DOUBLE = range(1, 7)
_DTYPES = {_NC_BYTE: np.dtype(">i1"), _NC_CHAR: np.dtype("S1"),
           _NC_SHORT: np.dtype(">i2"), _NC_INT: np.dtype(">i4"),
           _NC_FLOAT: np.dtype(">f4"), _NC_DOUBLE: np.dtype(">f8")}
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 10, 11, 12


class _Reader:
    def __init__(self, data: bytes, offset_64: bool):
        self.b = data
        self.p = 4
        self.offsize = 8 if offset_64 else 4

    def u32(self):
        v = struct.unpack_from(">I", self.b, self.p)[0]
        self.p += 4
        return v

    def offset(self):
        if self.offsize == 8:
            v = struct.unpack_from(">Q", self.b, self.p)[0]
            self.p += 8
        else:
            v = self.u32()
        return v

    def name(self):
        n = self.u32()
        s = self.b[self.p: self.p + n].decode("latin1")
        self.p += (n + 3) & ~3           # 4-byte aligned
        return s

    def values(self, nc_type, n):
        dt = _DTYPES[nc_type]
        nbytes = dt.itemsize * n
        arr = np.frombuffer(self.b, dt, count=n, offset=self.p)
        self.p += (nbytes + 3) & ~3
        if nc_type == _NC_CHAR:
            return arr.tobytes().decode("latin1")
        return arr

    def att_list(self):
        tag = self.u32()
        n = self.u32()
        atts = {}
        if tag == 0 and n == 0:
            return atts
        assert tag == _NC_ATTRIBUTE, tag
        for _ in range(n):
            nm = self.name()
            t = self.u32()
            cnt = self.u32()
            atts[nm] = self.values(t, cnt)
        return atts


def read_netcdf3(path):
    """-> (dims: {name: size}, vars: {name: (data, attrs)}).

    Applies scale_factor/add_offset when present (GMT grd convention)."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:4]
    if magic[:3] != b"CDF":
        if data[:8] == b"\x89HDF\r\n\x1a\n":
            raise NotImplementedError(
                "netCDF-4 (HDF5-backed) grd file; convert with "
                "`nccopy -k classic` or supply the npz layout")
        raise ValueError(f"not a netCDF classic file: magic={magic!r}")
    version = magic[3]
    if version not in (1, 2):
        raise NotImplementedError(f"netCDF classic version {version}")
    r = _Reader(data, offset_64=(version == 2))

    numrecs = r.u32()
    # dimensions
    tag = r.u32()
    ndims = r.u32()
    dims = {}
    dim_sizes = []
    if ndims:
        assert tag == _NC_DIMENSION
    for _ in range(ndims):
        nm = r.name()
        sz = r.u32()
        dims[nm] = sz
        dim_sizes.append(sz)
    r.att_list()                           # global attributes (unused)
    tag = r.u32()
    nvars = r.u32()
    if nvars:
        assert tag == _NC_VARIABLE
    out = {}
    for _ in range(nvars):
        nm = r.name()
        nd = r.u32()
        shape = []
        for _ in range(nd):
            shape.append(dim_sizes[r.u32()])
        atts = r.att_list()
        nc_type = r.u32()
        r.u32()                            # vsize (padded byte count)
        begin = r.offset()
        n = int(np.prod(shape)) if shape else 1
        # record variables (first dim = unlimited 0) are rare in grd
        if shape and shape[0] == 0:
            shape[0] = numrecs
            n = int(np.prod(shape))
        dt = _DTYPES[nc_type]
        arr = np.frombuffer(data, dt, count=n, offset=begin).reshape(shape)
        arr = arr.astype(np.float64) if nc_type != _NC_CHAR else arr
        if "scale_factor" in atts:
            arr = arr * float(np.asarray(atts["scale_factor"])[0])
        if "add_offset" in atts:
            arr = arr + float(np.asarray(atts["add_offset"])[0])
        out[nm] = (arr, atts)
    return dims, out


def read_grd(path):
    """GMT grd -> (lon (nx,), lat (ny,), z (ny, nx)).

    Supports both COARDS-style grids (variables lon/lat/z or x/y/z) and
    the old GMT pixel layout (x_range/y_range/z with spacing)."""
    dims, vars_ = read_netcdf3(path)

    def pick(*names):
        for nm in names:
            if nm in vars_:
                return vars_[nm][0]
        return None

    z = pick("z", "elevation", "w")
    if z is None:
        raise ValueError(f"no z variable in {path}: {list(vars_)}")
    lon = pick("lon", "x")
    lat = pick("lat", "y")
    if lon is not None and lon.ndim == 1 and z.ndim == 2:
        return np.asarray(lon), np.asarray(lat), np.asarray(z)
    # old-style: x_range/y_range + spacing, z flattened row-major from NW
    xr = pick("x_range")
    yr = pick("y_range")
    sp = pick("spacing")
    dim = pick("dimension")
    if xr is None:
        raise ValueError("unrecognized grd layout")
    nx, ny = int(dim[0]), int(dim[1])
    lon = np.linspace(xr[0], xr[1], nx)
    lat = np.linspace(yr[0], yr[1], ny)
    zz = np.asarray(z).reshape(ny, nx)[::-1]   # rows start at north
    return lon, lat, zz
