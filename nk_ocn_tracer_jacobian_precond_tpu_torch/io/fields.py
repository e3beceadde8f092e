"""Typed whole-variable accessors over the NetCDF-3 codec.

Rebuild of the reference's stateless open/read/close wrappers
(src/file_io.c:72-368, get/put_var_{1,2,3}d_{int,double}). Where the
reference reads a variable flat into a preallocated buffer (so a
(time=1, z_t, nlat, nlon) history variable silently fills a 3-D array),
here a leading length-1 record axis is squeezed explicitly.
"""

from __future__ import annotations

import numpy as np

from . import netcdf3


def _squeeze_time(arr: np.ndarray, ndim: int) -> np.ndarray:
    while arr.ndim > ndim and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != ndim:
        raise ValueError(f"variable has shape {arr.shape}, expected {ndim} dims")
    return arr


def get_var_double(path: str, name: str, ndim: int | None = None,
                   header=None) -> np.ndarray:
    arr = netcdf3.read_var(path, name, header).astype(np.float64)
    if ndim is not None:
        arr = _squeeze_time(arr, ndim)
    return arr


def get_var_int(path: str, name: str, ndim: int | None = None,
                header=None) -> np.ndarray:
    arr = netcdf3.read_var(path, name, header).astype(np.int64)
    if ndim is not None:
        arr = _squeeze_time(arr, ndim)
    return arr


def get_att_double(path: str, varname: str, attname: str, header=None) -> float:
    val = netcdf3.get_att(path, varname, attname, header)
    if isinstance(val, np.ndarray):
        return float(val.ravel()[0])
    return float(val)


def var_exists_in_file(path: str, name: str, header=None) -> bool:
    return netcdf3.var_exists(path, name, header)


def put_var_inplace(path: str, name: str, data: np.ndarray) -> None:
    """In-place update; re-adds a leading length-1 record axis if the
    on-disk variable carries one (annual-mean POP files keep a time dim)."""
    hdr = netcdf3.read_header(path)
    v = hdr.vars[name]
    arr = np.asarray(data)
    if v.is_record and arr.ndim == len(v.shape):
        arr = arr[None]
    netcdf3.write_var_inplace(path, name, arr)


def get_field_fv_zeroed(path: str, name: str, ndim: int, header=None) -> np.ndarray:
    """Read a field and replace its _FillValue entries with 0.0.

    Mirrors the reference's get_var + get_att(_FillValue) + set_fv pattern
    (e.g. src/matrix.c:1014-1023). Comparison is by exact equality, as in
    set_fv_3d_double (src/matrix.c:146-158). Missing _FillValue attribute is
    an error in the reference (get_att_double fails); kept strict here.
    """
    hdr = header if header is not None else netcdf3.read_header(path)
    arr = get_var_double(path, name, ndim, hdr)
    fv = get_att_double(path, name, "_FillValue", hdr)
    out = arr.copy()
    out[out == fv] = 0.0
    return out
