"""From-scratch NetCDF-3 (classic CDF-1 / 64-bit-offset CDF-2) codec.

The reference persists everything (grid, index maps, CSR matrix, tracer
fields) through libnetcdf in classic NC_64BIT_OFFSET format (reference:
src/grid.c:235 ``nc_create(fname, NC_64BIT_OFFSET, ...)``; src/file_io.c
wraps typed whole-variable get/put). This module reimplements the on-disk
format directly so the rebuild's files are bit-compatible with the
reference's and existing Newton-Krylov workflows can read/write them with
stock netCDF tools.

Supported:
  * reading CDF-1 and CDF-2 headers and whole variables (record and
    non-record), including attributes;
  * writing complete files (dims/gatts/vars in caller-specified order,
    which fixes the byte layout);
  * in-place whole-variable update of an existing file without rewriting
    it (the reference's solvers update tracer variables in-place in the
    function-evaluation file, src/solve_ABglobal.c:212-267);
  * appending dims/vars to an existing file by structural rewrite
    (equivalent of nc_redef + nc_def_dim/nc_def_var + write, used by
    put_ind_maps / put_sparse_matrix, src/matrix.c:263-369, 3844-3939).

Byte order on disk is big-endian, as the format requires.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# nc_type codes (NetCDF classic specification).
NC_BYTE = 1
NC_CHAR = 2
NC_SHORT = 3
NC_INT = 4
NC_FLOAT = 5
NC_DOUBLE = 6

_TYPE_TO_DTYPE = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}

_KIND_TO_TYPE = {
    ("i", 1): NC_BYTE,
    ("S", 1): NC_CHAR,
    ("i", 2): NC_SHORT,
    ("i", 4): NC_INT,
    ("f", 4): NC_FLOAT,
    ("f", 8): NC_DOUBLE,
}

_ZERO = b"\x00\x00\x00\x00"
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C


def _nc_type_of(arr: np.ndarray) -> int:
    key = (arr.dtype.kind, arr.dtype.itemsize)
    if key not in _KIND_TO_TYPE:
        raise TypeError(f"dtype {arr.dtype} has no NetCDF classic equivalent")
    return _KIND_TO_TYPE[key]


def _pad4(n: int) -> int:
    return (n + 3) & ~3


@dataclass
class NCVar:
    name: str
    dims: tuple[str, ...]
    atts: dict[str, object]
    nc_type: int
    shape: tuple[int, ...]       # per-record shape for record vars (record dim first, excluded)
    begin: int
    is_record: bool
    vsize: int

    @property
    def dtype(self) -> np.dtype:
        return _TYPE_TO_DTYPE[self.nc_type]


@dataclass
class NCHeader:
    version: int                  # 1 (CDF-1) or 2 (CDF-2)
    numrecs: int
    dims: list[tuple[str, int]]   # ordered; size 0 marks the record dimension
    gatts: dict[str, object]
    vars: dict[str, NCVar] = field(default_factory=dict)
    var_order: list[str] = field(default_factory=list)

    def dim_size(self, name: str) -> int:
        for n, s in self.dims:
            if n == name:
                return self.numrecs if s == 0 else s
        raise KeyError(name)


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated NetCDF header")
        self.pos += n
        return b

    def i4(self) -> int:
        return int.from_bytes(self.bytes(4), "big", signed=True)

    def u4(self) -> int:
        return int.from_bytes(self.bytes(4), "big", signed=False)

    def i8(self) -> int:
        return int.from_bytes(self.bytes(8), "big", signed=True)

    def name(self) -> str:
        n = self.i4()
        s = self.bytes(n).decode("utf-8")
        self.bytes(_pad4(n) - n)
        return s

    def att_value(self):
        nc_type = self.i4()
        n = self.i4()
        dt = _TYPE_TO_DTYPE[nc_type]
        nbytes = n * dt.itemsize
        raw = self.bytes(nbytes)
        self.bytes(_pad4(nbytes) - nbytes)
        if nc_type == NC_CHAR:
            return raw.decode("utf-8", errors="replace")
        vals = np.frombuffer(raw, dtype=dt)
        if n == 1:
            return vals[0].item() if nc_type in (NC_BYTE, NC_SHORT, NC_INT) else float(vals[0])
        return vals.astype(dt.newbyteorder("="))

    def att_list(self) -> dict[str, object]:
        tag = self.i4()
        n = self.i4()
        if tag == 0 and n == 0:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(f"bad attribute list tag {tag:#x}")
        atts = {}
        for _ in range(n):
            nm = self.name()
            atts[nm] = self.att_value()
        return atts


def read_header(path: str) -> NCHeader:
    with open(path, "rb") as f:
        # Header is variable length; read generously and extend on demand.
        data = f.read(1 << 20)
        while True:
            try:
                return _parse_header(data)
            except EOFError:
                more = f.read(1 << 22)
                if not more:
                    raise
                data += more


def _parse_header(data: bytes) -> NCHeader:
    r = _Reader(data)
    magic = r.bytes(3)
    if magic != b"CDF":
        raise ValueError("not a NetCDF classic file")
    version = r.bytes(1)[0]
    if version not in (1, 2):
        raise ValueError(f"unsupported NetCDF version byte {version}")
    numrecs = r.u4()
    if numrecs == 0xFFFFFFFF:
        numrecs = -1  # STREAMING; resolved later from file size if needed

    tag = r.i4()
    ndims = r.i4()
    dims: list[tuple[str, int]] = []
    if tag == _NC_DIMENSION:
        for _ in range(ndims):
            nm = r.name()
            dims.append((nm, r.i4()))
    elif not (tag == 0 and ndims == 0):
        raise ValueError(f"bad dim list tag {tag:#x}")

    gatts = r.att_list()

    tag = r.i4()
    nvars = r.i4()
    hdr = NCHeader(version=version, numrecs=numrecs, dims=dims, gatts=gatts)
    if tag == _NC_VARIABLE:
        for _ in range(nvars):
            nm = r.name()
            nd = r.i4()
            dimids = [r.i4() for _ in range(nd)]
            atts = r.att_list()
            nc_type = r.i4()
            vsize = r.u4()
            begin = r.i8() if version == 2 else r.u4()
            is_record = bool(dimids) and dims[dimids[0]][1] == 0
            shp = tuple(dims[d][1] for d in (dimids[1:] if is_record else dimids))
            hdr.vars[nm] = NCVar(
                name=nm,
                dims=tuple(dims[d][0] for d in dimids),
                atts=atts,
                nc_type=nc_type,
                shape=shp,
                begin=begin,
                is_record=is_record,
                vsize=vsize,
            )
            hdr.var_order.append(nm)
    elif not (tag == 0 and nvars == 0):
        raise ValueError(f"bad var list tag {tag:#x}")
    return hdr


def _recsize(hdr: NCHeader) -> int:
    rec_vars = [v for v in hdr.vars.values() if v.is_record]
    if len(rec_vars) == 1:
        # Special case from the spec: a single record variable is NOT padded.
        v = rec_vars[0]
        return int(np.prod(v.shape, dtype=np.int64)) * v.dtype.itemsize
    return sum(
        _pad4(int(np.prod(v.shape, dtype=np.int64)) * v.dtype.itemsize) for v in rec_vars
    )


def read_var(path: str, name: str, header: NCHeader | None = None) -> np.ndarray:
    """Read a whole variable (native byte order). Record dim is the first axis."""
    hdr = header if header is not None else read_header(path)
    v = hdr.vars[name]
    per_rec = int(np.prod(v.shape, dtype=np.int64))
    with open(path, "rb") as f:
        if not v.is_record:
            f.seek(v.begin)
            out = np.fromfile(f, dtype=v.dtype, count=per_rec).reshape(v.shape)
        else:
            nrec = hdr.numrecs
            if nrec < 0:
                nrec = (os.path.getsize(path) - v.begin) // max(_recsize(hdr), 1)
            rs = _recsize(hdr)
            out = np.empty((nrec,) + v.shape, dtype=v.dtype)
            for rec in range(nrec):
                f.seek(v.begin + rec * rs)
                out[rec] = np.fromfile(f, dtype=v.dtype, count=per_rec).reshape(v.shape)
    return np.ascontiguousarray(out.astype(v.dtype.newbyteorder("="), copy=False))


def var_exists(path: str, name: str, header: NCHeader | None = None) -> bool:
    hdr = header if header is not None else read_header(path)
    return name in hdr.vars


def get_att(path: str, varname: str, attname: str, header: NCHeader | None = None):
    hdr = header if header is not None else read_header(path)
    return hdr.vars[varname].atts[attname]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def i4(self, v: int):
        self.parts.append(int(v).to_bytes(4, "big", signed=True))

    def u4(self, v: int):
        self.parts.append(int(v).to_bytes(4, "big", signed=False))

    def i8(self, v: int):
        self.parts.append(int(v).to_bytes(8, "big", signed=True))

    def name(self, s: str):
        b = s.encode("utf-8")
        self.i4(len(b))
        self.raw(b + b"\x00" * (_pad4(len(b)) - len(b)))

    def att_value(self, val):
        if isinstance(val, str):
            b = val.encode("utf-8")
            self.i4(NC_CHAR)
            self.i4(len(b))
            self.raw(b + b"\x00" * (_pad4(len(b)) - len(b)))
            return
        arr = np.atleast_1d(np.asarray(val))
        if arr.dtype.kind == "f":
            arr = arr.astype(">f8") if arr.dtype.itemsize == 8 else arr.astype(">f4")
        elif arr.dtype.kind == "i":
            arr = arr.astype({1: ">i1", 2: ">i2"}.get(arr.dtype.itemsize, ">i4"))
        nc_type = _nc_type_of(arr)
        raw = arr.tobytes()
        self.i4(nc_type)
        self.i4(arr.size)
        self.raw(raw + b"\x00" * (_pad4(len(raw)) - len(raw)))

    def att_list(self, atts: dict[str, object]):
        if not atts:
            self.raw(_ZERO + _ZERO)
            return
        self.i4(_NC_ATTRIBUTE)
        self.i4(len(atts))
        for k, v in atts.items():
            self.name(k)
            self.att_value(v)

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


def _coerce(data: np.ndarray) -> np.ndarray:
    arr = np.asarray(data)
    if arr.dtype.kind == "f":
        arr = arr.astype(">f8" if arr.dtype.itemsize == 8 else ">f4")
    elif arr.dtype.kind in "iu":
        sz = arr.dtype.itemsize
        arr = arr.astype({1: ">i1", 2: ">i2"}.get(sz, ">i4"))
    elif arr.dtype.kind == "S":
        arr = arr.astype("S1")
    else:
        raise TypeError(f"cannot store dtype {arr.dtype}")
    return arr


def write(
    path: str,
    dims: list[tuple[str, int]],
    variables: list[tuple[str, tuple[str, ...], dict, np.ndarray]],
    gatts: dict | None = None,
    version: int = 2,
) -> None:
    """Write a complete classic NetCDF file.

    dims: ordered (name, size); size 0 marks the (single) record dimension.
    variables: ordered (name, dimnames, atts, data); data shape must match
      the dims (record vars include the record axis first).
    version=2 gives NC_64BIT_OFFSET, matching the reference's nc_create flag
    (src/grid.c:235).
    """
    dim_index = {n: idx for idx, (n, _) in enumerate(dims)}
    dim_sizes = dict(dims)
    rec_dim = next((n for n, s in dims if s == 0), None)

    arrs, metas = [], []
    numrecs = None
    for name, vdims, atts, data in variables:
        arr = _coerce(data)
        is_record = bool(vdims) and vdims[0] == rec_dim
        exp = tuple(dim_sizes[d] for d in vdims)
        if is_record:
            if numrecs is not None and arr.shape[0] != numrecs:
                # NetCDF-3 requires every record variable to share the
                # record count; catching it here avoids an IndexError
                # mid-write that would leave a truncated file behind
                raise ValueError(
                    f"var {name}: {arr.shape[0]} records, but an earlier "
                    f"record variable has {numrecs} — all record variables "
                    f"must share the record count")
            numrecs = arr.shape[0]
            exp = (arr.shape[0],) + exp[1:]
        if tuple(arr.shape) != exp:
            raise ValueError(f"var {name}: shape {arr.shape} != dims {vdims} -> {exp}")
        arrs.append(arr)
        metas.append((name, vdims, atts or {}, _nc_type_of(arr), is_record))
    numrecs = numrecs or 0

    def emit(begins: list[int]) -> bytes:
        w = _Writer()
        w.raw(b"CDF" + bytes([version]))
        w.u4(numrecs)
        if dims:
            w.i4(_NC_DIMENSION)
            w.i4(len(dims))
            for n, s in dims:
                w.name(n)
                w.i4(s)
        else:
            w.raw(_ZERO + _ZERO)
        w.att_list(gatts or {})
        if metas:
            w.i4(_NC_VARIABLE)
            w.i4(len(metas))
            for (name, vdims, atts, nc_type, is_record), arr, begin in zip(metas, arrs, begins):
                w.name(name)
                w.i4(len(vdims))
                for d in vdims:
                    w.i4(dim_index[d])
                w.att_list(atts)
                w.i4(nc_type)
                per_rec_shape = arr.shape[1:] if is_record else arr.shape
                nbytes = int(np.prod(per_rec_shape, dtype=np.int64)) * arr.dtype.itemsize
                vsize = _pad4(nbytes)
                w.u4(vsize if vsize < 0xFFFFFFFF else 0xFFFFFFFF)
                if version == 2:
                    w.i8(begin)
                else:
                    w.u4(begin)
        else:
            w.raw(_ZERO + _ZERO)
        return w.tobytes()

    # Two passes: measure the header with dummy offsets, then lay out data.
    header_len = len(emit([0] * len(metas)))
    begins = []
    offset = header_len
    # fixed-size vars first, in order
    for (name, vdims, atts, nc_type, is_record), arr in zip(metas, arrs):
        if is_record:
            begins.append(0)
            continue
        begins.append(offset)
        offset += _pad4(arr.nbytes)
    # then record vars, interleaved per record
    rec_start = offset
    rec_metas = [(m, a) for m, a in zip(metas, arrs) if m[4]]
    single_rec = len(rec_metas) == 1
    rec_off = rec_start
    for idx, (m, arr) in enumerate(zip(metas, arrs)):
        if not m[4]:
            continue
        begins[idx] = rec_off
        per_rec = int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.dtype.itemsize
        rec_off += per_rec if single_rec else _pad4(per_rec)
    recsize = rec_off - rec_start

    header = emit(begins)
    assert len(header) == header_len

    with open(path, "wb") as f:
        f.write(header)
        for (name, vdims, atts, nc_type, is_record), arr, begin in zip(metas, arrs, begins):
            if is_record:
                continue
            f.seek(begin)
            f.write(arr.tobytes())
            pad = _pad4(arr.nbytes) - arr.nbytes
            if pad:
                f.write(b"\x00" * pad)
        for rec in range(numrecs):
            for (name, vdims, atts, nc_type, is_record), arr, begin in zip(metas, arrs, begins):
                if not is_record:
                    continue
                f.seek(begin + rec * recsize)
                f.write(arr[rec].tobytes())


def write_var_inplace(path: str, name: str, data: np.ndarray) -> None:
    """Overwrite the contents of an existing variable without rewriting the file.

    This is the rebuild of the solvers' in-place tracer update
    (src/solve_ABglobal.c:250-254: read field, overwrite wet cells, put back).
    """
    hdr = read_header(path)
    v = hdr.vars[name]
    arr = np.asarray(data).astype(v.dtype)
    per_rec = int(np.prod(v.shape, dtype=np.int64))
    with open(path, "r+b") as f:
        if not v.is_record:
            if arr.size != per_rec:
                raise ValueError(f"var {name}: size {arr.size} != {per_rec}")
            f.seek(v.begin)
            f.write(arr.tobytes())
        else:
            rs = _recsize(hdr)
            nrec = arr.shape[0]
            if arr.size != per_rec * nrec:
                raise ValueError(f"var {name}: record size mismatch")
            for rec in range(nrec):
                f.seek(v.begin + rec * rs)
                f.write(arr[rec].tobytes())


def append_vars(
    path: str,
    new_dims: list[tuple[str, int]],
    new_vars: list[tuple[str, tuple[str, ...], dict, np.ndarray]],
) -> None:
    """Add dims/vars to an existing file (structural rewrite).

    Equivalent of the reference's nc_redef + nc_def_dim/nc_def_var + put_var
    sequence (src/matrix.c:283-331, 3860-3892). The resulting byte layout is
    identical to defining everything in one pass in the same order, which is
    what libnetcdf produces for the reference's usage pattern.
    """
    hdr = read_header(path)
    dims = list(hdr.dims)
    existing_dims = {n for n, _ in dims}
    for n, s in new_dims:
        if n in existing_dims:
            continue
        dims.append((n, s))
    variables = []
    for nm in hdr.var_order:
        v = hdr.vars[nm]
        variables.append((nm, v.dims, v.atts, read_var(path, nm, hdr)))
    variables.extend(new_vars)
    tmp = path + ".tmp"
    write(tmp, dims, variables, gatts=hdr.gatts, version=hdr.version)
    os.replace(tmp, path)
