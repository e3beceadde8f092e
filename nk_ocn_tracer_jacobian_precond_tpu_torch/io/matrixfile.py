"""Matrix-file persistence: the system's on-disk interface.

The matrix NetCDF file is the public API between stage 1 (assembly) and
stage 2 (solve) (reference: README:9-16). Layout matches the reference's
write order exactly — put_grid_info (src/grid.c:217-316) then put_ind_maps
(src/matrix.c:263-369) then put_sparse_matrix (src/matrix.c:3844-3939) —
producing dims nlon/nlat/z_t/tracer_state_len/nnz/flat_len_p1 and vars
z_t, TLONG, TLAT, KMT, int3_to_tracer_state_ind, tracer_state_ind_to_{i,j,k},
coupled_tracer_cnt, nzval_row_wise, colind, rowptr in NC_64BIT_OFFSET format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..grid import Grid, IndexMaps, grid_vars_for_output, ind_map_vars_for_output
from . import netcdf3
from .fields import get_var_double, get_var_int


@dataclass
class SparseMatrix:
    """Canonical CSR as stored on disk (src/matrix.c:9-16)."""
    nzval: np.ndarray     # (nnz,) float64
    colind: np.ndarray    # (nnz,) int
    rowptr: np.ndarray    # (flat_len+1,) int
    coupled_tracer_cnt: int

    @property
    def flat_len(self) -> int:
        return len(self.rowptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.nzval)

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.nzval, self.colind, self.rowptr),
                          shape=(self.flat_len, self.flat_len))


def write_matrix_file(path: str, grid: Grid, maps: IndexMaps,
                      matrix: SparseMatrix) -> None:
    dims, variables = grid_vars_for_output(grid)
    d2, v2 = ind_map_vars_for_output(maps)
    dims += d2
    variables += v2
    dims += [("nnz", matrix.nnz), ("flat_len_p1", matrix.flat_len + 1)]
    variables += [
        ("coupled_tracer_cnt", (), {}, np.int32(matrix.coupled_tracer_cnt)),
        ("nzval_row_wise", ("nnz",), {}, matrix.nzval.astype(np.float64)),
        ("colind", ("nnz",), {}, matrix.colind.astype(np.int32)),
        ("rowptr", ("flat_len_p1",), {}, matrix.rowptr.astype(np.int32)),
    ]
    netcdf3.write(path, dims, variables, version=2)


def read_matrix_file(path: str) -> SparseMatrix:
    """Rebuild of get_sparse_matrix (src/matrix.c:3943-4031)."""
    hdr = netcdf3.read_header(path)
    nnz = hdr.dim_size("nnz")
    flat_len = hdr.dim_size("flat_len_p1") - 1
    ctc = int(get_var_int(path, "coupled_tracer_cnt", header=hdr).ravel()[0])
    nzval = get_var_double(path, "nzval_row_wise", 1, hdr)
    colind = get_var_int(path, "colind", 1, hdr)
    rowptr = get_var_int(path, "rowptr", 1, hdr)
    assert len(nzval) == nnz and len(rowptr) == flat_len + 1
    return SparseMatrix(nzval=nzval, colind=colind, rowptr=rowptr,
                        coupled_tracer_cnt=ctc)
