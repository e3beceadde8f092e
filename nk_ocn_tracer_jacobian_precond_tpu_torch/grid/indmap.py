"""Index maps between (k, j, i) triplets and the flat tracer-state vector.

Rebuild of src/matrix.c:162-464. The row-numbering convention is a hard
compatibility constraint: wet cells are enumerated j-outer, i-middle,
k-innermost (src/matrix.c:239-251), so each water column's rows are
contiguous in the flat index space — which the rebuild's solver also
exploits (whole columns become dense blocks).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import fields, netcdf3
from ..utils import dbg


@dataclass
class IndexMaps:
    tracer_state_len: int
    int3_to_ind: np.ndarray   # (km, jmt, imt) int32, -1 on land
    ind_to_i: np.ndarray      # (tracer_state_len,)
    ind_to_j: np.ndarray
    ind_to_k: np.ndarray

    def flatten_field(self, field3d: np.ndarray) -> np.ndarray:
        """Gather a (km, jmt, imt) field into the flat state ordering."""
        return field3d[self.ind_to_k, self.ind_to_j, self.ind_to_i]

    def unflatten_into(self, field3d: np.ndarray, flat: np.ndarray) -> np.ndarray:
        """Scatter a flat state vector back into a copy of field3d, leaving
        land values untouched (src/solve_ABglobal.c:236-247 reads the field
        first so non-processed values are preserved)."""
        out = field3d.copy()
        out[self.ind_to_k, self.ind_to_j, self.ind_to_i] = flat
        return out


def gen_ind_maps(KMT: np.ndarray, km: int) -> IndexMaps:
    """Vectorized rebuild of gen_ind_maps (src/matrix.c:210-259)."""
    jmt, imt = KMT.shape
    if KMT[0].any() or KMT[-1].any():
        raise ValueError("non-land on polar rows (comp_tracer_state_len check)")
    wet = np.arange(km)[:, None, None] < KMT[None, :, :]     # (km, jmt, imt)
    # enumeration order: j outer, i middle, k inner
    wet_jik = wet.transpose(1, 2, 0)                          # (jmt, imt, km)
    flat = wet_jik.reshape(-1)
    ind = np.cumsum(flat) - 1
    int3_to_ind = np.where(flat, ind, -1).reshape(jmt, imt, km).transpose(2, 0, 1)
    tracer_state_len = int(flat.sum())
    dbg(1, f"tracer_state_len = {tracer_state_len}")

    # wet cells in (j, i, k) enumeration order = ascending flat indices of
    # the transposed mask; decode to triplets directly
    flat_idx = np.flatnonzero(wet_jik)
    ind_to_k = flat_idx % km
    ind_to_i = (flat_idx // km) % imt
    ind_to_j = flat_idx // (km * imt)
    return IndexMaps(
        tracer_state_len=tracer_state_len,
        int3_to_ind=int3_to_ind.astype(np.int64),
        ind_to_i=ind_to_i.astype(np.int64),
        ind_to_j=ind_to_j.astype(np.int64),
        ind_to_k=ind_to_k.astype(np.int64),
    )


def ind_map_vars_for_output(maps: IndexMaps):
    """Dims + vars matching put_ind_maps (src/matrix.c:263-369):
    dim tracer_state_len; vars int3_to_tracer_state_ind (with _FillValue /
    missing_value -1 and coordinates attr) and tracer_state_ind_to_{i,j,k}."""
    dims = [("tracer_state_len", maps.tracer_state_len)]
    variables = [
        ("int3_to_tracer_state_ind", ("z_t", "nlat", "nlon"),
         {"coordinates": "TLONG TLAT",
          "_FillValue": np.int32(-1), "missing_value": np.int32(-1)},
         maps.int3_to_ind.astype(np.int32)),
        ("tracer_state_ind_to_i", ("tracer_state_len",), {},
         maps.ind_to_i.astype(np.int32)),
        ("tracer_state_ind_to_j", ("tracer_state_len",), {},
         maps.ind_to_j.astype(np.int32)),
        ("tracer_state_ind_to_k", ("tracer_state_len",), {},
         maps.ind_to_k.astype(np.int32)),
    ]
    return dims, variables


def load_ind_maps(path: str) -> IndexMaps:
    """Read index maps back from a matrix file (src/matrix.c:373-455)."""
    hdr = netcdf3.read_header(path)
    tracer_state_len = hdr.dim_size("tracer_state_len")
    return IndexMaps(
        tracer_state_len=tracer_state_len,
        int3_to_ind=fields.get_var_int(path, "int3_to_tracer_state_ind", 3, hdr),
        ind_to_i=fields.get_var_int(path, "tracer_state_ind_to_i", 1, hdr),
        ind_to_j=fields.get_var_int(path, "tracer_state_ind_to_j", 1, hdr),
        ind_to_k=fields.get_var_int(path, "tracer_state_ind_to_k", 1, hdr),
    )
