"""POP grid geometry: load, clean the land mask, derive U-point depths.

Rebuild of src/grid.c. All index conventions follow the reference:
arrays are (km, jmt, imt) / (jmt, imt); k is depth level (0 = surface),
j latitude row, i longitude column with zonal wraparound; KMT[j,i] is the
number of wet levels in column (j,i); a cell (k,j,i) is wet iff k < KMT[j,i].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import fields, netcdf3
from ..utils import dbg


@dataclass
class Grid:
    imt: int
    jmt: int
    km: int
    z_t: np.ndarray     # (km,) cell-center depth, cm
    dz: np.ndarray      # (km,) cell thickness, cm
    TLONG: np.ndarray   # (jmt, imt)
    TLAT: np.ndarray    # (jmt, imt)
    KMT: np.ndarray     # (jmt, imt) int
    KMU: np.ndarray     # (jmt, imt) int
    TAREA: np.ndarray   # (jmt, imt) cm^2

    @property
    def wet3d(self) -> np.ndarray:
        """(km, jmt, imt) bool: cell is active ocean."""
        return np.arange(self.km)[:, None, None] < self.KMT[None, :, :]


def derive_kmu(KMT: np.ndarray) -> np.ndarray:
    """KMU[j,i] = min of the 4 surrounding KMT with zonal wraparound; last row 0.

    Rebuild of src/grid.c:182-198 as array ops: the U-point at (j,i) sits at
    the NE corner of T-cell (j,i), so its depth is the min over
    {(j,i), (j+1,i), (j,i+1), (j+1,i+1)} (i+1 wraps).
    """
    jmt, imt = KMT.shape
    east = np.roll(KMT, -1, axis=1)
    kmu = np.zeros_like(KMT)
    kmu[:-1] = np.minimum(
        np.minimum(KMT[:-1], KMT[1:]),
        np.minimum(east[:-1], east[1:]),
    )
    return kmu


def clean_kmt(KMT: np.ndarray, regmask: np.ndarray | None = None) -> np.ndarray:
    """Clamp negative KMT to 0 and zero ignored regions (src/grid.c:142-160)."""
    out = np.where(KMT < 0, 0, KMT)
    if regmask is not None:
        out = out.copy()
        # reference only applies the region mask on interior rows (grid.c:155)
        interior = np.zeros_like(out, dtype=bool)
        interior[1:-1, :] = regmask[1:-1, :] < 0
        out[interior] = 0
    return out


def check_polar_land(KMT: np.ndarray) -> None:
    """Southern- and northern-most rows must be all land (src/grid.c:162-180)."""
    if KMT[0].any():
        raise ValueError("non-land found on southern-most row")
    if KMT[-1].any():
        raise ValueError("non-land found on northern-most row")


def load_grid(circ_fname: str, reg_fname: str | None = None) -> Grid:
    """Load grid info from a circulation file (rebuild of src/grid.c:90-213)."""
    hdr = netcdf3.read_header(circ_fname)
    imt = hdr.dim_size("nlon")
    jmt = hdr.dim_size("nlat")
    km = hdr.dim_size("z_t")
    dbg(1, f"imt = {imt}")
    dbg(1, f"jmt = {jmt}")
    dbg(1, f"km  = {km}")

    z_t = fields.get_var_double(circ_fname, "z_t", 1, hdr)
    dz = fields.get_var_double(circ_fname, "dz", 1, hdr)
    TLONG = fields.get_var_double(circ_fname, "TLONG", 2, hdr)
    TLAT = fields.get_var_double(circ_fname, "TLAT", 2, hdr)
    KMT = fields.get_var_int(circ_fname, "KMT", 2, hdr)
    TAREA = fields.get_var_double(circ_fname, "TAREA", 2, hdr)

    regmask = None
    if reg_fname is not None:
        regmask = fields.get_var_int(reg_fname, "DYN_REGMASK", 2)
    KMT = clean_kmt(KMT, regmask)
    check_polar_land(KMT)
    KMU = derive_kmu(KMT)

    return Grid(imt=imt, jmt=jmt, km=km, z_t=z_t, dz=dz, TLONG=TLONG,
                TLAT=TLAT, KMT=KMT.astype(np.int64), KMU=KMU.astype(np.int64),
                TAREA=TAREA)


def grid_vars_for_output(grid: Grid):
    """Dims + vars written to the matrix file, matching put_grid_info
    (src/grid.c:217-316): dims nlon/nlat/z_t, vars z_t, TLONG, TLAT, KMT
    with the reference's attributes, in that order."""
    dims = [("nlon", grid.imt), ("nlat", grid.jmt), ("z_t", grid.km)]
    variables = [
        ("z_t", ("z_t",),
         {"long_name": "depth from surface to midpoint of layer",
          "units": "centimeters", "positive": "down"},
         grid.z_t),
        ("TLONG", ("nlat", "nlon"),
         {"long_name": "array of t-grid longitudes", "units": "degrees_east"},
         grid.TLONG),
        ("TLAT", ("nlat", "nlon"),
         {"long_name": "array of t-grid latitudes", "units": "degrees_north"},
         grid.TLAT),
        ("KMT", ("nlat", "nlon"),
         {"long_name": "k Index of Deepest Grid Cell on T Grid",
          "coordinates": "TLONG TLAT"},
         grid.KMT.astype(np.int32)),
    ]
    return dims, variables
