"""Vertical mixing assembly.

Vectorized rebuild of src/matrix.c:2775-3054: per-level dense
within-column Jacobian (matrix_file), diffusive coupling from VDC fields
(file), and constant diffusivity.
"""

from __future__ import annotations

import numpy as np

from .offsets import target_wet


def _vdc_coeffs(grid, dt, VDC):
    """ct/cb from a total diffusivity field (src/matrix.c:2906-2916):
    ct = VDC[k-1]/(0.5*(dz[k-1]+dz[k]))/dz[k]*dt at the top face,
    cb = VDC[k]/(0.5*(dz[k]+dz[k+1]))/dz[k]*dt at the bottom face."""
    km = grid.km
    dz = grid.dz
    dzk = dz[:, None, None]
    dz_km1 = np.concatenate([[0.0], dz[:-1]])[:, None, None]
    dz_kp1 = np.concatenate([dz[1:], [0.0]])[:, None, None]
    top_ex = target_wet(grid.KMT, km, -1, 0, 0)
    bot_ex = target_wet(grid.KMT, km, 1, 0, 0)
    VDC_km1 = np.concatenate([np.zeros_like(VDC[:1]), VDC[:-1]], axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ct = np.where(top_ex, VDC_km1 / (0.5 * (dz_km1 + dzk)) / dzk * dt, 0.0)
        cb = np.where(bot_ex, VDC / (0.5 * (dzk + dz_kp1)) / dzk * dt, 0.0)
    return ct, cb


def _apply_tridiag(coef, ct, cb):
    coef[(0, 0, 0)] += -(ct + cb)
    coef[(-1, 0, 0)] += ct
    coef[(1, 0, 0)] += cb


def add_vmix_file(coef, grid, dt, src) -> None:
    """Rebuild of add_vmix_file (src/matrix.c:2841-2945): total VDC =
    VDC_S + VDC_GM (GM added on interior rows only, matrix.c:2887-2890)."""
    VDC = src.get3_fv0("VDC_S")
    GM = src.get3_fv0("VDC_GM")
    VDC[:, 1:-1, :] = (VDC + GM)[:, 1:-1, :]
    ct, cb = _vdc_coeffs(grid, dt, VDC)
    _apply_tridiag(coef, ct, cb)


def add_vmix_const(coef, grid, dt, vdc: float = 0.1) -> None:
    """Rebuild of add_vmix_const (src/matrix.c:2949-3012); vdc in cm^2/s."""
    km, jmt, imt = grid.km, grid.jmt, grid.imt
    VDC = np.full((km, jmt, imt), vdc)
    ct, cb = _vdc_coeffs(grid, dt, VDC)
    _apply_tridiag(coef, ct, cb)


def add_vmix_matrix_file(grid, dt, src) -> np.ndarray:
    """Rebuild of add_vmix_matrix_file (src/matrix.c:2775-2837).

    Returns a (km, km, jmt, imt) column-dense block: entry [k2, k, j, i] is
    the coefficient of row cell (k,j,i) w.r.t. column cell (k2,j,i), filled
    for every k2 < KMT[j,i] from the per-level fields vmix_matrix_%03d_CUR.
    """
    km, jmt, imt = grid.km, grid.jmt, grid.imt
    dense = np.zeros((km, km, jmt, imt))
    col_wet = (np.arange(km)[:, None, None] < grid.KMT[None])  # k2 < KMT
    for k2 in range(km):
        field = src.get3(f"vmix_matrix_{k2 + 1:03d}_CUR")
        dense[k2] = np.where(col_wet[k2][None], field * dt, 0.0)
    return dense


def add_vmix(coef, grid, opts, src):
    """Dispatcher, rebuild of add_vmix (src/matrix.c:3017-3054). Returns the
    column-dense block for matrix_file mode, else None."""
    if opts.vmix_type == "none":
        return None
    if opts.vmix_type == "const":
        add_vmix_const(coef, grid, opts.delta_t)
        return None
    if opts.vmix_type == "file":
        add_vmix_file(coef, grid, opts.delta_t, src)
        return None
    if opts.vmix_type == "matrix_file":
        return add_vmix_matrix_file(grid, opts.delta_t, src)
    raise ValueError(opts.vmix_type)
