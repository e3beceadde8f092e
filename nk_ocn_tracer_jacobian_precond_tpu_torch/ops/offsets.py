"""Stencil offsets and shift helpers.

The Jacobian is held as a *structured stencil tensor*: one dense
(km, jmt, imt) coefficient field per offset (dk, dj, di), meaning
"row cell (k,j,i) depends on column cell (k+dk, j+dj, i+di)". i wraps
zonally; k and j clamp (out-of-range targets are invalid and masked).

Offset order below reproduces the reference's within-row slot order
(src/matrix.c:800-961: self, 1-shallower, 1-deeper, east, west, north,
south; then upwind3 distance-2 cells; then the 8 isopycnal vertical
diagonals), which fixes the floating-point duplicate-summation order in
the canonical CSR (src/matrix.c:3620-3650).
"""

from __future__ import annotations

import numpy as np

# (dk, dj, di)
SELF = (0, 0, 0)
FACE_OFFSETS = [
    SELF,
    (-1, 0, 0),   # 1 level shallower
    (1, 0, 0),    # 1 level deeper
    (0, 0, 1),    # 1 unit east
    (0, 0, -1),   # 1 unit west
    (0, 1, 0),    # 1 unit north
    (0, -1, 0),   # 1 unit south
]
ADV2_OFFSETS = [
    (-2, 0, 0), (2, 0, 0), (0, 0, 2), (0, 0, -2), (0, 2, 0), (0, -2, 0),
]
ISOP_OFFSETS = [
    (-1, 0, 1), (1, 0, 1),    # shallower/deeper & east
    (-1, 0, -1), (1, 0, -1),  # shallower/deeper & west
    (-1, 1, 0), (1, 1, 0),    # shallower/deeper & north
    (-1, -1, 0), (1, -1, 0),  # shallower/deeper & south
]

ALL_OFFSETS = FACE_OFFSETS + ADV2_OFFSETS + ISOP_OFFSETS


def _shift_axis(field: np.ndarray, d: int, axis: int, fill) -> np.ndarray:
    """out[..., x, ...] = field[..., x+d, ...] along axis, filling out-of-range."""
    out = np.full_like(field, fill)
    src = [slice(None)] * field.ndim
    dst = [slice(None)] * field.ndim
    if d > 0:
        src[axis] = slice(d, None)
        dst[axis] = slice(None, -d)
    else:
        src[axis] = slice(None, d)
        dst[axis] = slice(-d, None)
    out[tuple(dst)] = field[tuple(src)]
    return out


def shift(field: np.ndarray, dk: int = 0, dj: int = 0, di: int = 0,
          fill: float = 0.0) -> np.ndarray:
    """out[k,j,i] = field[k+dk, j+dj, i+di]; i wraps, k/j fill out-of-range.

    Works for 3-D (km, jmt, imt) and 2-D (jmt, imt) fields (dk ignored
    for 2-D).
    """
    out = field
    if field.ndim == 3 and dk != 0:
        out = _shift_axis(out, dk, 0, fill)
    if dj != 0:
        out = _shift_axis(out, dj, out.ndim - 2, fill)
    if di != 0:
        out = np.roll(out, -di, axis=-1)
    if out is field:
        out = field.copy()
    return out


def shift2(field: np.ndarray, dj: int = 0, di: int = 0, fill: float = 0.0) -> np.ndarray:
    return shift(field, 0, dj, di, fill)


def target_wet(KMT: np.ndarray, km: int, dk: int, dj: int, di: int) -> np.ndarray:
    """(km, jmt, imt) bool: the cell at offset (dk,dj,di) from here is a wet
    in-bounds cell (the generic form of the reference's per-slot existence
    conditions, e.g. src/matrix.c:806-839)."""
    jmt, imt = KMT.shape
    kk = np.arange(km)[:, None, None]
    kmt_t = shift2(KMT.astype(np.int64), dj, di, fill=0)
    ok = (kk + dk >= 0) & (kk + dk < km) & (kk + dk < kmt_t[None, :, :])
    # j bounds (i wraps so no i bound)
    jj = np.arange(jmt)[None, :, None]
    ok &= (jj + dj >= 0) & (jj + dj < jmt)
    return ok


def wet3d(KMT: np.ndarray, km: int) -> np.ndarray:
    return np.arange(km)[:, None, None] < KMT[None, :, :]
