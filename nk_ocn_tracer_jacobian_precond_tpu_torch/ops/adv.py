"""Advection operator assembly: donor-cell, centered, and upwind3 schemes.

Vectorized rebuild of src/matrix.c:985-2206. Every reference per-cell loop
becomes masked whole-field expressions over (km, jmt, imt) arrays; the
floating-point evaluation order of each contribution mirrors the reference's
statement order so canonical CSR values match to the bit wherever IEEE
allows.

Sign/stencil conventions (reference comments at matrix.c:1210-2016):
  UTE[k,j,i]  = zonal volume flux through the EAST face of T-cell (k,j,i)
  VTN[k,j,i]  = meridional volume flux through the NORTH face
  WVEL[k,j,i] = vertical velocity at the TOP face (positive up)
Horizontal terms are scaled by 1/TAREA * delta_t, vertical by 1/dz[k] *
delta_t (tendencies, then linearization over delta_t seconds).
"""

from __future__ import annotations

import numpy as np

from .offsets import shift, shift2, target_wet


def _kk(km):
    return np.arange(km)[:, None, None]


def load_UTE(grid, src, hmix_hor: bool) -> np.ndarray:
    """Rebuild of load_UTE (src/matrix.c:985-1060): average U-point
    UVEL*DYU to T-cell east faces; add UISOP*HTE bolus transport when
    hmix_type=hor_file. Interior latitude rows only."""
    km = grid.km
    W = src.get3_fv0("UVEL")
    DY = src.get2_fv0("DYU")
    kk = _kk(km)
    mask_u = kk < grid.KMU[None]
    a = 0.5 * W * DY[None]
    t1 = np.where(mask_u, a, 0.0)
    t2 = shift(np.where(mask_u, a, 0.0), dj=-1)
    ute = np.zeros_like(W)
    ute[:, 1:-1, :] = (t1 + t2)[:, 1:-1, :]
    if hmix_hor:
        WI = src.get3_fv0("UISOP")
        HTE = src.get2_fv0("HTE")
        wet = kk < grid.KMT[None]
        east_wet = kk < shift2(grid.KMT, di=1)[None]
        extra = np.where(wet & east_wet, WI * HTE[None], 0.0)
        ute[:, 1:-1, :] = ute[:, 1:-1, :] + extra[:, 1:-1, :]
    return ute


def load_VTN(grid, src, hmix_hor: bool) -> np.ndarray:
    """Rebuild of load_VTN (src/matrix.c:1064-1141)."""
    km = grid.km
    W = src.get3_fv0("VVEL")
    DX = src.get2_fv0("DXU")
    kk = _kk(km)
    mask_u = kk < grid.KMU[None]
    a = 0.5 * W * DX[None]
    t1 = np.where(mask_u, a, 0.0)
    t2 = shift(np.where(mask_u, a, 0.0), di=-1)
    vtn = np.zeros_like(W)
    vtn[:, 1:-1, :] = (t1 + t2)[:, 1:-1, :]
    if hmix_hor:
        WI = src.get3_fv0("VISOP")
        HTN = src.get2_fv0("HTN")
        wet = kk < grid.KMT[None]
        north_wet = kk < shift2(grid.KMT, dj=1)[None]
        extra = np.where(wet & north_wet, WI * HTN[None], 0.0)
        vtn[:, 1:-1, :] = vtn[:, 1:-1, :] + extra[:, 1:-1, :]
    return vtn


def load_WVEL(grid, src, hmix_hor: bool) -> np.ndarray:
    """Rebuild of load_WVEL (src/matrix.c:1145-1206); surface level zeroed."""
    km = grid.km
    W = src.get3_fv0("WVEL")
    kk = _kk(km)
    wet = kk < grid.KMT[None]
    wvel = np.zeros_like(W)
    wvel[:, 1:-1, :] = np.where(wet, W, 0.0)[:, 1:-1, :]
    if hmix_hor:
        WI = src.get3_fv0("WISOP")
        wvel[:, 1:-1, :] = wvel[:, 1:-1, :] + np.where(wet, WI, 0.0)[:, 1:-1, :]
    wvel[0] = 0.0
    return wvel


def add_UTE_coeffs(coef, grid, dt: float, adv_type: str, UTE: np.ndarray) -> None:
    """Rebuild of add_UTE_coeffs (src/matrix.c:1210-1287)."""
    km = grid.km
    TA = grid.TAREA[None]
    UTE_w = shift(UTE, di=-1)
    east_open = target_wet(grid.KMT, km, 0, 0, 1)
    west_open = target_wet(grid.KMT, km, 0, 0, -1)
    if adv_type == "donor":
        e_w = np.where(UTE > 0.0, 1.0, 0.0)
        w_w = np.where(UTE_w < 0.0, 1.0, 0.0)
    else:  # centered
        e_w = w_w = np.float64(0.5)
    # two sequential adds preserve the reference's left-fold order in the
    # self slot across the UTE/VTN/WVEL passes
    coef[(0, 0, 0)] += np.where(east_open, -(e_w * UTE / TA * dt), 0.0)
    coef[(0, 0, 0)] += np.where(west_open, w_w * UTE_w / TA * dt, 0.0)
    coef[(0, 0, 1)] += np.where(east_open, -((1.0 - e_w) * UTE / TA * dt), 0.0)
    coef[(0, 0, -1)] += np.where(west_open, (1.0 - w_w) * UTE_w / TA * dt, 0.0)


def add_VTN_coeffs(coef, grid, dt: float, adv_type: str, VTN: np.ndarray) -> None:
    """Rebuild of add_VTN_coeffs (src/matrix.c:1291-1368)."""
    km = grid.km
    TA = grid.TAREA[None]
    VTN_s = shift(VTN, dj=-1)
    north_open = target_wet(grid.KMT, km, 0, 1, 0)
    south_open = target_wet(grid.KMT, km, 0, -1, 0)
    if adv_type == "donor":
        n_w = np.where(VTN > 0.0, 1.0, 0.0)
        s_w = np.where(VTN_s < 0.0, 1.0, 0.0)
    else:
        n_w = s_w = np.float64(0.5)
    coef[(0, 0, 0)] += np.where(north_open, -(n_w * VTN / TA * dt), 0.0)
    coef[(0, 0, 0)] += np.where(south_open, s_w * VTN_s / TA * dt, 0.0)
    coef[(0, 1, 0)] += np.where(north_open, -((1.0 - n_w) * VTN / TA * dt), 0.0)
    coef[(0, -1, 0)] += np.where(south_open, (1.0 - s_w) * VTN_s / TA * dt, 0.0)


def add_WVEL_coeffs(coef, grid, dt: float, adv_type: str, WVEL: np.ndarray) -> None:
    """Rebuild of add_WVEL_coeffs (src/matrix.c:1372-1450)."""
    km = grid.km
    dzk = grid.dz[:, None, None]
    W_b = shift(WVEL, dk=1)  # WVEL[k+1]
    top_ex = target_wet(grid.KMT, km, -1, 0, 0)
    bot_ex = target_wet(grid.KMT, km, 1, 0, 0)
    if adv_type == "donor":
        t_w = np.where(WVEL > 0.0, 1.0, 0.0)
        b_w = np.where(W_b < 0.0, 1.0, 0.0)
    else:
        t_w = b_w = np.float64(0.5)
    coef[(0, 0, 0)] += np.where(top_ex, -(t_w * WVEL / dzk * dt), 0.0)
    coef[(0, 0, 0)] += np.where(bot_ex, b_w * W_b / dzk * dt, 0.0)
    coef[(-1, 0, 0)] += np.where(top_ex, -((1.0 - t_w) * WVEL / dzk * dt), 0.0)
    coef[(1, 0, 0)] += np.where(bot_ex, (1.0 - b_w) * W_b / dzk * dt, 0.0)


# ---------------------------------------------------------------------------
# upwind3 (POP QUICK-like third-order upwind, src/matrix.c:1454-2016)
# ---------------------------------------------------------------------------


def load_pos_neg(src, pos_name: str, neg_name: str, zero_surface: bool = False):
    """Read precomputed signed face transports (src/matrix.c:1454-1573)."""
    POS = src.get3_fv0(pos_name)
    NEG = src.get3_fv0(neg_name)
    if zero_surface:
        POS[0, 1:-1, :] = 0.0
        NEG[0, 1:-1, :] = 0.0
    return POS, NEG


def add_UTE_coeffs_upwind3(coef, grid, dt, POS, NEG) -> None:
    """Rebuild of add_UTE_coeffs_upwind3 (src/matrix.c:1577-1694). Weights
    0.75 / 0.375 / -0.125 with the -0.125 tail folded into the adjacent
    weight (0.75 -> 0.625) when the distance-2 upstream cell is dry."""
    km = grid.km
    TA = grid.TAREA[None]
    POS_w = shift(POS, di=-1)
    NEG_w = shift(NEG, di=-1)
    east_open = target_wet(grid.KMT, km, 0, 0, 1)
    west_open = target_wet(grid.KMT, km, 0, 0, -1)
    east2 = target_wet(grid.KMT, km, 0, 0, 2)
    west2 = target_wet(grid.KMT, km, 0, 0, -2)

    coef[(0, 0, 0)] += -(np.where(west_open, 0.75, 0.625) * POS / TA * dt)
    coef[(0, 0, 0)] += -(0.375 * NEG / TA * dt)
    coef[(0, 0, 0)] += 0.375 * POS_w / TA * dt
    coef[(0, 0, 0)] += np.where(east_open, 0.75, 0.625) * NEG_w / TA * dt

    e1 = -(0.375 * POS / TA * dt)
    e2 = -(np.where(east2, 0.75, 0.625) * NEG / TA * dt)
    e3 = (-0.125) * NEG_w / TA * dt
    coef[(0, 0, 1)] += np.where(east_open, (e1 + e2) + e3, 0.0)

    w1 = -((-0.125) * POS / TA * dt)
    w2 = np.where(west2, 0.75, 0.625) * POS_w / TA * dt
    w3 = 0.375 * NEG_w / TA * dt
    coef[(0, 0, -1)] += np.where(west_open, (w1 + w2) + w3, 0.0)

    coef[(0, 0, 2)] += np.where(east2, -((-0.125) * NEG / TA * dt), 0.0)
    coef[(0, 0, -2)] += np.where(west2, (-0.125) * POS_w / TA * dt, 0.0)


def add_VTN_coeffs_upwind3(coef, grid, dt, POS, NEG) -> None:
    """Rebuild of add_VTN_coeffs_upwind3 (src/matrix.c:1698-1815)."""
    km = grid.km
    TA = grid.TAREA[None]
    POS_s = shift(POS, dj=-1)
    NEG_s = shift(NEG, dj=-1)
    north_open = target_wet(grid.KMT, km, 0, 1, 0)
    south_open = target_wet(grid.KMT, km, 0, -1, 0)
    north2 = target_wet(grid.KMT, km, 0, 2, 0)
    south2 = target_wet(grid.KMT, km, 0, -2, 0)

    coef[(0, 0, 0)] += -(np.where(south_open, 0.75, 0.625) * POS / TA * dt)
    coef[(0, 0, 0)] += -(0.375 * NEG / TA * dt)
    coef[(0, 0, 0)] += 0.375 * POS_s / TA * dt
    coef[(0, 0, 0)] += np.where(north_open, 0.75, 0.625) * NEG_s / TA * dt

    n1 = -(0.375 * POS / TA * dt)
    n2 = -(np.where(north2, 0.75, 0.625) * NEG / TA * dt)
    n3 = (-0.125) * NEG_s / TA * dt
    coef[(0, 1, 0)] += np.where(north_open, (n1 + n2) + n3, 0.0)

    t1 = -((-0.125) * POS / TA * dt)
    t2 = np.where(south2, 0.75, 0.625) * POS_s / TA * dt
    t3 = 0.375 * NEG_s / TA * dt
    coef[(0, -1, 0)] += np.where(south_open, (t1 + t2) + t3, 0.0)

    coef[(0, 2, 0)] += np.where(north2, -((-0.125) * NEG / TA * dt), 0.0)
    coef[(0, -2, 0)] += np.where(south2, (-0.125) * POS_s / TA * dt, 0.0)


def vertical_upwind3_weights(dz: np.ndarray):
    """Nonuniform-grid vertical QUICK weights, transcribed from the POP
    formulas the reference reproduces (src/matrix.c:1870-1901)."""
    km = len(dz)
    dzc = np.empty(km + 2)
    dzc[0] = dz[0]            # dzc[-1] in reference indexing
    dzc[1:km + 1] = dz
    dzc[km + 1] = dzc[km]

    def c(k):  # dzc with reference's shifted index
        return dzc[k + 1]

    talfzp = np.zeros(km)
    tbetzp = np.zeros(km)
    tgamzp = np.zeros(km)
    talfzm = np.zeros(km)
    tbetzm = np.zeros(km)
    tdelzm = np.zeros(km)
    for k in range(km - 1):
        talfzp[k] = dz[k] * (2.0 * dz[k] + c(k - 1)) / (dz[k] + dz[k + 1]) / (
            c(k - 1) + 2.0 * dz[k] + dz[k + 1])
        tbetzp[k] = dz[k + 1] * (2.0 * dz[k] + c(k - 1)) / (dz[k] + dz[k + 1]) / (
            dz[k] + c(k - 1))
        tgamzp[k] = -(dz[k] * dz[k + 1]) / (dz[k] + c(k - 1)) / (
            dz[k + 1] + c(k - 1) + 2.0 * dz[k])
    tbetzp[0] = tbetzp[0] + tgamzp[0]
    tgamzp[0] = 0.0
    talfzp[km - 1] = 0.0
    tbetzp[km - 1] = 0.0
    tgamzp[km - 1] = 0.0
    for k in range(km - 1):
        talfzm[k] = dz[k] * (2.0 * dz[k + 1] + c(k + 2)) / (dz[k] + dz[k + 1]) / (
            dz[k + 1] + c(k + 2))
        tbetzm[k] = dz[k + 1] * (2.0 * dz[k + 1] + c(k + 2)) / (dz[k] + dz[k + 1]) / (
            dz[k] + c(k + 2) + 2.0 * dz[k + 1])
        tdelzm[k] = -(dz[k] * dz[k + 1]) / (dz[k + 1] + c(k + 2)) / (
            dz[k] + c(k + 2) + 2.0 * dz[k + 1])
    talfzm[km - 1] = 0.0
    tbetzm[km - 1] = 0.0
    tdelzm[km - 1] = 0.0
    return talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm


def add_WVEL_coeffs_upwind3(coef, grid, dt, POS, NEG) -> None:
    """Rebuild of add_WVEL_coeffs_upwind3 (src/matrix.c:1819-2016)."""
    km = grid.km
    dzk = grid.dz[:, None, None]
    talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm = vertical_upwind3_weights(grid.dz)

    def at_km1(arr):  # arr[k-1] per level, 0-fill at k=0 (masked anyway)
        return np.concatenate([[0.0], arr[:-1]])[:, None, None]

    def at_k(arr):
        return arr[:, None, None]

    POS_b = shift(POS, dk=1)   # [k+1]
    NEG_b = shift(NEG, dk=1)
    top_ex = target_wet(grid.KMT, km, -1, 0, 0)
    bot_ex = target_wet(grid.KMT, km, 1, 0, 0)
    top2_ex = target_wet(grid.KMT, km, -2, 0, 0)
    bot2_ex = target_wet(grid.KMT, km, 2, 0, 0)

    # cell itself
    s1 = -(np.where(bot_ex, at_km1(talfzm), at_km1(talfzm) + at_km1(tdelzm))
           * POS / dzk * dt)
    s2 = -(at_km1(talfzp) * NEG / dzk * dt)
    s3 = at_k(tbetzm) * POS_b / dzk * dt
    s4 = at_k(tbetzp) * NEG_b / dzk * dt
    coef[(0, 0, 0)] += np.where(top_ex, s1, 0.0)
    coef[(0, 0, 0)] += np.where(top_ex, s2, 0.0)
    coef[(0, 0, 0)] += np.where(bot_ex, s3, 0.0)
    coef[(0, 0, 0)] += np.where(bot_ex, s4, 0.0)

    # 1 level shallower
    sh1 = -(at_km1(tbetzm) * POS / dzk * dt)
    sh2 = -(at_km1(tbetzp) * NEG / dzk * dt)
    sh3 = np.where(bot_ex, at_k(tgamzp) * NEG_b / dzk * dt, 0.0)
    coef[(-1, 0, 0)] += np.where(top_ex, (sh1 + sh2) + sh3, 0.0)

    # 1 level deeper
    d1 = np.where(top_ex, -(at_km1(tdelzm) * POS / dzk * dt), 0.0)
    d2 = (np.where(bot2_ex, at_k(talfzm), at_k(talfzm) + at_k(tdelzm))
          * POS_b / dzk * dt)
    d3 = at_k(talfzp) * NEG_b / dzk * dt
    coef[(1, 0, 0)] += np.where(bot_ex, (d1 + d2) + d3, 0.0)

    # 2 shallower / 2 deeper
    coef[(-2, 0, 0)] += np.where(top2_ex, -(at_km1(tgamzp) * NEG / dzk * dt), 0.0)
    coef[(2, 0, 0)] += np.where(bot2_ex, at_k(tdelzm) * POS_b / dzk * dt, 0.0)


def add_adv(coef, grid, opts, src) -> None:
    """Dispatcher, rebuild of add_adv (src/matrix.c:2020-2089)."""
    dt = opts.delta_t
    hor = opts.hmix_type == "hor_file"
    if opts.adv_type == "none":
        return
    if opts.adv_type in ("donor", "centered"):
        add_UTE_coeffs(coef, grid, dt, opts.adv_type, load_UTE(grid, src, hor))
        add_VTN_coeffs(coef, grid, dt, opts.adv_type, load_VTN(grid, src, hor))
        add_WVEL_coeffs(coef, grid, dt, opts.adv_type, load_WVEL(grid, src, hor))
    elif opts.adv_type == "upwind3":
        POS, NEG = load_pos_neg(src, "UTE_POS", "UTE_NEG")
        add_UTE_coeffs_upwind3(coef, grid, dt, POS, NEG)
        POS, NEG = load_pos_neg(src, "VTN_POS", "VTN_NEG")
        add_VTN_coeffs_upwind3(coef, grid, dt, POS, NEG)
        POS, NEG = load_pos_neg(src, "WTK_POS", "WTK_NEG", zero_surface=True)
        add_WVEL_coeffs_upwind3(coef, grid, dt, POS, NEG)
    else:
        raise ValueError(opts.adv_type)


def adv_enforce_divfree(coef, adv_type: str) -> None:
    """Overwrite each self coefficient with minus the sum of the advective
    off-diagonal terms so rows sum to zero (src/matrix.c:2093-2206). Must
    run immediately after add_adv, before mixing terms are added
    (src/matrix.c:3795-3800)."""
    from .offsets import ADV2_OFFSETS, FACE_OFFSETS

    order = FACE_OFFSETS[1:] + (ADV2_OFFSETS if adv_type == "upwind3" else [])
    total = np.zeros_like(coef[(0, 0, 0)])
    for off in order:
        total = total + coef[off]
    coef[(0, 0, 0)] = -total
