"""Horizontal / isopycnal mixing assembly.

Vectorized rebuild of src/matrix.c:2210-2771: the impulse-response-function
(IRF) scheme, the spatially-varying Laplacian (hor_file), and the constant
Laplacian.
"""

from __future__ import annotations

import numpy as np

from .offsets import FACE_OFFSETS, ISOP_OFFSETS, shift2, target_wet

IRF_NAME = "HDIF_EXPLICIT_3D_IRF_{}_{}_{}"
IRF_NAME_NK = "HDIF_EXPLICIT_3D_IRF_NK_{}_{}_{}"


def add_hmix_isop_file(coef, grid, dt, src) -> None:
    """Rebuild of add_hmix_isop_file (src/matrix.c:2210-2386).

    The circulation file carries 36 IRF fields forming a (4,3,3) space
    coloring in (i, j, k). A matrix entry (row cell -> target cell at a
    stencil offset) receives IRF value IRF_{i'%4+1, j'%3+1, k'%3+1}[row]
    where (i', j', k') is the TARGET cell — each (row, offset) pair matches
    exactly one of the 36 fields, so the 36-pass reference loop collapses
    into one gather per offset. Covers the 7 face offsets plus the 8
    vertical-diagonal offsets.
    """
    km, jmt, imt = grid.km, grid.jmt, grid.imt

    # load the 36 fields (with per-field _NK_ name fallback, matrix.c:2236-2255)
    stack = np.empty((36, km, jmt, imt))
    for ip in range(4):
        for jp in range(3):
            for kp in range(3):
                name = IRF_NAME.format(ip + 1, jp + 1, kp + 1)
                if not src.exists(name):
                    name = IRF_NAME_NK.format(ip + 1, jp + 1, kp + 1)
                    if not src.exists(name):
                        raise FileNotFoundError(f"IRF field {name} not found")
                stack[ip * 9 + jp * 3 + kp] = src.get3(name)

    kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt), np.arange(imt),
                             indexing="ij")
    for off in FACE_OFFSETS + ISOP_OFFSETS:
        dk, dj, di = off
        valid = target_wet(grid.KMT, km, dk, dj, di)
        ti = (ii + di) % imt
        tj = np.clip(jj + dj, 0, jmt - 1)
        tk = np.clip(kk + dk, 0, km - 1)
        sel = (ti % 4) * 9 + (tj % 3) * 3 + (tk % 3)
        contrib = stack[sel, kk, jj, ii] * dt
        if off == (0, 0, 0):
            # the self entry always exists for a wet row; the color
            # condition alone gates the add (matrix.c:2279-2282)
            coef[off] += contrib
        else:
            coef[off] += np.where(valid, contrib, 0.0)


def _laplacian_coeffs(grid, dt, kappa_e, kappa_w, kappa_n, kappa_s, src):
    """Shared structure of add_hmix_hor_file / add_hmix_const
    (src/matrix.c:2481-2557 / 2636-2711): flux-divergence Laplacian with
    metric factors HTE/HUS (east-west) and HTN/HUW (north-south)."""
    km = grid.km
    TA = grid.TAREA[None]
    HUS = src.get2_fv0("HUS")
    HTE = src.get2_fv0("HTE")
    HUW = src.get2_fv0("HUW")
    HTN = src.get2_fv0("HTN")
    east_open = target_wet(grid.KMT, km, 0, 0, 1)
    west_open = target_wet(grid.KMT, km, 0, 0, -1)
    north_open = target_wet(grid.KMT, km, 0, 1, 0)
    south_open = target_wet(grid.KMT, km, 0, -1, 0)

    HTE_w = shift2(HTE, di=-1)
    HUS_w = shift2(HUS, di=-1)
    HTN_s = shift2(HTN, dj=-1)
    HUW_s = shift2(HUW, dj=-1)

    with np.errstate(divide="ignore", invalid="ignore"):
        ce = np.where(east_open, kappa_e * HTE[None] / HUS[None] / TA * dt, 0.0)
        cw = np.where(west_open, kappa_w * HTE_w[None] / HUS_w[None] / TA * dt, 0.0)
        cn = np.where(north_open, kappa_n * HTN[None] / HUW[None] / TA * dt, 0.0)
        cs = np.where(south_open, kappa_s * HTN_s[None] / HUW_s[None] / TA * dt, 0.0)
    return ce, cw, cn, cs


def add_hmix_hor_file(coef, grid, dt, src) -> None:
    """Rebuild of add_hmix_hor_file (src/matrix.c:2390-2572): kappa =
    KAPPA_ISOP + HOR_DIFF (interior rows), face kappa = average of the two
    adjacent cells."""
    km = grid.km
    kk = np.arange(km)[:, None, None]
    KAPPA = src.get3_fv0("KAPPA_ISOP")
    WORK = src.get3_fv0("HOR_DIFF")
    wet = kk < grid.KMT[None]
    KAPPA[:, 1:-1, :] = (KAPPA + np.where(wet, WORK, 0.0))[:, 1:-1, :]

    from .offsets import shift
    ke = 0.5 * (KAPPA + shift(KAPPA, di=1))
    kw = 0.5 * (shift(KAPPA, di=-1) + KAPPA)
    kn = 0.5 * (KAPPA + shift(KAPPA, dj=1))
    ks = 0.5 * (shift(KAPPA, dj=-1) + KAPPA)
    ce, cw, cn, cs = _laplacian_coeffs(grid, dt, ke, kw, kn, ks, src)
    coef[(0, 0, 0)] += -(((ce + cw) + cn) + cs)
    coef[(0, 0, 1)] += ce
    coef[(0, 0, -1)] += cw
    coef[(0, 1, 0)] += cn
    coef[(0, -1, 0)] += cs


def add_hmix_const(coef, grid, dt, src, ah: float = 4.0e6) -> None:
    """Rebuild of add_hmix_const (src/matrix.c:2576-2725); ah in cm^2/s."""
    ce, cw, cn, cs = _laplacian_coeffs(grid, dt, ah, ah, ah, ah, src)
    coef[(0, 0, 0)] += -(((ce + cw) + cn) + cs)
    coef[(0, 0, 1)] += ce
    coef[(0, 0, -1)] += cw
    coef[(0, 1, 0)] += cn
    coef[(0, -1, 0)] += cs


def add_hmix(coef, grid, opts, src) -> None:
    """Dispatcher, rebuild of add_hmix (src/matrix.c:2729-2771)."""
    if opts.hmix_type == "none":
        return
    if opts.hmix_type == "const":
        add_hmix_const(coef, grid, opts.delta_t, src)
    elif opts.hmix_type == "hor_file":
        if opts.adv_type == "upwind3":
            raise ValueError("cannot use hmix_hor_file with adv_upwind3")
        add_hmix_hor_file(coef, grid, opts.delta_t, src)
    elif opts.hmix_type == "isop_file":
        add_hmix_isop_file(coef, grid, opts.delta_t, src)
    else:
        raise ValueError(opts.hmix_type)
