"""A frozen, numpy-only copy of stage 1 (gen_A) for the benchmark's
configurations: the synthetic POP-like circulation, the upwind3 face
transports derived from its velocities, and the assembly of the canonical
CSR Jacobian with its index maps.

The circulation is the one ``make_circ_file`` writes (same random draws,
same land masking with POP's fill value, read back with the fill value
zeroed where the assembly zeroes it), held in memory instead of a NetCDF
file. The assembly covers the options the benchmark's configurations
name: ``adv_type`` centered or upwind3 (``l_adv_enforce_divfree`` on),
``hmix_type isop_file``, ``vmix_type file``, one tracer with a constant
sink. The CSR is compacted by sorting, with duplicates summed in slot
order and exact zeros stripped, so it equals the gen_A matrix file's
arrays byte for byte (``benchmark/tests/test_harness_reference.py``).
"""

from __future__ import annotations

import numpy as np

FV = 9.96921e36          # POP's _FillValue
SECONDS_PER_DAY = 86400.0

# (dk, dj, di) offsets in the reference's within-row slot order
SELF = (0, 0, 0)
FACE_OFFSETS = [SELF, (-1, 0, 0), (1, 0, 0), (0, 0, 1), (0, 0, -1),
                (0, 1, 0), (0, -1, 0)]
ADV2_OFFSETS = [(-2, 0, 0), (2, 0, 0), (0, 0, 2), (0, 0, -2), (0, 2, 0),
                (0, -2, 0)]
ISOP_OFFSETS = [(-1, 0, 1), (1, 0, 1), (-1, 0, -1), (1, 0, -1),
                (-1, 1, 0), (1, 1, 0), (-1, -1, 0), (1, -1, 0)]
ADV_TYPES = ("centered", "upwind3")


# --------------------------------------------------------------------------
# shifts and masks
# --------------------------------------------------------------------------

def _shift_axis(field, d: int, axis: int, fill):
    out = np.full_like(field, fill)
    src = [slice(None)] * field.ndim
    dst = [slice(None)] * field.ndim
    if d > 0:
        src[axis], dst[axis] = slice(d, None), slice(None, -d)
    else:
        src[axis], dst[axis] = slice(None, d), slice(-d, None)
    out[tuple(dst)] = field[tuple(src)]
    return out


def shift(field, dk: int = 0, dj: int = 0, di: int = 0, fill=0.0):
    """out[k,j,i] = field[k+dk, j+dj, i+di]; i wraps, k and j fill."""
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


def target_wet(KMT, km: int, dk: int, dj: int, di: int):
    """(km, jmt, imt) bool: the cell at the offset is wet and in bounds."""
    jmt = KMT.shape[0]
    kk = np.arange(km)[:, None, None]
    kmt_t = shift(KMT.astype(np.int64), 0, dj, di, fill=0)
    ok = (kk + dk >= 0) & (kk + dk < km) & (kk + dk < kmt_t[None, :, :])
    jj = np.arange(jmt)[None, :, None]
    return ok & (jj + dj >= 0) & (jj + dj < jmt)


def wet3d(KMT, km: int):
    return np.arange(km)[:, None, None] < KMT[None, :, :]


# --------------------------------------------------------------------------
# the synthetic circulation
# --------------------------------------------------------------------------

def synthetic_grid(imt: int, jmt: int, km: int, seed: int) -> dict:
    """Bathymetry and metrics of the synthetic grid of ``seed``."""
    rng = np.random.default_rng(seed)
    dz = 1000.0 * (1.0 + 0.15 * np.arange(km))
    z_t = np.cumsum(dz) - 0.5 * dz
    jj, ii = np.meshgrid(np.arange(jmt), np.arange(imt), indexing="ij")
    TLAT = -80.0 + 160.0 * (jj + 0.5) / jmt
    depth = rng.uniform(0, km + 3, size=(jmt, imt))
    for _ in range(3):
        depth = 0.5 * depth + 0.125 * (
            np.roll(depth, 1, 1) + np.roll(depth, -1, 1)
            + np.vstack([depth[:1], depth[:-1]])
            + np.vstack([depth[1:], depth[-1:]]))
    KMT = np.clip(depth.astype(np.int64), 0, km)
    KMT[depth < 1.2] = 0
    KMT[0, :] = 0
    KMT[-1, :] = 0
    if (KMT > 0).sum() < max(4, imt * jmt // 8):
        KMT[1:-1] = np.maximum(KMT[1:-1],
                               1 + (ii[1:-1] + jj[1:-1]) % min(km, 3))
    base_dx = 5.0e7 / imt
    base_dy = 4.0e7 / jmt
    lat_fac = np.maximum(np.cos(np.deg2rad(TLAT)), 0.2)
    HTN = base_dx * lat_fac * (1 + 0.05 * np.sin(2 * np.pi * ii / imt))
    HTE = base_dy * (1 + 0.05 * np.cos(2 * np.pi * jj / jmt))
    return dict(dz=dz, z_t=z_t, KMT=KMT, TAREA=HTN * HTE,
                DXU=HTN * 1.01, DYU=HTE * 0.99)


def derive_kmu(KMT):
    """U-point depth: the min of the four surrounding KMT; last row 0."""
    east = np.roll(KMT, -1, axis=1)
    kmu = np.zeros_like(KMT)
    kmu[:-1] = np.minimum(np.minimum(KMT[:-1], KMT[1:]),
                          np.minimum(east[:-1], east[1:]))
    return kmu


def circulation(imt: int, jmt: int, km: int, seed: int,
                adv_type: str) -> dict:
    """The fields the assembly reads, as the circulation file of ``seed``
    holds them after its fill values are zeroed (or, for the IRF fields,
    which the assembly reads raw, with the fill value on land). For
    upwind3 the face transports are the positive and negative parts of
    the centered scheme's own transports."""
    g = synthetic_grid(imt, jmt, km, seed)
    rng = np.random.default_rng(seed + 1)
    KMT = g["KMT"]
    KMU = derive_kmu(KMT)
    wetT, wetU = wet3d(KMT, km), wet3d(KMU, km)

    def rand3(scale=1.0):
        return scale * rng.standard_normal((km, jmt, imt))

    f = dict(dz=g["dz"], z_t=g["z_t"], KMT=KMT, KMU=KMU, TAREA=g["TAREA"],
             DYU=np.where(KMU > 0, g["DYU"], 0.0),
             DXU=np.where(KMU > 0, g["DXU"], 0.0))
    f["UVEL"] = np.where(wetU, rand3(5.0), 0.0)
    f["VVEL"] = np.where(wetU, rand3(5.0), 0.0)
    f["WVEL"] = np.where(wetT, rand3(1e-3), 0.0)
    for _ in range(3):                     # UISOP, VISOP, WISOP: unused
        rand3()
    pos_neg = {}
    for name, scale in (("UTE", 3.0e10), ("VTN", 3.0e10), ("WTK", 2.0e4)):
        t = scale * rng.standard_normal((km, jmt, imt))
        pos_neg[name] = (np.where(wetT, np.maximum(t, 0.0), 0.0),
                         np.where(wetT, np.minimum(t, 0.0), 0.0))
    for _ in range(2):                     # KAPPA_ISOP, HOR_DIFF: unused
        rand3()
    f["VDC_S"] = np.where(wetT, np.abs(rand3(0.5)), 0.0)
    f["VDC_GM"] = np.where(wetT, np.abs(rand3(0.3)), 0.0)
    irf = np.empty((36, km, jmt, imt))
    for c in range(36):                    # (ip, jp, kp) row-major
        irf[c] = np.where(wetT, rand3(1e-7), FV)
    f["IRF"] = irf
    if adv_type == "upwind3":
        for name, t in (("UTE", load_UTE(f)), ("VTN", load_VTN(f)),
                        ("WTK", load_WVEL(f))):
            pos_neg[name] = (np.where(wetT, np.maximum(t, 0.0), 0.0),
                             np.where(wetT, np.minimum(t, 0.0), 0.0))
    f["POS_NEG"] = pos_neg
    return f


# --------------------------------------------------------------------------
# advection
# --------------------------------------------------------------------------

def _kk(km):
    return np.arange(km)[:, None, None]


def load_UTE(f):
    km = len(f["dz"])
    mask_u = _kk(km) < f["KMU"][None]
    a = 0.5 * f["UVEL"] * f["DYU"][None]
    t1 = np.where(mask_u, a, 0.0)
    t2 = shift(np.where(mask_u, a, 0.0), dj=-1)
    ute = np.zeros_like(f["UVEL"])
    ute[:, 1:-1, :] = (t1 + t2)[:, 1:-1, :]
    return ute


def load_VTN(f):
    km = len(f["dz"])
    mask_u = _kk(km) < f["KMU"][None]
    a = 0.5 * f["VVEL"] * f["DXU"][None]
    t1 = np.where(mask_u, a, 0.0)
    t2 = shift(np.where(mask_u, a, 0.0), di=-1)
    vtn = np.zeros_like(f["VVEL"])
    vtn[:, 1:-1, :] = (t1 + t2)[:, 1:-1, :]
    return vtn


def load_WVEL(f):
    km = len(f["dz"])
    wet = _kk(km) < f["KMT"][None]
    wvel = np.zeros_like(f["WVEL"])
    wvel[:, 1:-1, :] = np.where(wet, f["WVEL"], 0.0)[:, 1:-1, :]
    wvel[0] = 0.0
    return wvel


def add_centered(coef, f, dt):
    """Centered advection through the east, north and top faces."""
    KMT, km = f["KMT"], len(f["dz"])
    TA = f["TAREA"][None]
    dzk = f["dz"][:, None, None]
    half = np.float64(0.5)
    UTE, VTN, WVEL = load_UTE(f), load_VTN(f), load_WVEL(f)

    UTE_w = shift(UTE, di=-1)
    e_open, w_open = target_wet(KMT, km, 0, 0, 1), target_wet(KMT, km, 0, 0, -1)
    coef[SELF] += np.where(e_open, -(half * UTE / TA * dt), 0.0)
    coef[SELF] += np.where(w_open, half * UTE_w / TA * dt, 0.0)
    coef[(0, 0, 1)] += np.where(e_open, -((1.0 - half) * UTE / TA * dt), 0.0)
    coef[(0, 0, -1)] += np.where(w_open, (1.0 - half) * UTE_w / TA * dt, 0.0)

    VTN_s = shift(VTN, dj=-1)
    n_open, s_open = target_wet(KMT, km, 0, 1, 0), target_wet(KMT, km, 0, -1, 0)
    coef[SELF] += np.where(n_open, -(half * VTN / TA * dt), 0.0)
    coef[SELF] += np.where(s_open, half * VTN_s / TA * dt, 0.0)
    coef[(0, 1, 0)] += np.where(n_open, -((1.0 - half) * VTN / TA * dt), 0.0)
    coef[(0, -1, 0)] += np.where(s_open, (1.0 - half) * VTN_s / TA * dt, 0.0)

    W_b = shift(WVEL, dk=1)
    t_ex, b_ex = target_wet(KMT, km, -1, 0, 0), target_wet(KMT, km, 1, 0, 0)
    coef[SELF] += np.where(t_ex, -(half * WVEL / dzk * dt), 0.0)
    coef[SELF] += np.where(b_ex, half * W_b / dzk * dt, 0.0)
    coef[(-1, 0, 0)] += np.where(t_ex, -((1.0 - half) * WVEL / dzk * dt), 0.0)
    coef[(1, 0, 0)] += np.where(b_ex, (1.0 - half) * W_b / dzk * dt, 0.0)


def _upwind3_horizontal(coef, f, dt, name, axis_off):
    """Third-order upwind through the east (axis_off (0, 1)) or north
    ((1, 0)) faces; weights 0.75 / 0.375 / -0.125, the tail folded into
    the adjacent weight (0.625) where the distance-2 cell is dry."""
    KMT, km = f["KMT"], len(f["dz"])
    TA = f["TAREA"][None]
    POS, NEG = f["POS_NEG"][name]
    dj, di = axis_off
    POS_b = shift(POS, dj=-dj, di=-di)
    NEG_b = shift(NEG, dj=-dj, di=-di)
    fwd = target_wet(KMT, km, 0, dj, di)
    back = target_wet(KMT, km, 0, -dj, -di)
    fwd2 = target_wet(KMT, km, 0, 2 * dj, 2 * di)
    back2 = target_wet(KMT, km, 0, -2 * dj, -2 * di)

    coef[SELF] += -(np.where(back, 0.75, 0.625) * POS / TA * dt)
    coef[SELF] += -(0.375 * NEG / TA * dt)
    coef[SELF] += 0.375 * POS_b / TA * dt
    coef[SELF] += np.where(fwd, 0.75, 0.625) * NEG_b / TA * dt

    e1 = -(0.375 * POS / TA * dt)
    e2 = -(np.where(fwd2, 0.75, 0.625) * NEG / TA * dt)
    e3 = (-0.125) * NEG_b / TA * dt
    coef[(0, dj, di)] += np.where(fwd, (e1 + e2) + e3, 0.0)

    w1 = -((-0.125) * POS / TA * dt)
    w2 = np.where(back2, 0.75, 0.625) * POS_b / TA * dt
    w3 = 0.375 * NEG_b / TA * dt
    coef[(0, -dj, -di)] += np.where(back, (w1 + w2) + w3, 0.0)

    coef[(0, 2 * dj, 2 * di)] += np.where(fwd2,
                                          -((-0.125) * NEG / TA * dt), 0.0)
    coef[(0, -2 * dj, -2 * di)] += np.where(back2,
                                            (-0.125) * POS_b / TA * dt, 0.0)


def vertical_upwind3_weights(dz):
    """POP's nonuniform-grid vertical QUICK weights."""
    km = len(dz)
    dzc = np.empty(km + 2)
    dzc[0] = dz[0]
    dzc[1:km + 1] = dz
    dzc[km + 1] = dzc[km]

    def c(k):
        return dzc[k + 1]

    talfzp, tbetzp, tgamzp = np.zeros(km), np.zeros(km), np.zeros(km)
    talfzm, tbetzm, tdelzm = np.zeros(km), np.zeros(km), np.zeros(km)
    for k in range(km - 1):
        talfzp[k] = dz[k] * (2.0 * dz[k] + c(k - 1)) / (dz[k] + dz[k + 1]) / (
            c(k - 1) + 2.0 * dz[k] + dz[k + 1])
        tbetzp[k] = dz[k + 1] * (2.0 * dz[k] + c(k - 1)) / (dz[k] + dz[k + 1]) / (
            dz[k] + c(k - 1))
        tgamzp[k] = -(dz[k] * dz[k + 1]) / (dz[k] + c(k - 1)) / (
            dz[k + 1] + c(k - 1) + 2.0 * dz[k])
    tbetzp[0] = tbetzp[0] + tgamzp[0]
    tgamzp[0] = 0.0
    talfzp[km - 1] = tbetzp[km - 1] = tgamzp[km - 1] = 0.0
    for k in range(km - 1):
        talfzm[k] = dz[k] * (2.0 * dz[k + 1] + c(k + 2)) / (dz[k] + dz[k + 1]) / (
            dz[k + 1] + c(k + 2))
        tbetzm[k] = dz[k + 1] * (2.0 * dz[k + 1] + c(k + 2)) / (dz[k] + dz[k + 1]) / (
            dz[k] + c(k + 2) + 2.0 * dz[k + 1])
        tdelzm[k] = -(dz[k] * dz[k + 1]) / (dz[k + 1] + c(k + 2)) / (
            dz[k] + c(k + 2) + 2.0 * dz[k + 1])
    talfzm[km - 1] = tbetzm[km - 1] = tdelzm[km - 1] = 0.0
    return talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm


def _upwind3_vertical(coef, f, dt):
    KMT, dz = f["KMT"], f["dz"]
    km = len(dz)
    dzk = dz[:, None, None]
    talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm = \
        vertical_upwind3_weights(dz)

    def at_km1(arr):
        return np.concatenate([[0.0], arr[:-1]])[:, None, None]

    def at_k(arr):
        return arr[:, None, None]

    POS, NEG = (a.copy() for a in f["POS_NEG"]["WTK"])
    POS[0, 1:-1, :] = 0.0
    NEG[0, 1:-1, :] = 0.0
    POS_b, NEG_b = shift(POS, dk=1), shift(NEG, dk=1)
    top_ex, bot_ex = target_wet(KMT, km, -1, 0, 0), target_wet(KMT, km, 1, 0, 0)
    top2_ex = target_wet(KMT, km, -2, 0, 0)
    bot2_ex = target_wet(KMT, km, 2, 0, 0)

    s1 = -(np.where(bot_ex, at_km1(talfzm), at_km1(talfzm) + at_km1(tdelzm))
           * POS / dzk * dt)
    s2 = -(at_km1(talfzp) * NEG / dzk * dt)
    s3 = at_k(tbetzm) * POS_b / dzk * dt
    s4 = at_k(tbetzp) * NEG_b / dzk * dt
    coef[SELF] += np.where(top_ex, s1, 0.0)
    coef[SELF] += np.where(top_ex, s2, 0.0)
    coef[SELF] += np.where(bot_ex, s3, 0.0)
    coef[SELF] += np.where(bot_ex, s4, 0.0)

    sh1 = -(at_km1(tbetzm) * POS / dzk * dt)
    sh2 = -(at_km1(tbetzp) * NEG / dzk * dt)
    sh3 = np.where(bot_ex, at_k(tgamzp) * NEG_b / dzk * dt, 0.0)
    coef[(-1, 0, 0)] += np.where(top_ex, (sh1 + sh2) + sh3, 0.0)

    d1 = np.where(top_ex, -(at_km1(tdelzm) * POS / dzk * dt), 0.0)
    d2 = (np.where(bot2_ex, at_k(talfzm), at_k(talfzm) + at_k(tdelzm))
          * POS_b / dzk * dt)
    d3 = at_k(talfzp) * NEG_b / dzk * dt
    coef[(1, 0, 0)] += np.where(bot_ex, (d1 + d2) + d3, 0.0)

    coef[(-2, 0, 0)] += np.where(top2_ex,
                                 -(at_km1(tgamzp) * NEG / dzk * dt), 0.0)
    coef[(2, 0, 0)] += np.where(bot2_ex, at_k(tdelzm) * POS_b / dzk * dt, 0.0)


def add_upwind3(coef, f, dt):
    _upwind3_horizontal(coef, f, dt, "UTE", (0, 1))
    _upwind3_horizontal(coef, f, dt, "VTN", (1, 0))
    _upwind3_vertical(coef, f, dt)


def enforce_divfree(coef, adv_type: str):
    """Each self coefficient becomes minus the sum of the advective
    off-diagonal terms, so advection conserves."""
    order = FACE_OFFSETS[1:] + (ADV2_OFFSETS if adv_type == "upwind3" else [])
    total = np.zeros_like(coef[SELF])
    for off in order:
        total = total + coef[off]
    coef[SELF] = -total


# --------------------------------------------------------------------------
# mixing and the sink
# --------------------------------------------------------------------------

def add_isop_file(coef, f, dt):
    """The IRF scheme: entry (row, target) gets IRF_{i'%4, j'%3, k'%3} at
    the row cell, (i', j', k') the target cell."""
    KMT, km = f["KMT"], len(f["dz"])
    jmt, imt = KMT.shape
    stack = f["IRF"]
    kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt), np.arange(imt),
                             indexing="ij")
    for off in FACE_OFFSETS + ISOP_OFFSETS:
        dk, dj, di = off
        valid = target_wet(KMT, km, dk, dj, di)
        ti = (ii + di) % imt
        tj = np.clip(jj + dj, 0, jmt - 1)
        tk = np.clip(kk + dk, 0, km - 1)
        sel = (ti % 4) * 9 + (tj % 3) * 3 + (tk % 3)
        contrib = stack[sel, kk, jj, ii] * dt
        if off == SELF:
            coef[off] += contrib
        else:
            coef[off] += np.where(valid, contrib, 0.0)


def add_vmix_file(coef, f, dt):
    """Diffusive vertical coupling from VDC_S + VDC_GM (GM on interior
    rows only)."""
    KMT, dz = f["KMT"], f["dz"]
    km = len(dz)
    VDC = f["VDC_S"].copy()
    VDC[:, 1:-1, :] = (VDC + f["VDC_GM"])[:, 1:-1, :]
    dzk = dz[:, None, None]
    dz_km1 = np.concatenate([[0.0], dz[:-1]])[:, None, None]
    dz_kp1 = np.concatenate([dz[1:], [0.0]])[:, None, None]
    top_ex, bot_ex = target_wet(KMT, km, -1, 0, 0), target_wet(KMT, km, 1, 0, 0)
    VDC_km1 = np.concatenate([np.zeros_like(VDC[:1]), VDC[:-1]], axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ct = np.where(top_ex, VDC_km1 / (0.5 * (dz_km1 + dzk)) / dzk * dt, 0.0)
        cb = np.where(bot_ex, VDC / (0.5 * (dzk + dz_kp1)) / dzk * dt, 0.0)
    coef[SELF] += -(ct + cb)
    coef[(-1, 0, 0)] += ct
    coef[(1, 0, 0)] += cb


# --------------------------------------------------------------------------
# index maps and the canonical CSR
# --------------------------------------------------------------------------

def ind_maps(KMT, km: int) -> dict:
    """Wet cells numbered j outer, i middle, k inner."""
    jmt, imt = KMT.shape
    wet_jik = wet3d(KMT, km).transpose(1, 2, 0)
    flat = wet_jik.reshape(-1)
    ind = np.cumsum(flat) - 1
    int3 = np.where(flat, ind, -1).reshape(jmt, imt, km).transpose(2, 0, 1)
    flat_idx = np.flatnonzero(wet_jik)
    return dict(tracer_state_len=int(flat.sum()),
                int3_to_ind=int3.astype(np.int64),
                ind_to_i=((flat_idx // km) % imt).astype(np.int64),
                ind_to_j=(flat_idx // (km * imt)).astype(np.int64),
                ind_to_k=(flat_idx % km).astype(np.int64))


def assemble(config: dict) -> dict:
    """The configuration's Jacobian: ``nzval``, ``colind``, ``rowptr``
    (int64) and the index maps (``ind_maps``' keys). ``config`` gives
    ``grid`` (imt, jmt, km), ``circulation_seed`` and ``assembly``
    (adv_type, hmix_type, vmix_type, sink_type, sink_rate, day_cnt)."""
    g, a = config["grid"], config["assembly"]
    imt, jmt, km = g["imt"], g["jmt"], g["km"]
    if (a["adv_type"] not in ADV_TYPES or a["hmix_type"] != "isop_file"
            or a["vmix_type"] != "file" or a["sink_type"] != "const"
            or not a.get("l_adv_enforce_divfree", True)):
        raise ValueError(f"options outside the frozen stage 1: {a}")
    dt = SECONDS_PER_DAY * a["day_cnt"]
    year_cnt = a["day_cnt"] / 365.0
    f = circulation(imt, jmt, km, config["circulation_seed"], a["adv_type"])
    KMT = f["KMT"]
    if KMT[0].any() or KMT[-1].any():
        raise ValueError("non-land on a polar row")
    offsets = FACE_OFFSETS + (ADV2_OFFSETS if a["adv_type"] == "upwind3"
                              else []) + ISOP_OFFSETS
    coef = {off: np.zeros((km, jmt, imt)) for off in offsets}
    if a["adv_type"] == "centered":
        add_centered(coef, f, dt)
    else:
        add_upwind3(coef, f, dt)
    enforce_divfree(coef, a["adv_type"])
    add_isop_file(coef, f, dt)
    add_vmix_file(coef, f, dt)
    self_coef = coef[SELF].copy()
    self_coef += -year_cnt * a["sink_rate"]

    maps = ind_maps(KMT, km)
    int3 = maps["int3_to_ind"]
    wet = wet3d(KMT, km)
    kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt), np.arange(imt),
                             indexing="ij")
    rows, cols, vals, seq = [], [], [], []
    for slot, off in enumerate(offsets):
        dk, dj, di = off
        valid = wet & target_wet(KMT, km, dk, dj, di)
        tgt = int3[np.clip(kk + dk, 0, km - 1), np.clip(jj + dj, 0, jmt - 1),
                   (ii + di) % imt]
        c = self_coef if off == SELF else coef[off]
        rows.append(int3[valid])
        cols.append(tgt[valid])
        vals.append(c[valid])
        seq.append(np.full(int(valid.sum()), slot, dtype=np.int64))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals, seq = np.concatenate(vals), np.concatenate(seq)
    n = maps["tracer_state_len"]
    order = np.lexsort((seq, cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n + cols
    new = np.empty(len(rows), dtype=bool)
    new[0] = True
    np.not_equal(key[1:], key[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    summed = np.add.reduceat(vals, starts)
    keep = summed != 0.0
    nzval = summed[keep]
    colind = cols[starts][keep].astype(np.int64)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rowptr, rows[starts][keep] + 1, 1)
    return dict(nzval=nzval, colind=colind, rowptr=np.cumsum(rowptr),
                **maps)
