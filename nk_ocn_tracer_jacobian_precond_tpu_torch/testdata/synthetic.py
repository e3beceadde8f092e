"""Synthetic POP-like circulation / tracer / region files.

The reference has no test fixtures at all — its smoke scripts point at real
POP history files on an NCAR filesystem (reference: test/test_gen_A.csh:15).
This module generates deterministic NetCDF files with the same variable
names, shapes and _FillValue conventions as POP annual-mean output, at any
resolution, so the whole toolchain is testable and benchmarkable anywhere.

Field inventory mirrors everything matrix.c reads:
  grid: z_t dz TLONG TLAT KMT TAREA  (src/grid.c:104-205)
  adv (donor/centered): UVEL DYU VVEL DXU WVEL  (src/matrix.c:1012-1177)
  adv (upwind3): UTE_POS UTE_NEG VTN_POS VTN_NEG WTK_POS WTK_NEG
    (src/matrix.c:1454-1573)
  hmix hor_file: KAPPA_ISOP HOR_DIFF HUS HTE HUW HTN UISOP VISOP WISOP
    (src/matrix.c:1033-1049, 2418-2479)
  hmix isop_file: HDIF_EXPLICIT_3D_IRF_{1..4}_{1..3}_{1..3}
    (src/matrix.c:2233-2260)
  vmix file: VDC_S VDC_GM  (src/matrix.c:2869-2885)
  vmix matrix_file: vmix_matrix_%03d_CUR  (src/matrix.c:2799-2803)
"""

from __future__ import annotations

import numpy as np

from ..io import netcdf3

FV = 9.96921e36  # POP's default _FillValue


def make_synthetic_grid(imt: int, jmt: int, km: int, seed: int = 0):
    """Deterministic bathymetry + metrics. Returns a dict of arrays."""
    rng = np.random.default_rng(seed)

    # depth axis: thickening layers like POP's
    dz = 1000.0 * (1.0 + 0.15 * np.arange(km))          # cm
    z_t = np.cumsum(dz) - 0.5 * dz

    jj, ii = np.meshgrid(np.arange(jmt), np.arange(imt), indexing="ij")
    TLONG = 360.0 * ii / imt
    TLAT = -80.0 + 160.0 * (jj + 0.5) / jmt

    # bathymetry: smooth random depth field with land rows at both poles,
    # some interior land (continents), occasional shallow shelves
    depth = rng.uniform(0, km + 3, size=(jmt, imt))
    for _ in range(3):  # smooth
        depth = 0.5 * depth + 0.125 * (
            np.roll(depth, 1, 1) + np.roll(depth, -1, 1)
            + np.vstack([depth[:1], depth[:-1]]) + np.vstack([depth[1:], depth[-1:]]))
    KMT = np.clip(depth.astype(np.int64), 0, km)
    KMT[depth < 1.2] = 0
    KMT[0, :] = 0
    KMT[-1, :] = 0
    if (KMT > 0).sum() < max(4, imt * jmt // 8):
        KMT[1:-1] = np.maximum(KMT[1:-1], 1 + (ii[1:-1] + jj[1:-1]) % min(km, 3))

    # metric terms: mildly varying positive fields (cm, cm^2)
    base_dx = 5.0e7 / imt
    base_dy = 4.0e7 / jmt
    lat_fac = np.maximum(np.cos(np.deg2rad(TLAT)), 0.2)
    HTN = base_dx * lat_fac * (1 + 0.05 * np.sin(2 * np.pi * ii / imt))
    HTE = base_dy * (1 + 0.05 * np.cos(2 * np.pi * jj / jmt))
    HUS = base_dx * lat_fac * (1 + 0.04 * np.cos(2 * np.pi * ii / imt))
    HUW = base_dy * (1 + 0.04 * np.sin(2 * np.pi * jj / jmt))
    DXU = HTN * 1.01
    DYU = HTE * 0.99
    TAREA = HTN * HTE

    return dict(z_t=z_t, dz=dz, TLONG=TLONG, TLAT=TLAT, KMT=KMT,
                TAREA=TAREA, HTN=HTN, HTE=HTE, HUS=HUS, HUW=HUW,
                DXU=DXU, DYU=DYU)


def _wet3d(KMT, km):
    return np.arange(km)[:, None, None] < KMT[None, :, :]


def _masked(field, mask):
    """Apply FV on non-wet cells (as POP writes output)."""
    return np.where(mask, field, FV)


def make_circ_file(path: str, imt: int = 16, jmt: int = 12, km: int = 5,
                   seed: int = 0, with_time_dim: bool = False) -> dict:
    """Write a synthetic circulation (POP annual-mean-like) file.

    Returns the raw (unmasked) field dict for test oracles.
    """
    g = make_synthetic_grid(imt, jmt, km, seed)
    rng = np.random.default_rng(seed + 1)
    KMT, km_ = g["KMT"], km
    wetT = _wet3d(KMT, km)
    from ..grid.grid import derive_kmu
    KMU = derive_kmu(KMT)
    wetU = _wet3d(KMU, km)

    def rand3(scale=1.0):
        return scale * rng.standard_normal((km, jmt, imt))

    # velocities (cm/s); moderate magnitudes
    UVEL = rand3(5.0)
    VVEL = rand3(5.0)
    WVEL = rand3(1e-3)
    UISOP = rand3(0.5)
    VISOP = rand3(0.5)
    WISOP = rand3(1e-4)

    # upwind3 precomputed face transports: POS >= 0, NEG <= 0 (cm^3/s)
    def pos_neg(scale):
        t = scale * rng.standard_normal((km, jmt, imt))
        return np.maximum(t, 0.0), np.minimum(t, 0.0)

    UTE_POS, UTE_NEG = pos_neg(3.0e10)
    VTN_POS, VTN_NEG = pos_neg(3.0e10)
    WTK_POS, WTK_NEG = pos_neg(2.0e4)

    KAPPA_ISOP = np.abs(rand3(3.0e7))
    HOR_DIFF = np.abs(rand3(1.0e7))
    VDC_S = np.abs(rand3(0.5))
    VDC_GM = np.abs(rand3(0.3))

    raw = dict(g)
    raw.update(UVEL=UVEL, VVEL=VVEL, WVEL=WVEL, UISOP=UISOP, VISOP=VISOP,
               WISOP=WISOP, UTE_POS=UTE_POS, UTE_NEG=UTE_NEG,
               VTN_POS=VTN_POS, VTN_NEG=VTN_NEG, WTK_POS=WTK_POS,
               WTK_NEG=WTK_NEG, KAPPA_ISOP=KAPPA_ISOP, HOR_DIFF=HOR_DIFF,
               VDC_S=VDC_S, VDC_GM=VDC_GM, KMU=KMU)

    # IRF fields: one per (iprime, jprime, kprime) coloring class
    irf = {}
    for ip in range(4):
        for jp in range(3):
            for kp in range(3):
                name = f"HDIF_EXPLICIT_3D_IRF_{ip + 1}_{jp + 1}_{kp + 1}"
                irf[name] = rand3(1e-7)
    raw.update(irf)

    # per-level vmix matrix fields (dense within-column coupling)
    vmix_mat = {}
    for kp in range(km):
        vmix_mat[f"vmix_matrix_{kp + 1:03d}_CUR"] = rand3(1e-8)
    raw.update(vmix_mat)

    tdim = ("time",) if with_time_dim else ()
    dims = ([("time", 0)] if with_time_dim else []) + [
        ("nlon", imt), ("nlat", jmt), ("z_t", km)]

    def v3(name, data, mask):
        d = _masked(data, mask)
        if with_time_dim:
            d = d[None]
        return (name, tdim + ("z_t", "nlat", "nlon"), {"_FillValue": FV}, d)

    def v2(name, data, mask=None):
        d = data if mask is None else _masked(data, mask)
        atts = {"_FillValue": FV} if mask is not None else {"_FillValue": FV}
        return (name, ("nlat", "nlon"), atts, d)

    wet2 = KMT > 0
    wetU2 = KMU > 0
    variables = [
        ("z_t", ("z_t",), {"units": "centimeters", "positive": "down"}, g["z_t"]),
        ("dz", ("z_t",), {"units": "centimeters"}, g["dz"]),
        ("TLONG", ("nlat", "nlon"), {"units": "degrees_east"}, g["TLONG"]),
        ("TLAT", ("nlat", "nlon"), {"units": "degrees_north"}, g["TLAT"]),
        ("KMT", ("nlat", "nlon"), {}, KMT.astype(np.int32)),
        v2("TAREA", g["TAREA"]),
        v2("DXU", g["DXU"], wetU2),
        v2("DYU", g["DYU"], wetU2),
        v2("HTN", g["HTN"], wet2),
        v2("HTE", g["HTE"], wet2),
        v2("HUS", g["HUS"], wet2),
        v2("HUW", g["HUW"], wet2),
        v3("UVEL", UVEL, wetU),
        v3("VVEL", VVEL, wetU),
        v3("WVEL", WVEL, wetT),
        v3("UISOP", UISOP, wetT),
        v3("VISOP", VISOP, wetT),
        v3("WISOP", WISOP, wetT),
        v3("UTE_POS", UTE_POS, wetT),
        v3("UTE_NEG", UTE_NEG, wetT),
        v3("VTN_POS", VTN_POS, wetT),
        v3("VTN_NEG", VTN_NEG, wetT),
        v3("WTK_POS", WTK_POS, wetT),
        v3("WTK_NEG", WTK_NEG, wetT),
        v3("KAPPA_ISOP", KAPPA_ISOP, wetT),
        v3("HOR_DIFF", HOR_DIFF, wetT),
        v3("VDC_S", VDC_S, wetT),
        v3("VDC_GM", VDC_GM, wetT),
    ]
    for name, data in irf.items():
        variables.append(v3(name, data, wetT))
    for name, data in vmix_mat.items():
        variables.append(v3(name, data, wetT))

    netcdf3.write(path, dims, variables, version=2)
    return raw


def make_region_file(path: str, imt: int, jmt: int, seed: int = 0,
                     ignore_frac: float = 0.1) -> np.ndarray:
    """Write a DYN_REGMASK region file; negative entries are ignored regions
    (src/grid.c:148-160)."""
    rng = np.random.default_rng(seed + 7)
    mask = np.ones((jmt, imt), dtype=np.int32)
    ignore = rng.random((jmt, imt)) < ignore_frac
    mask[ignore] = -1
    netcdf3.write(path, [("nlon", imt), ("nlat", jmt)],
                  [("DYN_REGMASK", ("nlat", "nlon"), {}, mask)])
    return mask


def make_tracer_file(path: str, imt: int, jmt: int, km: int,
                     tracer_names=("IAGE_CUR",), seed: int = 0,
                     generic_tracer_names=(), coupled_names=(),
                     pv_names=(), sf_names=(), sink_field_names=(),
                     depends_layer_cnt: int | None = None,
                     with_time_dim: bool = False) -> dict:
    """Write a synthetic tracer (function-evaluation) file.

    Contains the tracer state variables the solvers read/write in place
    (src/solve_ABglobal.c:153-267) plus optional derivative fields used by
    the sink/surface-flux assembly passes:
      d_J_X_d_X, d_J_X_d_X_k_NN  (src/matrix.c:3176-3226)
      d_J_A_d_B                  (src/matrix.c:3326)
      d_SF_A_d_B                 (src/matrix.c:3557)
      pv / d_SF_d_TRACER 2-D fields (src/matrix.c:3416, 3476)
    """
    rng = np.random.default_rng(seed + 13)
    raw = {}
    variables = []
    tdim = ("time",) if with_time_dim else ()
    dims = ([("time", 0)] if with_time_dim else []) + [
        ("nlon", imt), ("nlat", jmt), ("z_t", km)]

    def add3(name, scale=1.0):
        data = scale * rng.standard_normal((km, jmt, imt))
        raw[name] = data
        variables.append((name, tdim + ("z_t", "nlat", "nlon"),
                          {"_FillValue": FV}, data[None] if with_time_dim else data))

    def add2(name, scale=1.0):
        data = scale * rng.standard_normal((jmt, imt))
        raw[name] = data
        variables.append((name, ("nlat", "nlon"), {"_FillValue": FV}, data))

    for name in tracer_names:
        add3(name)
    for name in sink_field_names:
        add3(name, 0.05)
    for name in generic_tracer_names:
        add3(f"d_J_{name}_d_{name}", 1e-8)
        kmax = (km - 1) if depends_layer_cnt is None else depends_layer_cnt - 1
        for k2 in range(kmax + 1):
            # leave one level's field absent to exercise the missing-var path
            if k2 == 1 and kmax >= 2:
                continue
            add3(f"d_J_{name}_d_{name}_k_{k2 + 1:02d}", 1e-8)
    for a, b in coupled_names:
        add3(f"d_J_{a}_d_{b}", 1e-8)
    for a, b in sf_names:
        add2(f"d_SF_{a}_d_{b}", 1e-3)
    for name in pv_names:
        add2(name, 1e-3)

    netcdf3.write(path, dims, variables, version=2)
    return raw
