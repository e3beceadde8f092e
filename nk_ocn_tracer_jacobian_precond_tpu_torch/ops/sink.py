"""Source/sink and surface-flux term assembly (per-tracer and cross-tracer).

Vectorized rebuild of src/matrix.c:3058-3614:
  add_sink_pure_diag      — const / const_shallow / 3-D rate field sinks
  add_sink_generic_tracer — MARBL-style d_J_X_d_X (+ per-source-level
                            d_J_X_d_X_k_NN within-column) Jacobian fields
  add_sink_coupled_tracers— cross-tracer d_J_A_d_B diagonal blocks
  add_pv                  — piston-velocity surface term
  add_d_SF_d_TRACER       — same-tracer surface-flux derivative
  add_sf_coupled_tracers  — cross-tracer d_SF_A_d_B surface terms
"""

from __future__ import annotations

import numpy as np

from .options import COUPLED_TRACER_NAMES


def _kmax(pt, km: int) -> int:
    """Deepest source level a row may depend on (src/matrix.c:3165-3167)."""
    c = pt.sink_generic_tracer_depends_layer_cnt
    return km - 1 if c == -1 else c - 1


def add_sink_pure_diag(self_coef, grid, opts, tracer_ind, tracer_src) -> None:
    """Rebuild of add_sink_pure_diag (src/matrix.c:3058-3130). Sink rates
    carry units 1/yr and scale by year_cnt (src/matrix.h:41, matrix.c:3078)."""
    pt = opts.per_tracer[tracer_ind]
    yc = opts.year_cnt
    if pt.sink_type in ("none", "generic_tracer"):
        # generic_tracer sinks are handled by add_sink_generic_tracer
        return
    if pt.sink_type == "const":
        self_coef += -yc * pt.sink_rate
    elif pt.sink_type == "const_shallow":
        shallow = (grid.z_t < pt.sink_depth)[:, None, None]
        self_coef += np.where(shallow, -yc * pt.sink_rate, 0.0)
    elif pt.sink_type == "file":
        if tracer_src is None:
            raise ValueError("sink_type=file requires tracer_fname")
        field = tracer_src.get3(pt.sink_field_name)
        self_coef += -yc * field
    else:
        raise ValueError(pt.sink_type)


def add_sink_generic_tracer_diag(self_coef, grid, opts, tracer_ind,
                                 tracer_src) -> None:
    """Same-level d_J_X_d_X part of add_sink_generic_tracer
    (src/matrix.c:3169-3198); optional variable."""
    pt = opts.per_tracer[tracer_ind]
    if pt.sink_type != "generic_tracer":
        return
    name = f"d_J_{pt.sink_generic_tracer_name}_d_{pt.sink_generic_tracer_name}"
    if tracer_src.exists(name):
        self_coef += opts.delta_t * tracer_src.get3(name)


def add_sink_generic_tracer_dense(grid, opts, tracer_ind, tracer_src):
    """Within-column source-level part of add_sink_generic_tracer
    (src/matrix.c:3200-3239). Returns (km2, km, jmt, imt) with entry
    [k2, k] = delta_t * d_J_X_d_X_k_{k2+1}[k,j,i] for k2 <= min(k, kmax),
    or None if the tracer has no generic sink."""
    pt = opts.per_tracer[tracer_ind]
    if pt.sink_type != "generic_tracer":
        return None
    km, jmt, imt = grid.km, grid.jmt, grid.imt
    kmax = _kmax(pt, km)
    dense = np.zeros((km, km, jmt, imt))
    kk = np.arange(km)[:, None, None]
    for k2 in range(kmax + 1):
        name = (f"d_J_{pt.sink_generic_tracer_name}_d_"
                f"{pt.sink_generic_tracer_name}_k_{k2 + 1:02d}")
        if not tracer_src.exists(name):
            continue
        field = tracer_src.get3(name)
        # row k may depend on source level k2 iff k2 <= min(k, kmax)
        row_ok = kk >= k2
        dense[k2] = np.where(row_ok, opts.delta_t * field, 0.0)
    return dense


def sink_dense_row_limit(pt, km: int) -> int:
    """kmax bound for the structural pattern (used by CSR emission)."""
    return _kmax(pt, km)


def add_sink_coupled_tracers(cross, opts, tracer_src) -> None:
    """Rebuild of add_sink_coupled_tracers (src/matrix.c:3273-3383):
    cross[t][t2] += delta_t * d_J_<name_t>_d_<name_t2> (optional fields)."""
    names = COUPLED_TRACER_NAMES.get(opts.coupled_tracer_type)
    if names is None:
        return
    nt = opts.coupled_tracer_cnt
    for t in range(nt):
        for t2 in range(nt):
            if t2 == t:
                continue
            name = f"d_J_{names[t]}_d_{names[t2]}"
            if tracer_src is not None and tracer_src.exists(name):
                cross[(t, t2)] += opts.delta_t * tracer_src.get3(name)


def add_pv(self_coef, grid, opts, tracer_ind, tracer_src) -> None:
    """Rebuild of add_pv (src/matrix.c:3387-3443): subtract the piston
    velocity into the k=0 diagonal, scaled 1/dz[0]*delta_t."""
    pt = opts.per_tracer[tracer_ind]
    if pt.pv_field_name is None:
        return
    if tracer_src is None:
        raise ValueError("pv requires tracer_fname")
    pv = tracer_src.get2(pt.pv_field_name)
    self_coef[0] += -(pv / grid.dz[0] * opts.delta_t)


def add_d_SF_d_TRACER(self_coef, grid, opts, tracer_ind, tracer_src) -> None:
    """Rebuild of add_d_SF_d_TRACER (src/matrix.c:3447-3503)."""
    pt = opts.per_tracer[tracer_ind]
    if pt.d_SF_d_TRACER_field_name is None:
        return
    if tracer_src is None:
        raise ValueError("d_SF_d_TRACER requires tracer_fname")
    dsf = tracer_src.get2(pt.d_SF_d_TRACER_field_name)
    self_coef[0] += dsf / grid.dz[0] * opts.delta_t


def add_sf_coupled_tracers(cross, grid, opts, tracer_src) -> None:
    """Rebuild of add_sf_coupled_tracers (src/matrix.c:3507-3614). Note the
    reference only wires this for DIC_SHADOW_ALK_SHADOW (its switch has no
    PO4_DOP case, matrix.c:3525-3535)."""
    if opts.coupled_tracer_type != "DIC_SHADOW_ALK_SHADOW":
        return
    names = COUPLED_TRACER_NAMES[opts.coupled_tracer_type]
    nt = opts.coupled_tracer_cnt
    for t in range(nt):
        for t2 in range(nt):
            if t2 == t:
                continue
            name = f"d_SF_{names[t]}_d_{names[t2]}"
            if tracer_src is not None and tracer_src.exists(name):
                dsf = tracer_src.get2(name)
                cross[(t, t2)][0] += opts.delta_t * dsf / grid.dz[0]
