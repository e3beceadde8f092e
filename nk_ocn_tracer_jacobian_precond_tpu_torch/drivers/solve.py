"""solve driver: factor the matrix once, solve per tracer variable in place.

The port of the JAX package's ``drivers/solve.py`` on a torch device: read
the gen_A matrix file, factor it once, then for each comma-separated
variable group read the tracer field(s) from the inout file, flatten them
through the index maps, solve, scatter back preserving land values and
write in place. ``--prec`` picks the factor precision (f64, the default;
f32; or auto, f32 on the card), the explicit form of the JAX package's
NK_PREC. The distributed options (``-n`` above 1,
``--rhs-devices``), factor files (``--factors``) and ``--memplan`` are not
yet ported: they exit with status 1.

Run as ``python -m nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve
[-D lvl] [--device cuda|cpu] [--prec f64|f32|auto] -v VARS matrix.nc
tracer.nc``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..grid.indmap import load_ind_maps
from ..io import fields, netcdf3
from ..io.matrixfile import read_matrix_file
from ..solver.api import factor, residual_norm
from ..utils import dbg, set_dbg_lvl, timed

NOT_PORTED = "not yet ported to the torch package"


def parse_var_groups(vars_arg: str, coupled_tracer_cnt: int) -> list[list[str]]:
    """Split the comma-separated -v list into groups of coupled_tracer_cnt."""
    names = [v for v in vars_arg.split(",") if v]
    if len(names) % coupled_tracer_cnt:
        raise ValueError(
            f"number of vars ({len(names)}) not a multiple of "
            f"coupled_tracer_cnt ({coupled_tracer_cnt})")
    return [names[i:i + coupled_tracer_cnt]
            for i in range(0, len(names), coupled_tracer_cnt)]


def run_solve(matrix_fname: str, inout_fname: str, vars_arg: str,
              backend: str = "auto", dbg_lvl: int = 0, rhs_chunk: int = 32,
              device: str | torch.device = "cuda",
              precision: str = "f64") -> dict:
    """Factor, solve every variable group and write the results in place.
    Returns {"residuals": {group: rel residual}, "groups": [...],
    "factorization": the factorization object}."""
    set_dbg_lvl(dbg_lvl)
    with timed("get_sparse_matrix"):
        matrix = read_matrix_file(matrix_fname)
    maps = load_ind_maps(matrix_fname)
    tsl = maps.tracer_state_len
    nt = matrix.coupled_tracer_cnt
    if matrix.flat_len != nt * tsl:
        raise ValueError("matrix flat_len inconsistent with index maps")

    groups = parse_var_groups(vars_arg, nt)

    kwargs = ({} if backend == "scipy" else
              {"maps": maps, "device": device, "precision": precision})
    with timed("factor"):
        fac = factor(matrix, backend=backend, **kwargs)

    # stream the RHS groups through the solver rhs_chunk at a time: host
    # and device RHS memory stay O(flat_len * rhs_chunk), and each chunk is
    # written back before the next is read
    results = {"residuals": {}, "groups": groups, "factorization": fac}
    hdr = netcdf3.read_header(inout_fname)
    chunk = max(1, rhs_chunk)
    for lo in range(0, len(groups), chunk):
        gchunk = groups[lo:lo + chunk]
        fields_3d = {}
        B = np.empty((matrix.flat_len, len(gchunk)))
        for g, group in enumerate(gchunk):
            for t, var in enumerate(group):
                dbg(1, f"reading {var} from {inout_fname}")
                f3 = fields.get_var_double(inout_fname, var, 3, hdr)
                fields_3d[var] = f3
                B[t * tsl:(t + 1) * tsl, g] = maps.flatten_field(f3)

        with timed("solve"):
            X = fac.solve(B)
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]

        for g, group in enumerate(gchunk):
            res = residual_norm(matrix, X[:, g], B[:, g])
            results["residuals"][",".join(group)] = res
            dbg(1, f"relative residual for {group}: {res:.3e}")
            for t, var in enumerate(group):
                f3 = maps.unflatten_into(fields_3d[var],
                                         X[t * tsl:(t + 1) * tsl, g])
                dbg(1, f"writing {var} to {inout_fname}")
                fields.put_var_inplace(inout_fname, var, f3)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="solve",
        description="solve the Jacobian preconditioner systems for tracer "
                    "variables, updating the inout file in place")
    p.add_argument("-D", dest="dbg_lvl", type=int, default=0)
    p.add_argument("-n", dest="npgrid", default=None,
                   help="nprow[,npcol] (reference compatibility; only a "
                        "single device is ported)")
    p.add_argument("-v", dest="vars", default=None,
                   help="comma-separated tracer variable names")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "scipy", "multifrontal"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the multifrontal backend (cuda, "
                        "or cpu when named)")
    p.add_argument("--prec", default="f64", choices=["f64", "f32", "auto"],
                   help="factor precision of the multifrontal backend "
                        "(auto: f32 on cuda, escalating to f64 when "
                        "refinement fails; f64 on cpu)")
    p.add_argument("--memplan", action="store_true",
                   help="print the per-device memory plan (" + NOT_PORTED
                        + ")")
    p.add_argument("--rhs-chunk", type=int, default=32,
                   help="stream tracer RHS groups through the solver this "
                        "many at a time")
    p.add_argument("--rhs-devices", type=int, default=1,
                   help="devices of an rhs mesh axis (" + NOT_PORTED + ")")
    p.add_argument("--factors", dest="factors_fname", default=None,
                   help="numeric-factor checkpoint file (" + NOT_PORTED
                        + ")")
    p.add_argument("matrix_fname")
    p.add_argument("inout_fname", nargs="?", default=None)
    args = p.parse_args(argv)
    n_devices = 1
    if args.npgrid:
        parts = [int(x) for x in args.npgrid.split(",")]
        n_devices = parts[0] * (parts[1] if len(parts) > 1 else parts[0])
    unported = [flag for flag, used in (
        (f"-n {args.npgrid}", n_devices > 1),
        ("--rhs-devices", args.rhs_devices != 1),
        ("--factors", args.factors_fname is not None),
        ("--memplan", args.memplan)) if used]
    if unported:
        print(f"solve: {', '.join(unported)}: {NOT_PORTED}",
              file=sys.stderr)
        return 1
    if not args.vars or args.inout_fname is None:
        print("solve: -v VARS and inout_fname are required",
              file=sys.stderr)
        return 2
    try:
        run_solve(args.matrix_fname, args.inout_fname, args.vars,
                  backend=args.backend, dbg_lvl=args.dbg_lvl,
                  rhs_chunk=args.rhs_chunk, device=args.device,
                  precision=args.prec)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"solve: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
