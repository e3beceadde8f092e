"""solve driver: factor the matrix once, solve per tracer variable in place.

The port of the JAX package's ``drivers/solve.py`` on a torch device: read
the gen_A matrix file, factor it once, then for each comma-separated
variable group read the tracer field(s) from the inout file, flatten them
through the index maps, solve, scatter back preserving land values and
write in place. ``--prec`` picks the factor precision (f64, the default;
f32; or auto, f32 on the card), the explicit form of the JAX package's
NK_PREC. ``--factors FILE`` loads the numeric factors from FILE when it
matches the matrix (no numeric factorization) and writes them there
otherwise. ``--memplan`` prints the memory plan of the factorization for
``-n``'s device count at the ``--prec`` dtype and exits, on the host
alone: the JAX CLI's lines, whose transient model counts fused
programs; the port's eager temporaries are counted per round by
``memplan.engine_round_peaks``.

``-n nprow[,npcol]`` (npcol defaults to nprow, as in the reference's
solve_ABdist) runs the distributed mode on nprow * npcol ranks, which the
CLI starts itself (torch.multiprocessing, meeting through a file store in
a temporary directory): with ``--device cuda`` one rank per card over
NCCL, exiting 1 with "requested N devices, have M" when there are fewer
cards; with ``--device cpu`` gloo ranks. ``--rhs-devices r`` gives the
mesh an "rhs" axis of r ranks (r divides the rank count), over which the
right-hand-side columns of each solve split. Every rank reads the matrix
file; the first alone reads and writes the tracer file.

Run as ``python -m nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve
[-D lvl] [-n nprow[,npcol]] [--rhs-devices r] [--device cuda|cpu]
[--prec f64|f32|auto] [--factors FILE] -v VARS matrix.nc tracer.nc``, or
with ``--memplan [-n N] matrix.nc``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_precision
from ..grid.indmap import load_ind_maps
from ..io import fields, netcdf3
from ..io.matrixfile import read_matrix_file
from ..parallel import collectives as coll
from ..parallel.mesh import run_world
from ..solver.api import factor, residual_norm
from ..solver.memplan import plan_memory
from ..solver.plan import build_plan
from ..solver.symbolic import symbolic_from_matrix
from ..utils import dbg, set_dbg_lvl, timed


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
              precision: str = "f64",
              factors_fname: str | None = None,
              n_devices: int | None = None, rhs_devices: int = 1) -> dict:
    """Factor (or load the factors of ``factors_fname``, see main), solve
    every variable group and write the results in place. Returns
    {"residuals": {group: rel residual}, "groups": [...], "factorization":
    the factorization object}.

    With ``n_devices`` above 1 this is one rank of the distributed mode:
    every rank of the default process group calls it with the same
    arguments (``main`` starts them). The first rank reads each chunk of
    the tracer file and sends it to the others, every rank solves, and the
    first rank writes the results and alone reports residuals."""
    set_dbg_lvl(dbg_lvl)
    dist_mode = n_devices is not None and n_devices > 1
    with timed("get_sparse_matrix"):
        matrix = read_matrix_file(matrix_fname)
    maps = load_ind_maps(matrix_fname)
    tsl = maps.tracer_state_len
    nt = matrix.coupled_tracer_cnt
    if matrix.flat_len != nt * tsl:
        raise ValueError("matrix flat_len inconsistent with index maps")

    groups = parse_var_groups(vars_arg, nt)

    if dist_mode and backend == "scipy":
        raise ValueError("the distributed mode (-n) needs the multifrontal "
                         "backend")
    kwargs = ({} if backend == "scipy" else
              {"maps": maps, "device": device, "precision": precision,
               "numeric_checkpoint": factors_fname})
    if dist_mode:
        kwargs.update(n_devices=n_devices, rhs_devices=rhs_devices)
    with timed("factor"):
        fac = factor(matrix, backend=backend, **kwargs)
    first = not dist_mode or dist.get_rank() == 0

    # stream the RHS groups through the solver rhs_chunk at a time: host
    # and device RHS memory stay O(flat_len * rhs_chunk), and each chunk is
    # written back before the next is read
    results = {"residuals": {}, "groups": groups, "factorization": fac}
    hdr = netcdf3.read_header(inout_fname) if first else None
    chunk = max(1, rhs_chunk)
    for lo in range(0, len(groups), chunk):
        gchunk = groups[lo:lo + chunk]
        fields_3d = {}
        B = np.empty((matrix.flat_len, len(gchunk)))
        if first:
            for g, group in enumerate(gchunk):
                for t, var in enumerate(group):
                    dbg(1, f"reading {var} from {inout_fname}")
                    f3 = fields.get_var_double(inout_fname, var, 3, hdr)
                    fields_3d[var] = f3
                    B[t * tsl:(t + 1) * tsl, g] = maps.flatten_field(f3)
        if dist_mode:
            B = coll.broadcast(torch.from_numpy(B).to(fac.device), 0,
                               None).cpu().numpy()

        with timed("solve"):
            X = fac.solve(B)
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        if not first:
            continue

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


def run_memplan(matrix_fname: str, n_devices: int, dbg_lvl: int = 0,
                precision: str = "f64",
                device: str | torch.device = "cuda") -> int:
    """Pre-flight sizing on the host: symbolic analysis, round plans
    (batch multiple ``n_devices``) and the exact padded-shape memory walk,
    no factorization, at the factor dtype ``precision`` gives on
    ``device`` (which is not touched). Prints the JAX driver's lines."""
    set_dbg_lvl(dbg_lvl)
    matrix = read_matrix_file(matrix_fname)
    maps = load_ind_maps(matrix_fname)
    with timed("symbolic analysis"):
        sym = symbolic_from_matrix(maps, matrix)
    with timed("round plans"):
        plans = build_plan(sym, matrix, batch_multiple=n_devices)
    dtype = resolve_precision(precision, torch.device(device))
    mp = plan_memory(plans, n_devices=n_devices,
                     bytes_per_elem=dtype.itemsize)
    gb = 1 / 2 ** 30
    print(f"matrix: flat_len={matrix.flat_len} nnz={matrix.nnz} "
          f"fronts={len(sym.fronts)} max_front={sym.max_front} "
          f"factor_flops={sym.factor_flops():.3e}")
    print(f"memory plan ({n_devices} device(s), "
          f"{str(dtype).removeprefix('torch.')} factors):")
    print(f"  factors resident: {mp.factor_bytes_total * gb:.2f} GB total, "
          f"{mp.factor_bytes_per_device * gb:.2f} GB/device")
    print(f"  Schur live peak:  {mp.schur_peak_per_device * gb:.2f} GB/device")
    print(f"  transient peak:   {mp.transient_peak_per_device * gb:.2f} GB/device")
    print(f"  peak per device:  {mp.peak_per_device * gb:.2f} GB")
    return 0


def n_ranks(npgrid: str | None) -> int:
    """The rank count of ``-n nprow[,npcol]`` (npcol defaults to nprow, as
    in the reference's solve_ABdist); 1 without it."""
    if not npgrid:
        return 1
    parts = [int(x) for x in npgrid.split(",")]
    return parts[0] * (parts[1] if len(parts) > 1 else parts[0])


def _solve_rank(device: torch.device, kwargs: dict) -> None:
    """One rank of the distributed mode (parallel.mesh.run_world)."""
    run_solve(device=device, **kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="solve",
        description="solve the Jacobian preconditioner systems for tracer "
                    "variables, updating the inout file in place")
    p.add_argument("-D", dest="dbg_lvl", type=int, default=0)
    p.add_argument("-n", dest="npgrid", default=None,
                   help="nprow[,npcol] (npcol defaults to nprow): run on "
                        "nprow * npcol ranks, one per card on cuda (gloo "
                        "ranks on cpu), or size --memplan's plan for them")
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
                   help="print the per-device memory plan for this matrix, "
                        "-n's device count and --prec's dtype, then exit "
                        "(host only, no factorization; the JAX engine's "
                        "plan, which undercounts this engine's temporaries: "
                        "see memplan.engine_round_peaks)")
    p.add_argument("--rhs-chunk", type=int, default=32,
                   help="stream tracer RHS groups through the solver this "
                        "many at a time")
    p.add_argument("--rhs-devices", type=int, default=1,
                   help="ranks of the mesh's rhs axis, over which the "
                        "right-hand sides of each solve split")
    p.add_argument("--factors", dest="factors_fname", default=None,
                   help="numeric-factor file: loaded (skipping the numeric "
                        "factorization) when it exists and matches this "
                        "matrix's values, else written after factoring "
                        "(multifrontal backend)")
    p.add_argument("matrix_fname")
    p.add_argument("inout_fname", nargs="?", default=None)
    args = p.parse_args(argv)
    n_devices = n_ranks(args.npgrid)
    try:
        if args.memplan:
            return run_memplan(args.matrix_fname, n_devices,
                               dbg_lvl=args.dbg_lvl, precision=args.prec,
                               device=args.device)
        if not args.vars or args.inout_fname is None:
            print("solve: -v VARS and inout_fname are required (unless "
                  "--memplan)", file=sys.stderr)
            return 2
        kwargs = dict(matrix_fname=args.matrix_fname,
                      inout_fname=args.inout_fname, vars_arg=args.vars,
                      backend=args.backend, dbg_lvl=args.dbg_lvl,
                      rhs_chunk=args.rhs_chunk, precision=args.prec,
                      factors_fname=args.factors_fname)
        if n_devices > 1:
            # one rank per card on cuda (ValueError "requested N devices,
            # have M" when there are fewer), gloo ranks on cpu
            run_world(_solve_rank, n_devices, args.device,
                      dict(kwargs, n_devices=n_devices,
                           rhs_devices=args.rhs_devices))
        elif args.rhs_devices != 1:
            raise ValueError(f"rhs_devices={args.rhs_devices} must divide "
                             f"n_devices=1")
        else:
            run_solve(device=args.device, **kwargs)
    except torch.multiprocessing.ProcessRaisedException as e:
        # the failing rank's traceback ends with its exception
        print(f"solve: {str(e).strip().splitlines()[-1]}", file=sys.stderr)
        return 1
    except torch.multiprocessing.ProcessExitedException as e:
        print(f"solve: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"solve: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
