"""The Newton-Krylov outer loop: new Jacobian values on a frozen pattern,
numeric refactor, multi-RHS solve, once per Newton iteration.

The port of the JAX package's ``bench.py --nk-loop`` (``bench_nk_loop``,
BASELINE config 5; the reference's reuse path is options.Fact = FACTORED,
solve_ABdist.c:539) and of its problem setup (``SIZES``, the synthetic
circulation of seed 7, bench's assembly options), on a torch device with
the port's own gen_A. Per iteration the stacked coefficient fields of the
first assembly are perturbed multiplicatively on the device and folded
into the canonical values (``ops.device_update``), the factorization is
refactored on the same symbolic plan, and the right-hand sides are solved
to a relative residual of 100 x tol. The same seeds as bench give the same
matrices.

Run as ``python -m nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.nk_loop
[--size gx3] [--iterations 3] [--nrhs 4] [--device cuda|cpu] [--prec f64]
[--cache DIR] [--baseline S]``. It prints a line per iteration on stderr
and bench's JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..grid import gen_ind_maps
from ..grid.grid import load_grid
from ..grid.indmap import load_ind_maps
from ..io.matrixfile import SparseMatrix, read_matrix_file
from ..ops import AssemblyOptions, PerTracerOptions, assemble_jacobian
from ..ops.device_update import StencilUpdatePlan, build_update_plan
from ..ops.fieldsource import FileFieldSource
from ..solver.mf import MultifrontalFactorization
from ..solver.symbolic import symbolic_from_matrix
from ..testdata import make_circ_file
from .gen_a import run_gen_a

SIZES = {
    "tiny": dict(imt=24, jmt=20, km=8),
    "small": dict(imt=48, jmt=40, km=15),
    "gx3": dict(imt=100, jmt=116, km=25),
    "gx3deep": dict(imt=100, jmt=116, km=60),
    "gx1": dict(imt=320, jmt=384, km=60),
}
SEED = 7


def bench_options(circ: str) -> AssemblyOptions:
    """bench.py's assembly options: centered advection, isop_file hmix,
    file vmix, one tracer with a constant sink of 1.21e-4."""
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    return AssemblyOptions(circ_fname=circ, adv_type="centered",
                           hmix_type="isop_file", vmix_type="file",
                           per_tracer=[pt])


def problem_files(dims: dict, work_dir: str) -> tuple[str, str]:
    """The synthetic circulation file of ``dims`` (seed 7) and its gen_A
    matrix file in ``work_dir``, made once and reused: (matrix path, circ
    path)."""
    os.makedirs(work_dir, exist_ok=True)
    tag = "x".join(str(dims[k]) for k in ("imt", "jmt", "km"))
    circ = os.path.join(work_dir, f"circ_{tag}.nc")
    mat = os.path.join(work_dir, f"matrix_{tag}.nc")
    if not os.path.exists(mat):
        if not os.path.exists(circ):
            make_circ_file(circ, seed=SEED, **dims)
        run_gen_a(mat, opts=bench_options(circ))
    return mat, circ


def build_problem(dims: dict, work_dir: str):
    """``problem_files``, read: (matrix, maps, circ path)."""
    mat, circ = problem_files(dims, work_dir)
    return read_matrix_file(mat), load_ind_maps(mat), circ


def residuals(matrix: SparseMatrix, X: np.ndarray,
              B: np.ndarray) -> np.ndarray:
    """The relative residual ||A x - b|| / ||b|| of each column (X, B are
    (n, nrhs)), with A x - b accumulated in extended precision (numpy's
    long double). bench.py's _residual computes it in float64, whose own
    rounding (up to eps * || |A| |x| || / ||b||, 4.8e-10 for one
    right-hand side at gx3deep) can exceed the 1e-10 contract it checks."""
    ld = np.longdouble
    r = (matrix.to_scipy().astype(ld) @ X.astype(ld) - B.astype(ld))
    return (np.linalg.norm(r.astype(np.float64), axis=0)
            / np.linalg.norm(B, axis=0))


def residual(matrix: SparseMatrix, X: np.ndarray, B: np.ndarray) -> float:
    """The largest of ``residuals`` over the columns."""
    return float(np.max(residuals(matrix, X, B)))


@dataclass
class NKLoopResult:
    """One run of the loop: a row per iteration (seconds of the value
    update, refactor and solve, the refactor's host/engine split, the
    residual, the refiner's stats), the one-time costs in seconds (with the
    facade's timings of the cold factor), and the objects and arrays a
    caller checks against (the facade, the update plan and its assembly,
    the stacked fields on the device, and each iteration's new values and
    solutions)."""
    rows: list
    symbolic_s: float
    cold_factor_s: float
    cold_timings: dict
    update_plan_s: float
    factorization: MultifrontalFactorization
    plan: StencilUpdatePlan
    asm: object
    stacked0: torch.Tensor
    nzvals: list
    solutions: list


def run_nk_loop(matrix: SparseMatrix, maps, circ: str, B: np.ndarray,
                n_iter: int, tol: float = 1e-10,
                device: str | torch.device = "cuda",
                precision: str = "f64") -> NKLoopResult:
    """bench.py's bench_nk_loop on ``device`` (cuda by default; cpu only
    when named): symbolic analysis (leaf_size 16), the cold factor at
    ``precision``, the update plan of the assembly of ``circ`` with
    bench's options, then ``n_iter`` iterations of new values
    (multiplicative perturbation 1 + 1e-3 N(0, 1) of the coefficient
    fields, from default_rng(42)), refactor and solve of ``B``."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                    refine_tol=tol, device=dev,
                                    precision=precision)
    t_cold = time.perf_counter() - t0
    cold_timings = dict(fac.timings)
    # the value-update plan, once per pattern like the symbolic phase
    t0 = time.perf_counter()
    grid = load_grid(circ, None)
    asm = assemble_jacobian(grid, bench_options(circ), FileFieldSource(circ),
                            None, gen_ind_maps(np.asarray(grid.KMT), grid.km))
    plan = build_update_plan(asm, matrix)
    stacked0 = torch.from_numpy(plan.stack_fields(asm)).to(dev)
    sync()
    t_plan = time.perf_counter() - t0
    print(f"# nk-loop: symbolic {t_sym:.2f}s (once), cold factor "
          f"{t_cold:.2f}s, update plan {t_plan:.2f}s (once)", file=sys.stderr)
    rows, nzvals, solutions = [], [], []
    rng = np.random.default_rng(42)
    for it in range(1, n_iter + 1):
        # new Jacobian values, same pattern: a multiplicative perturbation
        # of the coefficient fields (zeros stay zeros, signs preserved),
        # drawn and uploaded before the timer; the update's time includes
        # the copy of the new values to the host, where equilibration reads
        # them
        c = torch.from_numpy(1.0 + 1e-3 * rng.standard_normal(plan.total))
        c = c.to(dev)
        sync()
        t0 = time.perf_counter()
        nz = plan.update(stacked0 * c).cpu().numpy()
        t_asm = time.perf_counter() - t0
        m_new = SparseMatrix(nzval=nz, colind=matrix.colind,
                             rowptr=matrix.rowptr,
                             coupled_tracer_cnt=matrix.coupled_tracer_cnt)
        t0 = time.perf_counter()
        fac.refactor(m_new)
        t_fac = time.perf_counter() - t0
        split = {k: fac.timings[k] for k in ("to_scipy", "equilibrate",
                                             "rebind", "factor")}
        prec = fac.engine.prec
        t0 = time.perf_counter()
        X = fac.solve(B)
        t_solve = time.perf_counter() - t0
        res = residual(m_new, X, B)
        # a float32 solve that gave up refactored in float64: later
        # iterations refactor in float64
        escalated = fac.engine.prec != prec
        dtype = str(fac.engine.prec).removeprefix("torch.")
        rows.append(dict(it=it, assemble=t_asm, refactor=t_fac,
                         solve=t_solve, residual=res,
                         refactor_split=split, factor_dtype=dtype,
                         escalated=escalated,
                         refiner=dict(fac._refiner.stats)))
        nzvals.append(nz)
        solutions.append(X)
        print(f"# it {it}: assemble {t_asm:.3f}s refactor {t_fac:.3f}s "
              f"(engine {split['factor']:.3f}s) solve {t_solve:.3f}s "
              f"residual {res:.2e}, {dtype} factors"
              + (" (escalated)" if escalated else ""), file=sys.stderr)
    return NKLoopResult(rows=rows, symbolic_s=t_sym, cold_factor_s=t_cold,
                        cold_timings=cold_timings, update_plan_s=t_plan, factorization=fac, plan=plan,
                        asm=asm, stacked0=stacked0, nzvals=nzvals,
                        solutions=solutions)


def summary(result: NKLoopResult, nrhs: int, size: str,
            baseline_s: float | None = None) -> dict:
    """bench.py's JSON line: the mean iteration (assemble + refactor +
    solve) after the first, the rows, the one-time costs; ``vs_baseline``
    only when a baseline time per iteration is given."""
    rows = result.rows
    steady = rows[1:] if len(rows) > 1 else rows
    per_it = float(np.mean([r["assemble"] + r["refactor"] + r["solve"]
                            for r in steady]))
    ok = all(r["residual"] <= 1e-10 for r in rows)
    out = {
        "metric": f"NK outer-loop per-iteration cost (assemble+refactor+"
                  f"{nrhs}-rhs solve), {size} grid"
                  + ("" if ok else " [RESIDUAL NOT MET]"),
        "value": round(per_it, 4), "unit": "s",
        "iterations": rows,
        "symbolic_s_once": round(result.symbolic_s, 2),
        "cold_factor_s_once": round(result.cold_factor_s, 2),
    }
    if baseline_s:
        out["vs_baseline"] = round(baseline_s / per_it, 3)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="nk_loop",
        description="Newton-Krylov outer loop: new values on the same "
                    "pattern, refactor, multi-RHS solve, per iteration")
    p.add_argument("--size", default="gx3", choices=list(SIZES))
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--nrhs", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu when named)")
    p.add_argument("--prec", default="f64", choices=["f64", "f32", "auto"])
    p.add_argument("--cache", default=None,
                   help="directory for the circulation and matrix files "
                        "(reused when present; default: a temporary one)")
    p.add_argument("--baseline", type=float, default=None, metavar="S",
                   help="seconds of a baseline iteration, for vs_baseline")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="nk_loop_") as tmp:
        matrix, maps, circ = build_problem(SIZES[args.size],
                                           args.cache or tmp)
        B = np.random.default_rng(0).standard_normal(
            (matrix.flat_len, args.nrhs))
        print(f"# problem {args.size}: flat_len={matrix.flat_len} "
              f"nnz={matrix.nnz}", file=sys.stderr)
        result = run_nk_loop(matrix, maps, circ, B, args.iterations,
                             tol=args.tol, device=args.device,
                             precision=args.prec)
    print(json.dumps(summary(result, args.nrhs, args.size, args.baseline),
                     default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
