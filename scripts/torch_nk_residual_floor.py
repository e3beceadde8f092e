#!/usr/bin/env python3
"""Where float64 refinement stops in the NK loop: the SpMV's own rounding.

Runs drivers.nk_loop.run_nk_loop (bench.py's seeds) and, for each
iteration's matrix, reports per right-hand side: the residual of the
loop's solution computed in float64 and in long double, and the float64
SpMV's rounding bound eps * || |A| |x| || / ||b||. Then, from that
iteration's unrefined solve, it runs plain refinement twice: with float64
host residuals and with long-double ones, each step's correction from the
same factors, and prints each step's residual as float64 and long double
measure it. Where the rounding bound exceeds the target, float64 steps
stall on noise while long-double ones go on.

    python3 scripts/torch_nk_residual_floor.py [--size gx3deep]
        [--iterations 3] [--steps 4] [--device cuda] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop  # noqa: E402
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (  # noqa: E402
    SparseMatrix)

LD = np.longdouble
EPS = float(np.finfo(np.float64).eps)


def rels(A, X, B, ld: bool) -> list:
    """||A x - b|| / ||b|| per column, accumulated in float64 or long
    double."""
    if ld:
        R = (A.astype(LD) @ X.astype(LD) - B.astype(LD)).astype(np.float64)
    else:
        R = A @ X - B
    return (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).tolist()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", default="gx3deep", choices=list(nk_loop.SIZES))
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="nk_floor_") as tmp:
        matrix, maps, circ = nk_loop.build_problem(nk_loop.SIZES[args.size],
                                                   tmp)
        B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
        # one loop per iteration count, so each iteration's factors are
        # the facade's when it is examined
        report = []
        for n in range(1, args.iterations + 1):
            res = nk_loop.run_nk_loop(matrix, maps, circ, B, n,
                                      device=args.device)
            m = SparseMatrix(nzval=res.nzvals[-1], colind=matrix.colind,
                             rowptr=matrix.rowptr,
                             coupled_tracer_cnt=matrix.coupled_tracer_cnt)
            A = m.to_scipy().tocsr()
            X = res.solutions[-1]
            bound = (EPS * np.linalg.norm(abs(A) @ abs(X), axis=0)
                     / np.linalg.norm(B, axis=0))
            row = dict(it=n, loop_rel_f64=rels(A, X, B, False),
                       loop_rel_ld=rels(A, X, B, True),
                       rounding_bound=bound.tolist(),
                       x_over_b=(np.linalg.norm(X, axis=0)
                                 / np.linalg.norm(B, axis=0)).tolist(),
                       refiner=res.rows[-1]["refiner"])
            fac = res.factorization
            X0 = fac.solve(B, refine=False)
            for ld in (False, True):
                Xi, steps = X0.copy(), []
                for _ in range(args.steps):
                    if ld:
                        R = (B.astype(LD) - A.astype(LD) @ Xi.astype(LD)
                             ).astype(np.float64)
                    else:
                        R = B - A @ Xi
                    Xi = Xi + fac.solve(R, refine=False)
                    steps.append(dict(f64=max(rels(A, Xi, B, False)),
                                      ld=max(rels(A, Xi, B, True))))
                row["ir_" + ("ld" if ld else "f64")] = steps
            report.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
