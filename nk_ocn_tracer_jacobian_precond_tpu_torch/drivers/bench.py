"""Benchmark: Jacobian factor + multi-RHS preconditioner solve, on a torch
device, against scipy's sequential SuperLU on the same host.

The port of the JAX package's ``bench.py`` main path (``bench_scipy``,
``bench_mf`` and main's JSON line) with the port's own gen_A problems
(``nk_loop``'s ``SIZES``, ``build_problem`` and ``residual``): LU-factor
the assembled ocean-tracer Jacobian, then solve ``--nrhs`` right-hand
sides (default_rng(0)) reusing the factorization, to a relative residual
of at most 1e-10. The baseline is scipy's ``splu`` (the port's
``api.ScipyFactorization``, refined to ``--tol``) on the identical matrix,
measured on the host that runs the benchmark. The device path runs bench's
steps in bench's order: symbolic analysis (leaf_size 16), the cold facade
(equilibration, plans, first numeric factor), a steady ``refactor()`` (the
Newton-iteration reuse path), a warm-up solve and the timed solve. Every
timer stops after ``torch.cuda.synchronize()`` on a card.

Residuals are computed in long double (``nk_loop.residual``): bench.py's
``_residual`` computes A x - b in float64, whose own rounding reaches
4.8e-10 on one gx3deep right-hand side, above the contract it checks.

Run as ``python -m nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.bench
[--size gx3] [--nrhs 4] [--tol 1e-10] [--impl torch|numpy]
[--prec f64|f32|auto] [--device cuda|cpu] [--cache DIR]
[--reuse-baseline] [--nk-loop N]``. It prints progress on stderr and, as
the last line of stdout, bench's JSON line (times unrounded) plus
``peak_mem_gb`` (null on the CPU), ``device`` and ``escalated``. The
device is cuda unless cpu is named; without a card it raises.
``--impl numpy`` factors on the host and needs ``--device cpu``. The cache
directory holds the problem files and ``baseline_<size>.json``
([factor s, solve s, residual], bench.py's layout) with
``baseline_<size>_host.json`` (the CPU model and count of the host that
measured it) beside it. ``--nk-loop N`` runs ``nk_loop.run_nk_loop``
instead of the factor-and-solve path, with the baseline's factor + solve
as the baseline of one iteration.

Not ported (ROADMAP, "Not to port"): the Pallas smoke gate with
``--skip-smoke``, the subprocess ladder with ``--_measure``
(bench.py:256-347); the ``NK_BENCH_SIZE`` / ``NK_PREC`` environment
defaults; the ``gx1_result.json`` pickup (bench.py:385-390), an artifact
of ``scripts/gx1_round*.sh``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..io.matrixfile import SparseMatrix
from ..solver.api import ScipyFactorization
from ..solver.mf import MultifrontalFactorization
from ..solver.symbolic import symbolic_from_matrix
from .nk_loop import SIZES, build_problem, residual, run_nk_loop, summary

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "nk_ocn_torch_bench")
PRECISION_NOTE = (
    "float64 factors (production precision; reference is SuperLU_DIST "
    "dgssvx). float32 factors (--prec f32) are a knife's edge at this "
    "elimination growth: they escalate to float64 when refinement fails "
    "(see escalated).")


def host_cpu() -> dict:
    """This host's CPU: its model (the first "model name" of /proc/cpuinfo,
    or its x86 vendor, family and model numbers where a virtual machine
    hides the name or gives it as "unknown"; "unknown" without the file),
    the machine type and the logical CPU count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, value = line.partition(":")
                if not sep:
                    if info:
                        break       # the end of the first CPU's block
                    continue
                info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = info.get("model name")
    if model in (None, "", "unknown"):
        model = " ".join(
            f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
            if info.get(k)) or "unknown"
    return dict(cpu_model=model, machine=platform.machine(),
                cpu_count=os.cpu_count())


def bench_scipy(matrix: SparseMatrix, B: np.ndarray, tol: float):
    """scipy's splu of ``matrix`` and its refined solve of ``B``, timed:
    (factor s, solve s, residual, solution)."""
    t0 = time.perf_counter()
    fac = ScipyFactorization(matrix, refine_tol=tol)
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fac.solve(B)
    t_solve = time.perf_counter() - t0
    return t_factor, t_solve, residual(matrix, X, B), X


def bench_mf(matrix: SparseMatrix, maps, B: np.ndarray, tol: float,
             impl: str = "torch", prec: str = "f64",
             device: str | torch.device = "cuda") -> dict:
    """bench.py's bench_mf on ``device``: symbolic (leaf_size 16), the
    cold facade, a steady refactor, a warm-up solve and the timed solve.
    Returns the seconds of each (factor, solve, cold_factor, cold_solve,
    symbolic), the residual (res), the solution (X), the peak device
    memory in GB from the cold factor on (None on the CPU), the name of
    the device that factored and the facade's escalation record.
    ``impl="numpy"`` factors on the host: it takes no device but the CPU."""
    if impl == "numpy" and torch.device(device).type != "cpu":
        raise ValueError("impl 'numpy' factors on the host: give device "
                         "'cpu'")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def since(t0: float) -> float:
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
    t_sym = since(t0)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                    refine_tol=tol, precision=prec,
                                    device=dev, impl=impl)
    t_factor_cold = since(t0)
    # steady state: numeric refactorization on the same plans, the
    # Newton-iteration reuse path (one factor set resident)
    t0 = time.perf_counter()
    fac.refactor()
    t_factor = since(t0)
    t0 = time.perf_counter()
    X = fac.solve(B)           # warm-up solve
    t_solve_cold = since(t0)
    t0 = time.perf_counter()
    X = fac.solve(B)
    t_solve = since(t0)
    res = residual(matrix, X, B)
    print(f"# symbolic {t_sym:.2f}s, cold factor {t_factor_cold:.2f}s, "
          f"steady factor {t_factor:.3f}s, cold solve {t_solve_cold:.3f}s, "
          f"solve {t_solve:.3f}s, max residual {res:.2e}", file=sys.stderr)
    return dict(factor=t_factor, solve=t_solve, res=res,
                cold_factor=t_factor_cold, cold_solve=t_solve_cold,
                symbolic=t_sym, X=X,
                peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                             if cuda else None),
                device=torch.cuda.get_device_name(dev) if cuda else "cpu",
                escalated=fac.escalation)


def baseline(matrix: SparseMatrix, B: np.ndarray, tol: float, cache: str,
             size: str, reuse: bool):
    """The scipy baseline (factor s, solve s, residual) and the host that
    measured it: read from the cache with ``reuse`` when it is there, else
    measured here and written to it."""
    path = os.path.join(cache, f"baseline_{size}.json")
    host_path = os.path.join(cache, f"baseline_{size}_host.json")
    if reuse and os.path.exists(path):
        with open(path) as f:
            s_factor, s_solve, s_res = json.load(f)
        host = None
        if os.path.exists(host_path):
            with open(host_path) as f:
                host = json.load(f)
        print(f"# scipy SuperLU (cached measurement): factor "
              f"{s_factor:.2f}s solve {s_solve:.3f}s residual {s_res:.2e}",
              file=sys.stderr)
        return s_factor, s_solve, s_res, host
    s_factor, s_solve, s_res, _ = bench_scipy(matrix, B, tol)
    host = host_cpu()
    print(f"# scipy SuperLU: factor {s_factor:.2f}s solve {s_solve:.3f}s "
          f"residual {s_res:.2e} ({host['cpu_model']}, "
          f"{host['cpu_count']} CPUs)", file=sys.stderr)
    with open(path, "w") as f:
        json.dump([s_factor, s_solve, s_res], f)
    with open(host_path, "w") as f:
        json.dump(host, f)
    return s_factor, s_solve, s_res, host


def baseline_class(host: dict | None) -> str:
    where = ("a host whose CPU was not recorded" if host is None else
             f"the host that measured it: {host['cpu_model']} "
             f"({host.get('machine')}), {host['cpu_count']} logical CPUs")
    return ("sequential scipy SuperLU (splu) float64, refined to --tol, "
            f"identical matrix, on {where}; splu factors on one core. The "
            "reference's production deployment is 144 MPI ranks "
            "(test_solve_ABglobal.csh:6-7): divide vs_baseline by the "
            "reference's rank-scaling efficiency to compare against a "
            "cluster run.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench",
        description="Jacobian factor + multi-RHS solve on a torch device, "
                    "against scipy SuperLU on this host")
    p.add_argument("--size", default="gx3", choices=list(SIZES))
    p.add_argument("--nrhs", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--impl", default="torch", choices=["torch", "numpy"])
    p.add_argument("--prec", default="f64", choices=["f64", "f32", "auto"])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu when named)")
    p.add_argument("--cache", default=DEFAULT_CACHE,
                   help="directory for the problem files and the scipy "
                        "baseline (default: %(default)s)")
    p.add_argument("--reuse-baseline", action="store_true",
                   help="reuse a previously measured scipy baseline for "
                        "this size (default: measure it fresh)")
    p.add_argument("--nk-loop", type=int, default=0, metavar="N",
                   help="run N Newton-Krylov outer iterations (new values, "
                        "same pattern: assemble + refactor + solve each) "
                        "and report the per-iteration cost")
    args = p.parse_args(argv)
    if args.impl == "numpy" and torch.device(args.device).type != "cpu":
        p.error("--impl numpy factors on the host: give --device cpu")
    device = resolve_device(args.device)

    matrix, maps, circ = build_problem(SIZES[args.size], args.cache)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len,
                                                  args.nrhs))
    print(f"# problem {args.size}: flat_len={matrix.flat_len} "
          f"nnz={matrix.nnz}", file=sys.stderr)
    s_factor, s_solve, s_res, host = baseline(
        matrix, B, args.tol, args.cache, args.size, args.reuse_baseline)
    base = s_factor + s_solve
    if args.nk_loop:
        # per-Newton-iteration baseline: sequential SuperLU refactors and
        # resolves every iteration (it has no numeric-reuse path)
        result = run_nk_loop(matrix, maps, circ, B, args.nk_loop,
                             tol=args.tol, device=device,
                             precision=args.prec)
        print(json.dumps(summary(result, args.nrhs, args.size,
                                 baseline_s=base), default=float))
        return 0
    m = bench_mf(matrix, maps, B, args.tol, impl=args.impl, prec=args.prec,
                 device=device)
    ok = m["res"] <= 1e-10
    ours = m["factor"] + m["solve"]
    out = {
        "metric": f"jacobian factor+{args.nrhs}-rhs solve wall-clock, "
                  f"{args.size} grid, residual<=1e-10"
                  + ("" if ok else " [RESIDUAL NOT MET]"),
        "value": ours,
        "unit": "s",
        "vs_baseline": base / ours if ours > 0 else 0.0,
        "precision": args.prec,
        "factor_s": m["factor"],
        "solve_s": m["solve"],
        "residual": m["res"],
        "cold_factor_s": m["cold_factor"],
        "cold_solve_s": m["cold_solve"],
        "symbolic_s": m["symbolic"],
        "baseline_factor_s": s_factor,
        "baseline_solve_s": s_solve,
        "baseline_residual": s_res,
        "baseline_class": baseline_class(host),
        "baseline_host": host,
        "precision_note": PRECISION_NOTE,
        "peak_mem_gb": m["peak_mem_gb"],
        "device": m["device"],
        "escalated": m["escalated"],
    }
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
