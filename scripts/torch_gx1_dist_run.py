#!/usr/bin/env python3
"""Distributed factor and solve of POP's 1-degree grid on a mesh of cards.

The PyTorch port's runner for the reference's production run (144 MPI
ranks, test/test_solve_ABglobal.csh:6-7,31): gx1, 320x384x60 (3,791,735
rows), factored by the mesh engine (mf_torch.TorchMultifrontal with a
mesh, through the facade) on ``-n`` ranks that this script starts
(parallel.mesh.run_world: NCCL with one card per rank on cuda, gloo on
cpu or, with ``--backend gloo``, ranks that share the cards there are).
Each run:

1. the problem: bench.py's synthetic circulation of ``--size`` (seed 7)
   and the port's gen_A in ``--cache`` (reused when there), or
   ``--matrix``; the symbolic analysis at leaf 16, cached in ``--cache``
   under a hash of the matrix pattern;
2. the mesh facade's factor at ``--prec`` (float64 by default: eps32
   times the 60-level trees' element growth is O(1)), with per-round
   factor checkpoints in ``--ckpt`` so that a rerun resumes round by
   round (a complete directory: every round loads, none is computed);
3. one unrefined solve of two seeded right-hand sides, then plain
   iterative refinement to ``--tol`` (solver.api.iterative_refinement),
   with the facade's GMRES-IR when plain refinement stalls above it.

The last line is ``<size> distributed: ok=... max_rel=... factor=...s
solve=...s refine=...s``; the exit code is 0 only when every relative
residual (long double) is at most ``--tol``, which is never looser
than the contract, 1e-10. ``--out FILE.npz`` keeps the
solutions, residuals and the run's numbers. Imports only the port. Run
from the repository root:

    python3 scripts/torch_gx1_dist_run.py -n 4,2 --ckpt /tmp/gx1_rounds
    python3 scripts/torch_gx1_dist_run.py --size tiny -n 2,1 --device cpu

gx1's float64 factors (135.4 GiB padded) need several cards: about 17
GiB each on eight.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from nk_ocn_tracer_jacobian_precond_tpu_torch.device import (  # noqa: E402
    card_name)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.nk_loop import (  # noqa: E402
    SIZES, problem_files, residuals)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve import (  # noqa: E402
    n_ranks)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (  # noqa: E402
    load_ind_maps)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (  # noqa: E402
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (  # noqa: E402
    check_world, make_mesh, run_world)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.api import (  # noqa: E402
    iterative_refinement)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.checkpoint import (  # noqa: E402
    load_symbolic, save_symbolic)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (  # noqa: E402
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (  # noqa: E402
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import (  # noqa: E402
    set_dbg_lvl)

LEAF = 16
NRHS = 2
CONTRACT = 1e-10
DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "nk_ocn_torch_bench")


def symbolic_cached(mat: str, cache: str) -> tuple[str, float]:
    """The path of ``mat``'s symbolic analysis at leaf LEAF in ``cache``
    (computed and saved on a miss; keyed by the matrix pattern), and the
    seconds it took to make or find."""
    t0 = time.perf_counter()
    matrix = read_matrix_file(mat)
    h = hashlib.sha1(np.asarray(matrix.rowptr, np.int64).tobytes())
    h.update(np.asarray(matrix.colind, np.int64).tobytes())
    h.update(f"leaf={LEAF} coupled={matrix.coupled_tracer_cnt}".encode())
    path = os.path.join(cache, f"sym_{h.hexdigest()[:16]}.npz")
    if not os.path.exists(path):
        os.makedirs(cache, exist_ok=True)
        sym = symbolic_from_matrix(load_ind_maps(mat), matrix,
                                   leaf_size=LEAF)
        save_symbolic(path, sym)
    return path, time.perf_counter() - t0


def rank_main(dev: torch.device, mat: str, sym_path: str, opts: dict,
              result: str) -> None:
    """One rank: the mesh facade's factor, the unrefined solve and the
    refinement; the first rank writes the solutions and numbers to
    ``result``."""
    rank = dist.get_rank()
    first = rank == 0

    def say(msg: str) -> None:
        if first:
            print(msg, flush=True)

    if first:
        set_dbg_lvl(1)
    t0 = time.perf_counter()
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    sym = load_symbolic(sym_path)
    say(f"load {time.perf_counter() - t0:.1f}s flat_len={matrix.flat_len} "
        f"nnz={matrix.nnz} ranks={dist.get_world_size()} device={dev}")
    tol = opts["tol"]
    mesh = make_mesh(dist.get_world_size(), ("front",),
                     rhs_devices=opts["rhs_devices"])

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device=dev,
                                    precision=opts["prec"], refine_tol=tol,
                                    factor_checkpoint_dir=opts["ckpt"],
                                    mesh=mesh)
    sync()
    t_factor = time.perf_counter() - t0
    rounds = len(fac.engine.plans)
    loaded = len(fac.engine.loaded_rounds)
    say(f"distributed factor {t_factor:.1f}s ({rounds - loaded} rounds "
        f"computed, {loaded} loaded from checkpoints)")

    B = np.random.default_rng(0).standard_normal((matrix.flat_len, NRHS))
    t0 = time.perf_counter()
    X = fac.solve(B, refine=False)
    t_solve = time.perf_counter() - t0
    say(f"solve (no refine) {t_solve:.1f}s")

    t0 = time.perf_counter()
    X = iterative_refinement(fac.A, fac._precond_solve, B, X, tol=tol)
    rel = residuals(matrix, X, B)
    gmres = bool(rel.max() > tol)
    if gmres:
        # every rank holds the same X, so all take this branch together
        say(f"plain IR stalled at {rel.max():.3e}; GMRES-IR")
        X = fac._gmres_ir(B, X)
        X = iterative_refinement(fac.A, fac._precond_solve, B, X, tol=tol)
        rel = residuals(matrix, X, B)
    t_ref = time.perf_counter() - t0
    say(f"refine {t_ref:.1f}s residuals {rel}")
    if first:
        stats = dict(ok=bool(rel.max() <= tol),
                     max_rel=float(rel.max()), factor_s=t_factor,
                     solve_s=t_solve, refine_s=t_ref, gmres_ir=gmres,
                     rounds=rounds, rounds_loaded=loaded,
                     rounds_computed=rounds - loaded,
                     ranks=dist.get_world_size(), prec=opts["prec"],
                     flat_len=int(matrix.flat_len), nnz=int(matrix.nnz),
                     card=card_name(dev))
        np.savez(result, X=X, residuals=rel, stats=json.dumps(stats))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="distributed factor + solve of a gen_a matrix on a "
                    "mesh of ranks, resumable from round checkpoints")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--size", default="gx1", choices=list(SIZES),
                     help="bench.py's synthetic problem (default "
                          "%(default)s)")
    src.add_argument("--matrix", default=None, help="a gen_a matrix file")
    p.add_argument("-n", dest="npgrid", default=None,
                   help="nprow[,npcol] (npcol defaults to nprow): the "
                        "ranks, one per card on cuda (default: every card "
                        "there is on cuda, 2 ranks on cpu)")
    p.add_argument("--rhs-devices", type=int, default=1,
                   help="ranks of the mesh's rhs axis")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu when named")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="nccl on cuda and gloo on cpu by default; gloo on "
                        "cuda lets ranks share a card")
    p.add_argument("--prec", default="f64", choices=["f64", "f32"])
    p.add_argument("--ckpt", default=None, metavar="DIR",
                   help="per-round factor checkpoints: written as the "
                        "factor goes, resumed from on a rerun")
    p.add_argument("--tol", type=float, default=CONTRACT,
                   help="refinement target and the residual the run must "
                        "meet, at most the contract (default "
                        "%(default)s)")
    p.add_argument("--cache", default=DEFAULT_CACHE,
                   help="problem files and the symbolic analysis (default "
                        "%(default)s)")
    p.add_argument("--out", default=None, metavar="FILE.npz",
                   help="write the solutions, residuals and numbers here")
    args = p.parse_args(argv)
    if not 0 < args.tol <= CONTRACT:
        p.error(f"--tol {args.tol} is outside (0, {CONTRACT}]: the run "
                f"is judged by it, never looser than the contract")
    if args.npgrid:
        n = n_ranks(args.npgrid)
    elif torch.device(args.device).type == "cuda":
        n = max(1, torch.cuda.device_count())
    else:
        n = 2
    try:
        check_world(n, args.device, args.backend)
    except ValueError as e:
        print(f"torch_gx1_dist_run: {e}", file=sys.stderr)
        return 1
    if args.matrix:
        mat, name = args.matrix, Path(args.matrix).stem
    else:
        mat, _ = problem_files(SIZES[args.size], args.cache)
        name = args.size
    sym_path, t_sym = symbolic_cached(mat, args.cache)
    print(f"symbolic {t_sym:.1f}s ({sym_path})", flush=True)
    opts = dict(prec=args.prec, tol=args.tol, ckpt=args.ckpt,
                rhs_devices=args.rhs_devices)
    with tempfile.TemporaryDirectory(prefix="gx1_dist_") as tmp:
        result = args.out or os.path.join(tmp, "result.npz")
        try:
            run_world(rank_main, n, args.device, mat, sym_path, opts, result,
                      backend=args.backend)
        except torch.multiprocessing.ProcessRaisedException as e:
            print(f"torch_gx1_dist_run: "
                  f"{str(e).strip().splitlines()[-1]}", file=sys.stderr)
            return 1
        except torch.multiprocessing.ProcessExitedException as e:
            print(f"torch_gx1_dist_run: {e}", file=sys.stderr)
            return 1
        with np.load(result) as z:
            st = json.loads(str(z["stats"]))
    print(f"{name} distributed: ok={st['ok']} max_rel={st['max_rel']:.3e} "
          f"factor={st['factor_s']:.1f}s solve={st['solve_s']:.1f}s "
          f"refine={st['refine_s']:.1f}s", flush=True)
    return 0 if st["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
