#!/usr/bin/env python3
"""Out-of-core factor and stream solve of POP's 1-degree grid on one card.

The PyTorch port's runner for the problem its users run: gx1, 320x384x60
(3,791,735 rows), whose float64 factors (~88 GB trimmed, ~144 GB padded)
exceed one card. Steps, each recorded in one JSON object:

1. the problem: bench.py's synthetic circulation (``--seed``, centered
   advection, isop_file hmix, file vmix, const sink 1.21e-4) and the
   port's gen_A, in ``--workdir`` (reused when the matrix is there);
2. ``--memplan``: the solve CLI's memory plan for one device at float64,
   printed as the CLI prints it;
3. the factor-only pass (mf_torch.TorchMultifrontal with
   ``factor_only=True``: each round saved to ``WORKDIR/rounds`` and
   dropped from the card), run only when the engine's planned per-round
   peak (memplan.engine_round_peaks) fits 0.92 of the card; its time, the
   time spent saving rounds, each round's peak device memory against its
   plan, and checkpoint bytes. When the planned disk peak (trimmed round
   files plus the Schur files still needed) fits the free space less
   5 GB, and the planned writes fit ``--max-write-gb``, the whole pass
   runs; otherwise the longest prefix of rounds within both runs, handing
   off with ``stop_after`` as a smaller machine would;
4. with ``--stream-solve`` and a whole factor set: the out-of-core stream
   solve of four seeded right-hand sides over the round files, refined to
   the 1e-10 contract.

Imports only the port. Run from the repository root on a machine with a
card:

    python3 scripts/torch_gx1_oocore.py --workdir /tmp/gx1 --stream-solve \\
        --out /tmp/gx1/result.json

``--imt/--jmt/--km`` cut the grid for a rehearsal (``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from nk_ocn_tracer_jacobian_precond_tpu_torch.device import (  # noqa: E402
    card_name, resolve_device)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import (  # noqa: E402
    run_gen_a)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.solve import (  # noqa: E402
    run_memplan)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (  # noqa: E402
    load_ind_maps)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (  # noqa: E402
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (  # noqa: E402
    AssemblyOptions, PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.checkpoint import (  # noqa: E402
    FactorRoundCheckpointer)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.memplan import (  # noqa: E402
    checkpoint_disk_plan, engine_round_peaks, plan_memory)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (  # noqa: E402
    equilibrate)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (  # noqa: E402
    TorchMultifrontal, pack_block_size)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (  # noqa: E402
    build_plan)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.stream_solve import (  # noqa: E402
    StreamSolver, stream_solve)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (  # noqa: E402
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (  # noqa: E402
    make_circ_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import (  # noqa: E402
    set_dbg_lvl)

GB = 1e9
# the share of the card a pass may plan to fill (the facade's escalation
# rule, solver/mf.py)
MEM_FRAC = 0.92


def say(msg: str) -> None:
    print(msg, flush=True)


def make_problem(workdir: Path, dims: dict, seed: int) -> str:
    """bench.py's problem: circulation file and gen_A matrix file."""
    circ, mat = workdir / "circ.nc", workdir / "matrix.nc"
    if not mat.exists():
        make_circ_file(str(circ), seed=seed, **dims)
        pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
        run_gen_a(str(mat), opts=AssemblyOptions(
            circ_fname=str(circ), adv_type="centered", hmix_type="isop_file",
            vmix_type="file", per_tracer=[pt]))
    return str(mat)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--imt", type=int, default=320)
    p.add_argument("--jmt", type=int, default=384)
    p.add_argument("--km", type=int, default=60)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-write-gb", type=float, default=float("inf"),
                   help="bytes the machine lets a run write to its disk, "
                        "deleted files included; the pass stops at the "
                        "last round within it")
    p.add_argument("--stream-solve", action="store_true")
    p.add_argument("--out", default=None, help="JSON result file")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    set_dbg_lvl(1)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = workdir / "rounds"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    dims = dict(imt=args.imt, jmt=args.jmt, km=args.km)
    result: dict = dict(grid=dims, seed=args.seed, torch=torch.__version__)

    def done(rc: int = 0) -> int:
        result["total_s"] = time.perf_counter() - t_start
        line = json.dumps(result)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
        say(line)
        return rc

    t0 = time.perf_counter()
    mat = make_problem(workdir, dims, args.seed)
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    result.update(problem_s=time.perf_counter() - t0,
                  flat_len=int(matrix.flat_len), nnz=int(matrix.nnz))
    say(f"problem: flat_len {matrix.flat_len}, nnz {matrix.nnz} "
        f"({result['problem_s']:.1f} s)")

    # the CLI's --memplan, as it prints it (host only)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_memplan(mat, 1, precision="f64", device=args.device)
    set_dbg_lvl(1)
    result["memplan"] = buf.getvalue().strip().splitlines()
    result["memplan_s"] = time.perf_counter() - t0
    say("memplan:\n  " + "\n  ".join(result["memplan"]))

    device = resolve_device(args.device)
    result["card"] = card_name(device)
    prec = torch.float64
    t0 = time.perf_counter()
    sym = symbolic_from_matrix(maps, matrix)
    plans = build_plan(sym, matrix, batch_multiple=1)
    mp = plan_memory(plans, 1, prec.itemsize)
    # the port's own per-round working set (the JAX plan's transient
    # model counts fused programs, not eager temporaries)
    mem = engine_round_peaks(plans, prec.itemsize, matrix.nnz,
                             pack_block_size(plans))
    result["symbolic_plan_s"] = time.perf_counter() - t0
    card = (torch.cuda.mem_get_info(device)[1] if device.type == "cuda"
            else None)
    free = shutil.disk_usage(ckpt_dir).free
    peaks, wrote = checkpoint_disk_plan(sym, plans, prec.itemsize)
    result.update(rounds=len(plans),
                  jax_plan_schur_transient_gb=(mp.schur_peak_per_device
                                               + mp.transient_peak_per_device)
                  / GB,
                  factor_only_peak_planned_gb=max(mem) / GB,
                  card_memory_gb=card / GB if card else None,
                  disk_free_gb=free / GB,
                  disk_peak_planned_gb=max(peaks) / GB,
                  disk_written_planned_gb=wrote[-1] / GB)
    if card and max(mem) > MEM_FRAC * card:
        worst = int(np.argmax(mem))
        result["factor_only"] = (f"not run: round {worst}'s planned peak "
                                 f"{mem[worst] / GB:.1f} GB > {MEM_FRAC} x "
                                 f"{card / GB:.1f} GB")
        return done()
    stop_after = None
    cap = args.max_write_gb * GB
    # the planned live disk peak, with a margin of 5 GB
    room = free - 5 * GB
    if max(peaks) > room or wrote[-1] > cap:
        fits = [r for r in range(len(plans))
                if max(peaks[:r + 1]) <= room and wrote[r] <= cap]
        if not fits:
            result["factor_only"] = (f"not run: round 0 alone needs "
                                     f"{peaks[0] / GB:.1f} GB of "
                                     f"{free / GB:.1f} GB free")
            return done()
        stop_after = fits[-1] if fits[-1] < len(plans) - 1 else None
    fac_matrix, _, _ = equilibrate(matrix)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    saves, round_peaks = [], {}
    real_save = FactorRoundCheckpointer.save_round

    def timed_save(self, rnd, *a, **kw):
        # a round's save follows its factor step: the peak since the last
        # save is the round's own
        if device.type == "cuda":
            round_peaks[rnd] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        real_save(self, rnd, *a, **kw)
        saves.append(time.perf_counter() - t)
    FactorRoundCheckpointer.save_round = timed_save
    t0 = time.perf_counter()
    try:
        eng = TorchMultifrontal(sym, fac_matrix, device, prec=prec,
                                checkpoint_dir=str(ckpt_dir),
                                factor_only=True, stop_after=stop_after)
    finally:
        FactorRoundCheckpointer.save_round = real_save
    last = len(plans) - 1 if stop_after is None else stop_after
    files = sorted(ckpt_dir.glob("round_*"))
    result["factor_only"] = dict(
        s=time.perf_counter() - t0, factor_s=eng.timings["factor"],
        plan_s=eng.timings["plan"], stop_after=stop_after,
        save_round_s=sum(saves),
        round_files=len([f for f in files if not f.stem.endswith("_S")]),
        ckpt_gb=sum(f.stat().st_size for f in files) / GB,
        planned_disk_peak_gb=max(peaks[:last + 1]) / GB,
        planned_written_gb=wrote[last] / GB,
        # the rounds' windows and the one after the last save
        peak_mem_gb=(max([torch.cuda.max_memory_allocated(device)]
                         + list(round_peaks.values())) / GB
                     if device.type == "cuda" else None),
        planned_peak_gb=max(mem[:last + 1]) / GB,
        # measured over planned, per round (<= 1: the plan bounds it)
        peak_over_plan={r: p / mem[r] for r, p in round_peaks.items()})
    pack_bs = eng._pack_bs
    del eng
    say(f"factor-only: {json.dumps(result['factor_only'])}")

    if not args.stream_solve:
        return done()
    if stop_after is not None:
        result["stream_solve"] = "not run: the factor set is partial"
        return done()
    B = np.random.default_rng(args.seed).standard_normal(
        (matrix.flat_len, 4))
    applies = []
    real = StreamSolver.apply

    def timed_apply(self, b):
        t = time.perf_counter()
        out = real(self, b)
        applies.append(time.perf_counter() - t)
        return out
    StreamSolver.apply = timed_apply
    t0 = time.perf_counter()
    try:
        X, rel = stream_solve(matrix, maps, sym, str(ckpt_dir), B,
                              pack_bs=pack_bs)
    finally:
        StreamSolver.apply = real
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    result["stream_solve"] = dict(s=time.perf_counter() - t0,
                                  apply_s=applies,
                                  residuals=[float(r) for r in res],
                                  finite=bool(np.all(np.isfinite(X))))
    return done(0 if res.max() <= 1e-10 else 1)


if __name__ == "__main__":
    raise SystemExit(main())
