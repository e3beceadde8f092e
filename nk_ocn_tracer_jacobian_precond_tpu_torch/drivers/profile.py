"""Per-round, per-stage profile of the numeric refactor, and the solve.

The port of the JAX package's ``scripts/profile_factor.py`` (the ranked
cost table of the factor's dispatches, "the optimization worklist for the
steady-state Newton iteration", then the refined 4-RHS solve) and
``scripts/profile_f64_rounds.py`` (one line per round: B, P, N, child
groups, assembly / extend-add / partial-factor seconds). Where those
scripts re-walk the rounds by hand, this one times the engine's own round
loop (``mf_torch.TorchMultifrontal._factor_rounds``), whose scopes the
stage timer ``utils.profiling.STAGES`` records with a synchronize around
each: checkpoints, mesh layouts and Schur freeing are then the engine's
own, and under a mesh each rank times its own rounds.

``profile_refactor`` gives each round's exclusive ms of K3 (assembly),
extend-add, the panel kernel (K1 at f64, K2 at f32), the row gather, the
TRSMs, the trailing GEMM, the pack, the tree-top library LU, the rest of
``partial_factor``, checkpoint I/O and the walk between them;
``ranked_costs`` the JAX script's table; ``device_busy`` torch.profiler's
kernel count and busy share of an unsynchronized refactor, and its idle
time by the program's innermost span (``utils.profiling.span``).
``timeline``, ``device_gaps``, ``span_totals`` and ``idle_under`` are its
arithmetic over the profiler's raw records, for any traced stretch.

Run as ``python -m nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.profile
[--size tiny|small|gx3|gx3deep | --matrix FILE] [--leaf 16] [--prec f64]
[--nrhs 4] [--device cuda] [--cache DIR] [--trace DIR]``: the tables on
stderr, one JSON line on stdout, every time in it beside the card's name
and power limit. ``--device`` is cuda unless the caller names cpu.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from ..device import card_name, resolve_device
from ..grid.indmap import load_ind_maps
from ..io.matrixfile import read_matrix_file
from ..solver.mf import MultifrontalFactorization
from ..solver.symbolic import symbolic_from_matrix
from ..utils.profiling import PREFIX, STAGES
from .nk_loop import SIZES, build_problem, residuals

# the stages of one round, in the order of the round loop, with the column
# each gets in the tables; "partial_factor" is its own exclusive rest (the
# panel's input copy, the permutation, the final copies)
STAGE_COLUMNS = (("assemble", "K3"), ("extend_add", "EA"), ("panel", None),
                 ("row_gather", "gather"), ("trsm", "TRSM"),
                 ("gemm", "GEMM"), ("pack", "pack"), ("treetop_lu", "LU"),
                 ("partial_factor", "pf rest"), ("ckpt_save", "save"),
                 ("ckpt_load", "load"))
STAGE_NAMES = tuple(name for name, _ in STAGE_COLUMNS)
# the stages inside mf_torch.partial_factor: profile_factor.py's
# "factor B=.. P=.. N=.." dispatch
FACTOR_STAGES = ("panel", "row_gather", "trsm", "gemm", "pack",
                 "treetop_lu", "partial_factor")
TOP_KERNELS = 6
# the kineto activity of a user range mirrored onto the device's timeline
ANNOTATION = "gpu_user_annotation"
NO_SPAN = "(no program span)"
# the residual contract: the solve refines to it, and the CLI exits 0 only
# when every column's relative residual meets it
CONTRACT = 1e-10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_refactor(fac, device) -> dict:
    """One warm refactor of the facade ``fac``, then one steady refactor
    under an active stage timer. Returns the per-round ``rows`` (round, B,
    P, N, child groups, ``loaded`` from a checkpoint, inclusive ``ms``,
    exclusive ms of each of STAGE_NAMES, and ``walk``: the round's time
    outside its stages), the ``totals`` of each stage's exclusive ms over
    the refactor (rounds and the stages outside every round), ``calls``
    per stage, ``walk_ms`` outside every stage, ``outside_rounds_ms``,
    ``rows_ms`` (the rows' sum) and the synchronized ``wall_ms``: the
    stages' exclusive ms plus the walk add up to the wall."""
    device = torch.device(device)
    fac.refactor()
    with STAGES.recording(device) as t:
        fac.refactor()
    rows = []
    for r in t.rounds:
        row = {k: r[k] for k in ("round", "B", "P", "N", "children")}
        row["loaded"] = r["round"] in fac.engine.loaded_rounds
        row["ms"] = r["ms"]
        row.update({name: r["excl"][name] for name in STAGE_NAMES})
        row["walk"] = r["ms"] - r["stages_ms"]
        rows.append(row)
    rows_ms = sum(r["ms"] for r in rows)
    return dict(
        prec=str(fac.engine.prec).replace("torch.", ""),
        panel_kernel="K1" if fac.engine.prec == torch.float64 else "K2",
        rows=rows, totals={name: t.excl[name] for name in STAGE_NAMES},
        calls={name: t.calls[name] for name in STAGE_NAMES},
        walk_ms=t.wall_ms - t.top_ms, rows_ms=rows_ms,
        outside_rounds_ms=t.wall_ms - rows_ms, wall_ms=t.wall_ms)


def ranked_costs(rows) -> list:
    """profile_factor.py's ranked cost table over the computed rounds of
    ``rows``: seconds per ``assemble N=..``, ``extend N=..`` (rounds with
    child groups) and ``factor B=.. P=.. N=..`` key, summed over the rounds
    that share it, with its share of their total, largest first."""
    costs: dict = defaultdict(float)
    for r in rows:
        if r["loaded"]:
            continue
        costs[f"assemble N={r['N']}"] += r["assemble"]
        if r["children"]:
            costs[f"extend N={r['N']}"] += r["extend_add"]
        costs[f"factor B={r['B']} P={r['P']} N={r['N']}"] += sum(
            r[k] for k in FACTOR_STAGES)
    total = sum(costs.values()) or 1.0
    return [dict(key=k, s=v / 1e3, share=v / total)
            for k, v in sorted(costs.items(), key=lambda kv: -kv[1])]


def timeline(events) -> tuple[list, list]:
    """The host's and the device's records of torch.profiler's raw kineto
    ``events`` as (start s, end s, name) lists. The annotation ranges the
    profiler mirrors onto the device's timeline (each user range over the
    kernels launched inside it) are not device work: they are left out.
    Times count from the first record's start (seconds since the epoch
    would keep only tenths of a microsecond)."""
    host, dev = [], []
    base = None
    for e in events:
        if base is None:
            base = e.start_ns()
        t0 = (e.start_ns() - base) * 1e-9
        iv = (t0, t0 + e.duration_ns() * 1e-9, e.name())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(iv)
        elif not _annotation(e):
            dev.append(iv)
    return host, dev


def _annotation(e) -> bool:
    """Whether a device-side record is a mirrored user range: its flag,
    or its kineto activity where torch names it (2.13 on)."""
    kind = getattr(e, "activity_type", None)
    return e.is_user_annotation() or (kind is not None
                                      and kind() == ANNOTATION)


def device_gaps(dev, w0: float, w1: float) -> tuple[float, list]:
    """The busy seconds of the device inside [w0, w1] (the union of its
    records' intervals) and the idle gaps between them, [(start, end)]."""
    busy, end, gaps = 0.0, w0, []
    for a, b, _ in sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                          if b > w0 and a < w1):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def span_totals(host, w0: float, w1: float) -> dict:
    """{name: [seconds, count]} of the program's spans (``nk.*`` host
    ranges) that start inside [w0, w1]."""
    out: dict = defaultdict(lambda: [0.0, 0])
    for a, b, name in host:
        if name.startswith(PREFIX) and w0 <= a < w1:
            out[name][0] += b - a
            out[name][1] += 1
    return dict(out)


def idle_under(host, gaps) -> dict:
    """{name: seconds}: each idle gap put down to the innermost program
    span (the shortest ``nk.*`` host range) covering its midpoint, or to
    NO_SPAN."""
    spans = [(a, b, n) for a, b, n in host if n.startswith(PREFIX)]
    out: dict = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        cover = [(b - a, n) for a, b, n in spans if a <= mid <= b]
        out[min(cover)[1] if cover else NO_SPAN] += g1 - g0
    return dict(out)


def device_busy(fac, device, trace_dir: str | None = None) -> dict:
    """torch.profiler over one refactor with the stage timer inactive: the
    CUDA kernels launched, the union of their intervals as a share of the
    wall, the TOP_KERNELS kernels by count and by summed device ms, and
    the device's idle ms inside the facade's ``nk.mf.factor`` span by the
    innermost span (``idle_under``); with ``trace_dir`` a Chrome trace is
    written there. On the CPU there is no device time to read: "not
    measured"."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device(device)
    if device.type != "cuda":
        return dict(device_busy_share="not measured (no card)")
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fac.refactor()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"refactor_{time.strftime('%Y%m%d_%H%M%S')}_"
                       f"{os.getpid()}.json"))
    # the profiler's raw records: prof.events() builds a Python tree of
    # every host and device event, minutes for one gx3deep refactor
    host, dev = timeline(prof.profiler.kineto_results.events())
    count: dict = defaultdict(int)
    us: dict = defaultdict(float)
    for a, b, name in dev:
        count[name] += 1
        us[name] += (b - a) * 1e6
    busy = device_gaps(dev, -math.inf, math.inf)[0] * 1e6
    factor = [(a, b) for a, b, n in host if n == PREFIX + "mf.factor"]
    idle = (idle_under(host, device_gaps(dev, *factor[0])[1])
            if factor and dev else {})
    return dict(profiled_refactor_ms=wall_us / 1e3,
                device_kernels=len(dev),
                device_busy_share=(busy / wall_us if dev
                                   else "not measured"),
                top_kernels_by_count=sorted(
                    count.items(), key=lambda kv: -kv[1])[:TOP_KERNELS],
                top_kernels_by_ms=[(k, v / 1e3) for k, v in sorted(
                    us.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]],
                idle_under_ms={k: v * 1e3 for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])})


def timed_solve(fac, matrix, B: np.ndarray, device) -> dict:
    """A warm-up refined solve of B, then the timed one (synchronized):
    its seconds, each column's residual in long double
    (nk_loop.residuals), the refiner's stats and the facade's escalation
    record."""
    device = torch.device(device)
    fac.solve(B)
    _sync(device)
    t0 = time.perf_counter()
    X = fac.solve(B)
    _sync(device)
    t = time.perf_counter() - t0
    return dict(solve_s=t, residuals=residuals(matrix, X, B).tolist(),
                refiner=dict(fac._refiner.stats), escalation=fac.escalation)


def round_table(prof: dict) -> str:
    """The per-round table (profile_f64_rounds.py's lines, split finer)
    and its totals, exclusive ms."""
    heads = [label or prof["panel_kernel"] for _, label in STAGE_COLUMNS]
    lines = ["round     B     P     N  ch " + "".join(
        f"{h:>9s}" for h in heads) + f"{'walk':>9s}{'total':>10s}"]
    for r in prof["rows"]:
        lines.append(
            f"{r['round'] + 1:5d} {r['B']:5d} {r['P']:5d} {r['N']:5d} "
            f"{r['children']:3d} " + "".join(
                f"{r[name]:9.2f}" for name in STAGE_NAMES)
            + f"{r['walk']:9.2f}{r['ms']:10.2f}"
            + (" [loaded]" if r["loaded"] else ""))
    tot = prof["totals"]
    lines.append("TOTAL" + " " * 21 + "".join(
        f"{tot[name]:9.2f}" for name in STAGE_NAMES)
        + f"{prof['walk_ms']:9.2f}{prof['wall_ms']:10.2f}"
        + f"  (rows {prof['rows_ms']:.2f} ms, outside the rounds "
          f"{prof['outside_rounds_ms']:.2f} ms)")
    return "\n".join(lines)


def cost_table(ranked) -> str:
    """profile_factor.py's ranked table: seconds, share, key."""
    total = sum(c["s"] for c in ranked)
    return "\n".join([f"# factor stages total {total:.4f}s (steady, "
                      f"synchronized per stage)"]
                     + [f"  {c['s']:8.4f}s  {100 * c['share']:5.1f}%  "
                        f"{c['key']}" for c in ranked])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="profile",
        description="per-round, per-stage profile of the steady refactor "
                    "and the refined multi-RHS solve")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--size", default=None, choices=list(SIZES),
                     help="bench.py's synthetic problem (default gx3)")
    src.add_argument("--matrix", default=None,
                     help="a gen_a matrix file (e.g. upwind3 or a coupled "
                          "pair)")
    p.add_argument("--leaf", type=int, default=16,
                   help="symbolic leaf size (default %(default)s, the JAX "
                        "profilers')")
    p.add_argument("--prec", default="f64", choices=["f64", "f32"])
    p.add_argument("--nrhs", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu when named)")
    p.add_argument("--cache", default=None,
                   help="directory for --size's problem files (reused "
                        "when present; default: a temporary one)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of one "
                        "refactor into DIR")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    with tempfile.TemporaryDirectory(prefix="nk_profile_") as tmp:
        if args.matrix:
            name = os.path.basename(args.matrix)
            matrix = read_matrix_file(args.matrix)
            maps = load_ind_maps(args.matrix)
        else:
            name = args.size or "gx3"
            matrix, maps, _ = build_problem(SIZES[name], args.cache or tmp)
    print(f"# problem {name}: flat_len={matrix.flat_len} nnz={matrix.nnz} "
          f"[{card}]", file=sys.stderr)
    t0 = time.perf_counter()
    sym = symbolic_from_matrix(maps, matrix, leaf_size=args.leaf)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                    refine_tol=CONTRACT, device=device,
                                    precision=args.prec)
    _sync(device)
    t_cold = time.perf_counter() - t0
    print(f"# symbolic {t_sym:.2f}s, cold factor {t_cold:.2f}s",
          file=sys.stderr, flush=True)
    prof = profile_refactor(fac, device)
    print(round_table(prof), file=sys.stderr, flush=True)
    ranked = ranked_costs(prof["rows"])
    print(cost_table(ranked), file=sys.stderr, flush=True)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len,
                                                  args.nrhs))
    sol = timed_solve(fac, matrix, B, device)
    print(f"# refined solve ({args.nrhs} rhs): {sol['solve_s']:.4f}s, "
          f"residuals {sol['residuals']} (long double), refiner "
          f"{sol['refiner']} [{card}]", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    busy = device_busy(fac, device, args.trace)
    print(f"# device busy {busy.get('device_busy_share')} of a refactor "
          f"({time.perf_counter() - t0:.1f}s to profile and read) [{card}]",
          file=sys.stderr, flush=True)
    ok = max(sol["residuals"]) <= CONTRACT
    print(json.dumps(dict(
        problem=name, flat_len=int(matrix.flat_len), nnz=int(matrix.nnz),
        leaf=args.leaf, prec=args.prec, nrhs=args.nrhs,
        device=str(device), card=card, rounds=len(fac.engine.plans),
        symbolic_s=t_sym, cold_factor_s=t_cold, profile=prof,
        ranked=ranked, device_busy=busy,
        solve=sol, ok=ok),
        default=float))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
