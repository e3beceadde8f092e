#!/usr/bin/env python3
"""Where the card waits in a benchmark cell's requests, by the program's
spans (``utils/profiling.py::span``).

Builds the cell's configuration as ``benchmark/run.py`` does
(``apply_cell.py``; the mix must not refactor) and, for each seed, runs
the mix's warm-up requests, then its traced requests under the harness's
profiler (``benchmark/trace.py::traced``, each request in a
``bench.solve`` range as there). The stretch is read
twice: by the harness (``summarize``: busy and window seconds, the idle
gaps by the innermost host event) and by ``drivers/profile.py``'s
arithmetic: every idle gap put down to the innermost ``nk.*`` span
(``idle_under``) and each span's host seconds and count, per request.
Beside them: the engine's ``sweep_bytes`` (the bytes one sweep of the
mix's right-hand sides reads at the least) and each traced request's
preconditioner applications (the refiner's ``host_applies`` + ``cycles``).
The sweeps' routes: the engine's ``sweep_counts`` after each seed's
requests, the ``route`` of each ``nk.engine.sweep`` of one more request
(profiled with its ranges' arguments) and the host's launch calls inside
each, and the device operations and launch calls of one sweep by the
eager body (``_sweep``) against one by the engine's own route
(``solve_workspace``: a graph launch and two copies once it replays).

With ``--cost N``: N requests with every span on and N with every span
the no-op, alternated one by one, first under one profiler, then without
one; the median latency of each side and the median of the pairs'
differences.

    python3 scripts/torch_apply_spans.py --workload gx3deep_centered.apply
        --seeds 11,12,13 [--cost 200] [--device cuda] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import apply_cell  # noqa: E402
from benchmark import run as bench  # noqa: E402


@contextlib.contextmanager
def spans_off():
    """Every span of the program the shared no-op for the block."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        mf, mf_torch, refine)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import (
        logging, profiling)
    mods = (mf, mf_torch, refine, logging, profiling)
    saved = [m.span for m in mods]

    def off(name, **args):
        return profiling._NO_SCOPE
    for m in mods:
        m.span = off
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.span = s


# the host's calls that put work on the device's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _launch_calls(events, t0: int = 0, t1: float = float("inf")) -> int:
    """The host's launch calls among ``events`` that start in [t0, t1]
    (ns)."""
    return sum(1 for e in events if e.name() in LAUNCH_CALLS
               and t0 <= e.start_ns() <= t1)


def sweep_routes(request, seed: int, index: int, acts) -> list:
    """(route, host launch calls) of each ``nk.engine.sweep`` of one
    request, profiled with its ranges' arguments."""
    import torch
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        request(seed, index)
    events = list(prof.profiler.kineto_results.events())
    out = []
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.name() == "nk.engine.sweep":
            t0 = e.start_ns()
            out.append([e.kwinputs().get("route"),
                        _launch_calls(events, t0, t0 + e.duration_ns())])
    return out


def sweep_ops(eng, nrhs: int, dev, acts) -> dict:
    """Device operations and host launch calls of one sweep of ``nrhs``
    right-hand sides: the eager body against the engine's own route,
    each alone under a profiler."""
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
    W = torch.zeros((eng.flat_len + 1, nrhs), dtype=eng.prec, device=dev)
    W[:eng.flat_len] = 1.0
    out = {}
    for name, fn in (("eager", eng._sweep), ("route", eng.solve_workspace)):
        x = W.clone()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=acts) as prof:
            fn(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        events = list(prof.profiler.kineto_results.events())
        out[name] = dict(device_ops=len(profile.timeline(events)[1]),
                         launch_calls=_launch_calls(events))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_apply_spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="gx3deep_centered.apply")
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds of the right-hand sides")
    p.add_argument("--cost", type=int, default=0, metavar="N")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench.use_checkout_caches()
    import torch

    from benchmark import trace as tr
    from benchmark.reference import check
    from nk_ocn_tracer_jacobian_precond_tpu_torch.device import (
        resolve_device)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    torch.set_num_threads(bench.HOST_THREADS)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cell = apply_cell.build(args.workload, dev, "torch_apply_spans")
    fac, n, traffic = cell["fac"], cell["n"], cell["traffic"]
    nrhs = traffic["rhs_per_step"]
    k = traffic["traced_steps"]
    card = bench.power_limit() if cuda else "cpu"
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731

    applies: list[int] = []

    def request(seed: int, index: int) -> float:
        B = check.step_rhs(n, seed, index, nrhs)
        with torch.profiler.record_function("bench.solve"):
            t0 = time.perf_counter()
            fac.solve(B)
            if cuda:
                torch.cuda.synchronize(dev)
            t = time.perf_counter() - t0
        st = fac._refiner.stats
        applies.append(st["host_applies"] + st["cycles"])
        return t

    sweep_bytes = fac.engine.sweep_bytes(nrhs)
    out = dict(workload=args.workload, card=card, traced_requests=k,
               sweep_bytes=sweep_bytes, pack_bs=fac.engine._pack_bs,
               seeds={})
    log(f"# sweep_bytes {sweep_bytes} ({nrhs} rhs, pack block "
        f"{fac.engine._pack_bs}, {len(fac.engine.plans)} rounds)")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for seed in (int(s) for s in args.seeds.split(",")):
        launched = ck.LAUNCHES["csr_matvec_f64"]
        for i in range(traffic["warmup_steps"]):
            request(seed, i + 1)
        applies.clear()
        with tr.traced(dev) as held:
            lat = [request(seed, 100 + i) for i in range(k)]
        prof = held.pop("prof")
        harness = tr.summarize(prof) if cuda else None
        host, devs = profile.timeline(prof.profiler.kineto_results.events())
        w0, w1 = next((a, b) for a, b, name in host if name == tr.STRETCH)
        busy, gaps = profile.device_gaps(devs, w0, w1)
        under = profile.idle_under(host, gaps)
        idle = (w1 - w0) - busy
        row = dict(
            window_s=w1 - w0, busy_s=busy, idle_s=idle,
            idle_share=idle / (w1 - w0),
            explained=(1.0 - under.get(profile.NO_SPAN, 0.0) / idle
                       if idle > 0 else None),
            latency_ms=[1e3 * x for x in lat],
            idle_under_ms={name: 1e3 * s / k for name, s in sorted(
                under.items(), key=lambda kv: -kv[1])},
            spans_ms={name: [1e3 * s / k, c / k] for name, (s, c) in sorted(
                profile.span_totals(host, w0, w1).items(),
                key=lambda kv: -kv[1][0])},
            refiner={key: fac._refiner.stats[key] for key in (
                "host_applies", "cycles", "outers", "extended",
                "device_residuals")},
            applies=list(applies), harness=harness)
        row["csr_matvec_launches"] = (ck.LAUNCHES["csr_matvec_f64"]
                                      - launched)
        del prof, held
        row["sweep_routes"] = sweep_routes(request, seed, 100 + k, acts)
        row["sweep_counts"] = dict(fac.engine.sweep_counts)
        out["seeds"][seed] = row
        log(f"# seed {seed}: window {row['window_s']:.4f} s, busy "
            f"{busy:.4f} s, idle {100 * row['idle_share']:.2f}%, put down "
            f"to a span {100 * (row['explained'] or 0):.2f}% [{card}]")
        log(f"#   refiner (last request) {row['refiner']}; csr_matvec "
            f"launches over the seed's requests "
            f"{row['csr_matvec_launches']}; applications per traced "
            f"request {row['applies']} of {sweep_bytes} bytes a sweep")
        for name in {**row["idle_under_ms"], **row["spans_ms"]}:
            ms = row["idle_under_ms"].get(name, 0.0)
            span_ms = row["spans_ms"].get(name, [0.0, 0])
            log(f"#   {name:34s} idle {ms:9.3f} ms/request; span "
                f"{span_ms[0]:9.3f} ms x {span_ms[1]:g}")
        if harness is not None:
            log("#   harness idle_gaps: " + ", ".join(
                f"{name} {s:.4f}" for name, s in harness["idle_gaps"]))
        log(f"#   sweep_counts {row['sweep_counts']}; one more request's "
            f"sweeps (route, launch calls): {row['sweep_routes']}")
    out["sweep_ops"] = sweep_ops(fac.engine, nrhs, dev, acts)
    log(f"# one sweep of {nrhs} rhs, device operations and launch calls: "
        f"{out['sweep_ops']} [{card}]")
    if args.cost:
        seed = int(args.seeds.split(",")[0])
        for traced in (True, False):
            on, off = [], []
            with (tr.traced(dev) if traced else contextlib.nullcontext()):
                for i in range(args.cost):
                    # one request each side, each first in every other pair
                    for side in ((on, off) if i % 2 == 0 else (off, on)):
                        with (spans_off() if side is off
                              else contextlib.nullcontext()):
                            side.append(request(seed, 200 + i))
            m_on, m_off = statistics.median(on), statistics.median(off)
            diff = statistics.median(a - b for a, b in zip(on, off))
            key = "cost_traced" if traced else "cost_untraced"
            out[key] = dict(requests=len(on), median_on_ms=1e3 * m_on,
                            median_off_ms=1e3 * m_off,
                            median_pair_diff_ms=1e3 * diff,
                            share=diff / m_off)
            log(f"# {key}: median {1e3 * m_on:.3f} ms with spans, "
                f"{1e3 * m_off:.3f} ms without; median pair difference "
                f"{1e3 * diff:+.3f} ms ({100 * diff / m_off:+.2f}%), "
                f"{len(on)} requests each [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({key: v for key, v in out.items() if key != "seeds"},
                     default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
