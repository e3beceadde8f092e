#!/usr/bin/env python3
"""The readings that the check's limits are set from, at a cell's own
size: the program as the configuration states it (the lower readings)
and the control (the upper readings), every seed in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        [--seeds a,b,...] [--control-seeds c,d,...] [--stale-seeds e,f,...]

The control is the program's own lower-precision path: float32 factors
for the configuration's float64, and no refinement (the refined solve
would put float32 factors back at the contract, which is a sound run,
not a control). It has to come out as not correct. ``stale_engine`` is
the fault of a refactor that leaves the engine's factors as they were
(the facade still takes the new values and scaling, so the refined
solve may meet the contract): in a cell that refactors, the unrefined
apply has to catch it. One JSON line per run: the variant, the seed,
``correct`` and the numbers compared. The benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark.run import (  # noqa: E402
    HOST_THREADS, ROOT, load_json, run_cell, use_checkout_caches)

LOWER = {"f64": "f32"}


@contextlib.contextmanager
def stale_engine():
    """The engine's refactor does nothing: its factors stay those of the
    last factorization it made."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
    real = mf_torch.TorchMultifrontal.refactor
    mf_torch.TorchMultifrontal.refactor = lambda self, matrix: None
    try:
        yield
    finally:
        mf_torch.TorchMultifrontal.refactor = real


def readings(spec: dict, workload: str, seconds: float, seeds, control_seeds,
             stale_seeds=(), device: str = "cuda", log=print) -> list:
    """One row per run: variant ("program", "control" or "stale_engine"),
    seed, correct, checks."""
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    prec = load_json(ROOT / config["file"])["factor_precision"]
    rows = []
    for variant, seeds_, kw, ctx in (
            ("program", seeds, {}, contextlib.nullcontext),
            ("control", control_seeds,
             dict(precision=LOWER[prec], refine=False),
             contextlib.nullcontext),
            ("stale_engine", stale_seeds, {}, stale_engine)):
        for seed in seeds_:
            with ctx():
                out = run_cell(spec, workload, seed, seconds, False,
                               device=device, log=log, **kw)
            rows.append(dict(variant=variant, seed=seed,
                             correct=out["correct"], checks=out["checks"]))
            log(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--stale-seeds", default="")
    args = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    use_checkout_caches()
    import torch
    torch.set_num_threads(HOST_THREADS)
    spec = load_json(ROOT / "BENCHMARK.json")
    readings(spec, args.workload, args.seconds, ints(args.seeds),
             ints(args.control_seeds), ints(args.stale_seeds),
             log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
