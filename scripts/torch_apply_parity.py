#!/usr/bin/env python3
"""Two checkouts of the port on the same requests of a benchmark cell:
whether they return the same solutions, bit for bit, with the same
refiner decisions.

For each checkout root (its package directory first on ``sys.path``, the
benchmark of this checkout), a process of its own builds the cell's
configuration and factor as ``benchmark/run.py`` does (``apply_cell.py``)
and solves the mix's first ``--requests`` right-hand sides of each seed
(``check.step_rhs``).
It records every solution, the refiner's ``stats`` (phases, ``rels``,
plain applies, outer steps, device residuals), the host SpMVs that the
facade's and the refiner's scipy matrices ran (``@``), the product
kernel's launches and each request's latency. The first process's
solutions are then compared with each other one's: equal bits, the
largest difference relative to the largest entry, and the ``rels``
differences. The mix must not refactor.

    python3 scripts/torch_apply_parity.py ROOT_A ROOT_B --seeds 11,12
        [--requests 20] [--workload gx3deep_centered.apply]
        [--spec BENCHMARK.json] [--device cuda]
        [--out parity.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class CountedMatrix:
    """A scipy matrix that counts its products with ``@``."""

    def __init__(self, A):
        self._A, self.products = A, 0

    def __getattr__(self, name):
        return getattr(self._A, name)

    def __matmul__(self, other):
        self.products += 1
        return self._A @ other


def one(root: str, args, out: str) -> None:
    """Solve in this process with the package of ``root``; write the
    solutions and records to the npz ``out``."""
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.insert(1, str(HERE))
    from benchmark import run as bench
    bench.use_checkout_caches()
    import numpy as np
    import torch

    import apply_cell
    from benchmark.reference import check
    import nk_ocn_tracer_jacobian_precond_tpu_torch as pkg
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    torch.set_num_threads(bench.HOST_THREADS)
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = torch.device(args.device)
    cell = apply_cell.build(args.workload, dev, "torch_apply_parity",
                            Path(args.spec))
    fac, n, traffic = cell["fac"], cell["n"], cell["traffic"]
    fac.A = CountedMatrix(fac.A)
    refiner = fac._device_refiner()
    refiner.A = CountedMatrix(refiner.A)
    rec = dict(package=str(Path(pkg.__file__).parent), requests=[])
    arrays = {}
    launches = ck.LAUNCHES.get("csr_matvec_f64")
    for seed in seeds:
        for index in range(1, args.requests + 1):
            B = check.step_rhs(n, seed, index, traffic["rhs_per_step"])
            spmv = fac.A.products + refiner.A.products
            t0 = time.perf_counter()
            X = fac.solve(B)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            lat = time.perf_counter() - t0
            st = refiner.stats
            arrays[f"{seed}_{index}"] = np.asarray(X)
            rec["requests"].append(dict(
                seed=seed, index=index, latency_s=lat,
                host_spmv=fac.A.products + refiner.A.products - spmv,
                **{k: st.get(k) for k in ("phases", "rels", "host_applies",
                                          "outers", "extended",
                                          "device_residuals")}))
    if launches is not None:
        rec["csr_matvec_launches"] = (ck.LAUNCHES["csr_matvec_f64"]
                                      - launches)
    np.savez(out, **arrays)
    Path(out + ".json").write_text(json.dumps(rec, default=float))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_apply_parity",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--workload", default="gx3deep_centered.apply")
    p.add_argument("--spec", default=str(HERE / "BENCHMARK.json"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        one(args.roots[0], args, args.one)
        return 0
    import numpy as np
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="apply_parity_") as tmp:
        sides = []
        for i, root in enumerate(args.roots):
            out = str(Path(tmp) / f"side{i}")
            subprocess.run([sys.executable, __file__, root, "--seeds",
                            args.seeds, "--requests", str(args.requests),
                            "--workload", args.workload, "--spec",
                            args.spec, "--device", args.device, "--one",
                            out], check=True)
            rec = json.loads(Path(out + ".json").read_text())
            sides.append((rec, np.load(out + ".npz")))
        (ref, xa), result = sides[0], dict(roots=args.roots, sides=[])
        for root, (rec, xb) in zip(args.roots, sides):
            lat = sorted(r["latency_s"] for r in rec["requests"])
            row = dict(
                root=root, package=rec["package"],
                host_spmv=sum(r["host_spmv"] for r in rec["requests"]),
                device_residuals=sum(r["device_residuals"] or 0
                                     for r in rec["requests"]),
                csr_matvec_launches=rec.get("csr_matvec_launches"),
                phases=sorted({tuple(r["phases"])
                               for r in rec["requests"]}),
                median_latency_s=lat[len(lat) // 2],
                bitwise=0, max_rel_diff=0.0, max_rels_rel_diff=0.0,
                same_decisions=0)
            for a, b in zip(ref["requests"], rec["requests"]):
                key = f"{a['seed']}_{a['index']}"
                Xa, Xb = xa[key], xb[key]
                row["bitwise"] += int(np.array_equal(
                    Xa.view(np.int64), Xb.view(np.int64)))
                row["max_rel_diff"] = max(row["max_rel_diff"], float(
                    np.abs(Xa - Xb).max() / np.abs(Xa).max()))
                ra, rb = np.array(a["rels"]), np.array(b["rels"])
                if ra.shape == rb.shape:
                    row["max_rels_rel_diff"] = max(
                        row["max_rels_rel_diff"],
                        float((np.abs(ra - rb) / ra).max()))
                row["same_decisions"] += int(
                    a["phases"] == b["phases"]
                    and a["outers"] == b["outers"]
                    and a["host_applies"] == b["host_applies"]
                    and ra.shape == rb.shape)
            row["requests"] = len(rec["requests"])
            result["sides"].append(row)
            log(f"# {root}: {row}")
            log(f"#   rels of request 1: "
                f"{rec['requests'][0]['rels']}")
    line = json.dumps(result, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
