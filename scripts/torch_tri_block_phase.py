#!/usr/bin/env python3
"""chip_smoke's phase 14 alone: the triangle kernel (``tri_block_apply``,
R2) at the diagonal blocks of one sweep of each benchmark configuration,
timed by kernel, library route and plain version at 1-32 columns, its
first and last blocks of every round held bit for bit to the plain
version (``chip_smoke.phase_tri_block``).

Each configuration's rounds and pack block come from an engine built with
``factorize=False`` on the configuration's own matrix, as
``benchmark/run.py`` assembles it (``benchmark.run.problem``; the first
run in a checkout builds and caches it), so no factor is computed. Needs a
CUDA card; about 1.5 minutes with the two matrices built.

    python3 scripts/torch_tri_block_phase.py [--workloads A,B] [--out F]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from benchmark import run as bench  # noqa: E402


def sweep_rounds(workload: str, device) -> tuple:
    """The (B, P) rounds and the pack block of ``workload``'s engine."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        IndexMaps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (
        TorchMultifrontal)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell = bench.find(spec["workloads"], workload, "workload")
    config = bench.load_json(ROOT / bench.find(
        spec["configs"], cell["config"], "config")["file"])
    prob = bench.problem(cell["config"], config)
    maps = IndexMaps(tracer_state_len=int(prob["tracer_state_len"]),
                     int3_to_ind=prob["int3_to_ind"],
                     ind_to_i=prob["ind_to_i"], ind_to_j=prob["ind_to_j"],
                     ind_to_k=prob["ind_to_k"])
    matrix = SparseMatrix(nzval=prob["nzval"], colind=prob["colind"],
                          rowptr=prob["rowptr"],
                          coupled_tracer_cnt=config["coupled_tracer_cnt"])
    sym = symbolic_from_matrix(maps, matrix, leaf_size=config["leaf_size"])
    eng = TorchMultifrontal(sym, matrix, device, factorize=False)
    return [(p.B, p.P) for p in eng.plans], eng._pack_bs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", default="gx3deep_centered.apply,"
                    "gx3deep_upwind3.apply")
    ap.add_argument("--out", default=None,
                    help="write the phase's result here as JSON")
    args = ap.parse_args(argv)
    import torch
    from nk_ocn_tracer_jacobian_precond_tpu_torch.device import card_name
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import (
        cuda_kernels as ck)
    if not torch.cuda.is_available():
        raise SystemExit("torch_tri_block_phase: no CUDA device")
    device = torch.device("cuda", 0)
    ck.build()
    configs = {w: sweep_rounds(w, device)
               for w in args.workloads.split(",")}
    out = chip_smoke.phase_tri_block(ck, device, configs, card_name(device))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
