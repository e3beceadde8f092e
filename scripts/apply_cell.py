"""A benchmark cell's configuration and factor, built as
``benchmark/run.py`` builds them (its matrix, one factor of the
configuration's own values), for the scripts that read a cell's requests
on one factor: ``torch_apply_spans.py`` and ``torch_apply_parity.py``.
The package is whichever ``nk_ocn_tracer_jacobian_precond_tpu_torch`` is
first on ``sys.path``; ``benchmark`` is this checkout's."""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(workload: str, device, tool: str,
          spec_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``workload``'s facade on ``device`` and what its requests
    need: ``fac``, ``n`` (the state length), ``traffic`` and ``config``.
    Raises SystemExit, naming ``tool``, for a mix that refactors."""
    from benchmark import run as bench
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        IndexMaps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    spec = bench.load_json(Path(spec_path))
    cell = bench.find(spec["workloads"], workload, "workload")
    config = bench.load_json(ROOT / bench.find(
        spec["configs"], cell["config"], "config")["file"])
    traffic = bench.load_json(ROOT / "benchmark" / "traffic"
                              / f"{cell['traffic']}.json")
    if traffic["refactor_every_step"] or traffic["value_perturbation"]:
        raise SystemExit(f"{tool}: the mix refactors; it reads requests on "
                         f"one factor")
    prob = bench.problem(cell["config"], config)
    n = int(prob["tracer_state_len"])
    maps = IndexMaps(tracer_state_len=n, int3_to_ind=prob["int3_to_ind"],
                     ind_to_i=prob["ind_to_i"], ind_to_j=prob["ind_to_j"],
                     ind_to_k=prob["ind_to_k"])
    matrix = SparseMatrix(nzval=prob["nzval"], colind=prob["colind"],
                          rowptr=prob["rowptr"],
                          coupled_tracer_cnt=config["coupled_tracer_cnt"])
    sym = symbolic_from_matrix(maps, matrix, leaf_size=config["leaf_size"])
    fac = MultifrontalFactorization(
        matrix, sym=sym, refine_tol=config["refine_tol"], device=device,
        precision=config["factor_precision"])
    return dict(fac=fac, n=n, traffic=traffic, config=config)
