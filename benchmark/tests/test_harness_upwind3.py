"""The upwind3 apply cell on the CPU at a tiny size, and the solve's
roofline: the result line of a run on ``configs/tiny_upwind3.json``,
``benchmark/solve_roofline.py``'s counts against hand arithmetic, and
``apply_roofline.apply`` on runs made by hand."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run, solve_roofline
from benchmark.reference import stage1
from benchmark.tests.conftest import ROOT

SEED = 2 ** 31 + 19
TINY = "tiny_upwind3"
CELL = f"{TINY}.apply"
TWIN = "gx3deep_upwind3.apply"
# what the new cell lists, and what of it the CPU reads (device metrics
# read nothing there)
LISTED = {0: {"rhs_per_s", "apply_p95_s", "peak_mem_gb", "setup_s"},
          1: {"refine_cycles_per_rhs.apply", "device_idle_share.apply",
              "apply_roofline.apply"}}
ON_CPU = {0: {"rhs_per_s", "apply_p95_s", "setup_s"},
          1: {"refine_cycles_per_rhs.apply"}}


@pytest.fixture(scope="module")
def spec():
    """BENCHMARK.json with the tiny upwind3 configuration's apply cell
    added, reporting what the gx3deep upwind3 cell reports."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name=TINY, source="benchmark/tests/configs", reduced=["grid"],
        file=f"benchmark/tests/configs/{TINY}.json", why="CPU tests"))
    spec["workloads"].append(dict(name=CELL, config=TINY, traffic="apply",
                                  chips=1, why="CPU tests"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if TWIN in m.get("workloads", []):
            m["workloads"].append(CELL)
    return spec


@pytest.fixture(scope="module")
def plans():
    """The tiny upwind3 matrix's round plans (leaf 32), its nnz and n."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        IndexMaps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    config = json.loads((ROOT / "benchmark" / "tests" / "configs"
                         / f"{TINY}.json").read_text())
    r = stage1.assemble(config)
    m = SparseMatrix(nzval=r["nzval"], colind=r["colind"],
                     rowptr=r["rowptr"], coupled_tracer_cnt=1)
    maps = IndexMaps(**{k: r[k] for k in (
        "tracer_state_len", "int3_to_ind", "ind_to_i", "ind_to_j",
        "ind_to_k")})
    sym = symbolic_from_matrix(maps, m, leaf_size=config["leaf_size"])
    return SimpleNamespace(plans=build_plan(sym, m), nnz=len(r["nzval"]),
                           n=int(r["tracer_state_len"]))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(spec, trace):
    out = run.run_cell(spec, CELL, SEED, 1.0, bool(trace), device="cpu",
                       log=lambda _msg: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 20
    assert {m["name"] for m in run.cell_metrics(spec, CELL, trace)} \
        == LISTED[trace]
    assert set(out["metrics"]) == ON_CPU[trace]
    assert out["checks"]["max_rel_residual"]["value"] <= 1e-10
    assert out["device"]["platform"] == "cpu"
    json.dumps(out)


def test_the_cells_share_the_apply_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in ("gx3deep_centered.apply", TWIN):
        assert {m["name"] for m in run.cell_metrics(spec, cell, True)} \
            == LISTED[1]
        assert {m["name"] for m in run.cell_metrics(spec, cell, False)} \
            == LISTED[0]


def test_one_front_by_hand(plans):
    q = next(p for p in plans.plans if p.B > 1 and p.M > 0)
    b = int(np.argmax(q.p_arr))
    p = int(q.p_arr[b])
    front = SimpleNamespace(B=1, P=q.P, M=q.M, p_arr=q.p_arr[b:b + 1])
    # K (P, P), U12 (P, M) and L21 (M, P) at 8 bytes, perm (P,) int64;
    # the workspace of the p cells and the dump row read and written
    assert solve_roofline.state_len([front]) == p
    assert solve_roofline.sweep_bytes([front], 8) == (
        q.P * q.P * 8 + 2 * q.P * q.M * 8 + q.P * 8 + 2 * (p + 1) * 8)
    assert solve_roofline.sweep_bytes([front], 4, nrhs=3) == (
        q.P * q.P * 4 + 2 * q.P * q.M * 4 + q.P * 8 + 2 * (p + 1) * 3 * 4)
    assert solve_roofline.residual_bytes(10, 4, 2) == 120 + 20 + 128
    st = dict(host_applies=2, cycles=1)
    assert solve_roofline.request_bytes([front], 10, 8, st, 1) == (
        3 * solve_roofline.sweep_bytes([front], 8)
        + 2 * solve_roofline.residual_bytes(10, p))


def test_every_cell_is_counted(plans):
    assert solve_roofline.state_len(plans.plans) == plans.n
    total = solve_roofline.sweep_bytes(plans.plans, 8)
    fronts = sum(solve_roofline.sweep_bytes([p], 8) for p in plans.plans)
    # one workspace pass in the whole sweep, not one a round
    assert total == fronts - 2 * 8 * (len(plans.plans) - 1)


def _run(plans, busy_s, steps):
    return run.Run(trace=None if busy_s is None else dict(
        busy_s=busy_s, window_s=2 * (busy_s or 1.0)), steps=steps,
        plans=plans.plans, nnz=plans.nnz, dtype="float64")


def test_apply_roofline_by_hand(plans):
    read = run.load_reader("apply_roofline.apply")
    st = dict(host_applies=2, cycles=0, outers=3, rels=[])
    steps = ([dict(phase="window", nrhs=1, refiner=st)] * 5
             + [dict(phase="traced", nrhs=1, refiner=st)] * 8)
    least = solve_roofline.least_s(8 * solve_roofline.request_bytes(
        plans.plans, plans.nnz, 8, st, 1))
    assert read(_run(plans, None, steps)) is None
    assert read(_run(plans, 0.0, steps)) is None
    assert read(_run(plans, 1.0, steps[:5])) is None
    assert read(_run(plans, least, steps)) == pytest.approx(100.0)
    got = read(_run(plans, 4 * least, steps))
    assert got == pytest.approx(25.0) and 0 < got <= 100
