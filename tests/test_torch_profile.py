"""The port's profile (drivers/profile.py over the stage timer of
utils/profiling.py, entered on mf_torch's own round loop) on the CPU at
f64, against the JAX package's profilers on the 20x16x6 fixture of
tests/test_mf_jax.py.

* The per-round rows (B, P, N, child groups) are what
  scripts/profile_f64_rounds.py prints from JaxMultifrontal's plans, and
  ranked_costs keys them as scripts/profile_factor.py does.
* The timer changes nothing: profiled factors equal unprofiled ones.
* Call counts follow the plans (assembly once per round; the library LU
  once per round of at most two fronts on one device, never under a mesh;
  the panel once per 128-column panel of the other rounds), every
  exclusive time is >= 0 and the stages plus the walk add up to the wall.
* The refined solve meets the contract; the CLI prints its JSON line on
  the CPU and refuses cuda without a card.
* On a gloo world of 2 ranks each rank times its own rounds.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
    read_matrix_file as jax_read)
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import (
    load_ind_maps as jax_maps)
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                    PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    equilibrate as jax_equilibrate)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import JaxMultifrontal
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix as jax_symbolic)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.nk_loop import (
    residuals)
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
    load_ind_maps)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils.profiling import (
    STAGES, StageTimer)
from test_torch_mesh import join_world, profile_world, start_world

WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The fixture's matrix file, a gloo world of 2 profiling it (started
    first, joined by its test), the port's facade profiled on one device,
    and the JAX engine's plans."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("torch_profile")
    circ, mat = str(d / "circ.nc"), str(d / "matrix.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const",
                                     sink_rate=1.21e-4)]))
    world = start_world(WORLD, d, mat, target=profile_world)
    matrix = read_matrix_file(mat)
    fac = MultifrontalFactorization(matrix, maps=load_ind_maps(mat),
                                    device="cpu")
    prof = profile.profile_refactor(fac, "cpu")
    timed = [tuple(t.clone() for t in f) for f in fac.engine.factors]
    jm = jax_read(mat)
    jfac, _, _ = jax_equilibrate(jm)
    jeng = JaxMultifrontal(jax_symbolic(jax_maps(mat), jm), jfac,
                           factorize=False)
    return dict(matrix=matrix, fac=fac, prof=prof, timed=timed,
                jax_plans=jeng.plans, world=world, mat=mat)


def test_rows_are_the_jax_plans_rounds(run):
    """profile_f64_rounds.py's per-round columns from the JAX plans."""
    want = [(p.B, p.P, p.N, len(p.child_groups)) for p in run["jax_plans"]]
    got = [(r["B"], r["P"], r["N"], r["children"])
           for r in run["prof"]["rows"]]
    assert got == want
    assert [r["round"] for r in run["prof"]["rows"]] == list(range(len(want)))
    assert not any(r["loaded"] for r in run["prof"]["rows"])


def test_profiled_factors_equal_unprofiled(run):
    fac = run["fac"]
    assert not STAGES.active
    fac.refactor()
    for a, b in zip(run["timed"], fac.engine.factors):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_call_counts_follow_the_plans(run):
    plans, calls = run["fac"].engine.plans, run["prof"]["calls"]
    assert calls["assemble"] == len(plans)
    assert calls["extend_add"] == len(plans)
    assert calls["partial_factor"] == len(plans)
    assert calls["treetop_lu"] == sum(p.B <= 2 for p in plans) > 0
    panels = sum(math.ceil(p.P / 128) for p in plans if p.B > 2)
    assert calls["panel"] == calls["row_gather"] == panels > 0
    assert calls["gemm"] == calls["trsm"] <= panels
    # one pack per round: the library LU's and the panel path's
    assert calls["pack"] == len(plans)
    assert calls["ckpt_save"] == calls["ckpt_load"] == 0
    for r, p in zip(run["prof"]["rows"], plans):
        assert (r["treetop_lu"] > 0) == (p.B <= 2)
        assert (r["panel"] > 0) == (p.B > 2)


def test_times_add_up_to_the_wall(run):
    prof = run["prof"]
    for r in prof["rows"]:
        assert all(r[k] >= 0 for k in profile.STAGE_NAMES + ("walk", "ms"))
        assert math.isclose(sum(r[k] for k in profile.STAGE_NAMES)
                            + r["walk"], r["ms"], rel_tol=1e-9)
    stages = sum(prof["totals"].values())
    assert prof["walk_ms"] >= 0 and prof["outside_rounds_ms"] >= 0
    assert abs(stages + prof["walk_ms"] - prof["wall_ms"]) \
        <= 0.01 * prof["wall_ms"]
    assert abs(prof["rows_ms"] + prof["outside_rounds_ms"]
               - prof["wall_ms"]) <= 0.01 * prof["wall_ms"]


def test_ranked_costs_keys_follow_profile_factor(run):
    """profile_factor.py's keys (bench(f"assemble N={plan.N}"), f"extend
    N=..." per child group, f"factor B=.. P=.. N=.."), largest first."""
    ranked = profile.ranked_costs(run["prof"]["rows"])
    want = set()
    for p in run["jax_plans"]:
        want.add(f"assemble N={p.N}")
        if p.child_groups:
            want.add(f"extend N={p.N}")
        want.add(f"factor B={p.B} P={p.P} N={p.N}")
    assert {c["key"] for c in ranked} == want
    secs = [c["s"] for c in ranked]
    assert secs == sorted(secs, reverse=True)
    assert math.isclose(sum(c["share"] for c in ranked), 1.0)
    factor = sum(c["s"] for c in ranked if c["key"].startswith("factor"))
    assert math.isclose(factor * 1e3, sum(
        run["prof"]["totals"][k] for k in profile.FACTOR_STAGES),
        rel_tol=1e-9)


def test_profile_solve_meets_the_contract(run):
    matrix, fac = run["matrix"], run["fac"]
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    sol = profile.timed_solve(fac, matrix, B, "cpu")
    assert max(sol["residuals"]) <= 1e-10
    again = residuals(matrix, fac.solve(B), B)
    np.testing.assert_array_equal(sol["residuals"], again)
    assert sol["refiner"]["phases"] and sol["escalation"] is None


def test_timer_inactive_scopes_do_nothing():
    timer = StageTimer()
    assert timer.stage("x") is timer.round(0, None)
    with timer.stage("x"):
        pass
    assert not timer.calls and not timer.rounds
    with timer.recording("cpu") as t:
        with pytest.raises(RuntimeError):
            with timer.recording("cpu"):
                pass
        with t.stage("outer"):
            with t.stage("inner"):
                pass
    assert t.calls == {"outer": 1, "inner": 1} and not t.rounds
    assert 0 <= t.excl["inner"] <= t.top_ms <= t.wall_ms
    assert math.isclose(t.excl["outer"] + t.excl["inner"], t.top_ms)
    assert not t.active


def test_cli_prints_its_json_line(tmp_path):
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = profile.main(["--size", "tiny", "--device", "cpu", "--nrhs",
                           "2", "--cache", str(tmp_path)])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["ok"] and line["card"] == "cpu" and line["device"] == "cpu"
    assert len(line["profile"]["rows"]) == line["rounds"]
    assert line["ranked"][0]["s"] >= line["ranked"][-1]["s"]
    assert line["device_busy"]["device_busy_share"].startswith(
        "not measured")
    assert max(line["solve"]["residuals"]) <= 1e-10
    assert "round     B     P     N" in err.getvalue()


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.main(["--size", "tiny", "--cache", str(tmp_path)])


def test_each_rank_times_its_own_rounds(run):
    ranks = join_world(run["world"])
    plans = ranks[0]["plans"]
    assert all(r["plans"] == plans for r in ranks)
    # the batch-sharded rounds are each rank's own slice
    assert "batch" in ranks[0]["layouts"]
    panels = sum(math.ceil(P / 128) for _, P, _, _ in plans)
    for r in ranks:
        prof = r["prof"]
        assert r["same"]
        assert [(x["B"], x["P"], x["N"], x["children"])
                for x in prof["rows"]] == plans
        # a mesh engine never takes the library LU
        assert prof["calls"]["treetop_lu"] == 0
        assert prof["calls"]["panel"] == panels
        assert prof["calls"]["assemble"] == len(plans)
        assert abs(sum(prof["totals"].values()) + prof["walk_ms"]
                   - prof["wall_ms"]) <= 0.01 * prof["wall_ms"]
    assert ranks[0]["prof"]["rows"] != ranks[1]["prof"]["rows"]
