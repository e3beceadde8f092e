"""The port's Newton-Krylov outer loop (drivers/nk_loop.py) against the
same steps through the JAX package, on the CPU at a small grid.

bench.py's bench_nk_loop runs, per iteration, the jitted value update
plan.update(s * c) on the stacked fields of the first assembly, the
facade's refactor on the new values and its refined 4-RHS solve. The port
runs the same steps with the same seeds on its own gen_A problem: every
iteration's new values must equal the JAX loop's bit for bit (with bench's
options the fold has one column, so there is no add for XLA:CPU to
contract), and every residual is at most 1e-10. The solutions agree to
1e-12 relative, not to the 1e-13 of ROADMAP queue 3's refined solves: the
loop refines only to tol 1e-10, which one plain-refinement correction
reaches (residuals 4e-13 to 1e-12 here), so each package's iterate keeps
what its own unrefined solve left after one step (measured 5.8e-14,
1.5e-13 and 2.1e-13 apart in iterations 1-3 on this grid; up to 1.4e-12
on bench's tiny grid).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.grid import gen_ind_maps as ref_maps
from nk_ocn_tracer_jacobian_precond_tpu.grid.grid import (
    load_grid as ref_grid)
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import (
    load_ind_maps as ref_load_maps)
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
    SparseMatrix as RefSparseMatrix, read_matrix_file as ref_read_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions as RefOptions, PerTracerOptions as RefPerTracer,
    assemble_jacobian as ref_assemble)
from nk_ocn_tracer_jacobian_precond_tpu.ops.device_update import (
    build_update_plan as ref_build_plan)
from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
    FileFieldSource as RefSource)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as RefFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix as ref_symbolic)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop

DIMS = dict(imt=20, jmt=16, km=6)
N_ITER = 2
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loop(mat: str, circ: str, B: np.ndarray, precision: str = "f64"):
    """bench.py:139-190 through the JAX package at ``precision``: the
    update plan, and per iteration (new values, solutions, residual, the
    factor dtype after the solve)."""
    matrix, maps = ref_read_matrix(mat), ref_load_maps(mat)
    sym = ref_symbolic(maps, matrix, leaf_size=16)
    fac = RefFactorization(matrix, impl="jax", maps=maps, sym=sym,
                           refine_tol=TOL, precision=precision)
    pt = RefPerTracer(sink_type="const", sink_rate=1.21e-4)
    opts = RefOptions(circ_fname=circ, adv_type="centered",
                      hmix_type="isop_file", vmix_type="file",
                      per_tracer=[pt])
    grid = ref_grid(circ, None)
    asm = ref_assemble(grid, opts, RefSource(circ), None,
                       ref_maps(np.asarray(grid.KMT), grid.km))
    plan = ref_build_plan(asm, matrix)
    stacked0 = jnp.asarray(plan.stack_fields(asm))
    upd_fn = jax.jit(lambda s, c: plan.update(s * c))
    out = []
    rng = np.random.default_rng(42)
    for _ in range(N_ITER):
        c = jnp.asarray(1.0 + 1e-3 * rng.standard_normal(plan.total))
        nz = np.asarray(upd_fn(stacked0, c))
        m_new = RefSparseMatrix(nzval=nz, colind=matrix.colind,
                                rowptr=matrix.rowptr,
                                coupled_tracer_cnt=matrix.coupled_tracer_cnt)
        fac.refactor(m_new)
        X = fac.solve(B)
        out.append((nz, X, nk_loop.residual(m_new, X, B),
                    np.dtype(fac.engine.prec).name))
    return plan, out


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_nk_loop"))
    matrix, maps, circ = nk_loop.build_problem(DIMS, d)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    port = nk_loop.run_nk_loop(matrix, maps, circ, B, N_ITER, tol=TOL,
                               device="cpu")
    mat = circ.replace("circ_", "matrix_")
    assert os.path.exists(mat)
    return port, _jax_loop(mat, circ, B), matrix, B


def test_update_plan_equals_jax(loops):
    port, (plan, _), _, _ = loops
    assert port.plan.layout == plan.layout and port.plan.total == plan.total
    np.testing.assert_array_equal(port.plan.ell_src, plan.ell_src)
    # bench's options: one column, no duplicate sums
    assert port.plan.ell_src.shape[1] == 1
    assert port.stacked0.device == torch.device("cpu")


def test_new_values_bitwise_equal_jax(loops):
    port, (_, ref), matrix, _ = loops
    assert len(port.nzvals) == len(ref) == N_ITER
    for it, (nz, (want, _, _, _)) in enumerate(zip(port.nzvals, ref), 1):
        np.testing.assert_array_equal(nz, want, err_msg=f"iteration {it}")
        assert not np.array_equal(nz, matrix.nzval)
    # the facade holds the last iteration's values
    np.testing.assert_array_equal(port.factorization.matrix.nzval,
                                  ref[-1][0])


def test_solutions_and_residuals(loops):
    port, (_, ref), _, B = loops
    for row, X, (_, X_ref, res_ref, _) in zip(port.rows, port.solutions,
                                                 ref):
        assert X.shape == B.shape and np.all(np.isfinite(X))
        assert row["residual"] <= 1e-10 and res_ref <= 1e-10
        rel = float(np.abs(X - X_ref).max() / np.abs(X_ref).max())
        assert rel <= 1e-12, (row["it"], rel)


def test_rows_and_summary(loops):
    port, _, _, _ = loops
    assert [r["it"] for r in port.rows] == list(range(1, N_ITER + 1))
    for r in port.rows:
        assert min(r["assemble"], r["refactor"], r["solve"]) > 0
        split = r["refactor_split"]
        assert set(split) == {"to_scipy", "equilibrate", "rebind", "factor"}
        assert sum(split.values()) <= r["refactor"]
        assert r["refiner"]["best_rel"] <= 1e-10
    assert min(port.symbolic_s, port.cold_factor_s, port.update_plan_s) > 0
    out = nk_loop.summary(port, 4, "small")
    assert out["unit"] == "s" and "vs_baseline" not in out
    assert "[RESIDUAL NOT MET]" not in out["metric"]
    steady = port.rows[1:]
    assert out["value"] == round(float(np.mean(
        [r["assemble"] + r["refactor"] + r["solve"] for r in steady])), 4)
    assert set(out) == {"metric", "value", "unit", "iterations",
                        "symbolic_s_once", "cold_factor_s_once"}
    json.dumps(out, default=float)
    with_base = nk_loop.summary(port, 4, "small", baseline_s=2.0)
    assert abs(with_base["vs_baseline"] - 2.0 / out["value"]) < 2e-3


def test_cli_on_cpu(tmp_path, capsys):
    """The CLI at the tiny size, on the CPU when named: bench's JSON line
    as the last line of stdout; the cache directory is reused."""
    argv = ["--size", "tiny", "--iterations", "1", "--nrhs", "2",
            "--device", "cpu", "--cache", str(tmp_path)]
    assert nk_loop.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"].startswith("NK outer-loop per-iteration cost "
                                    "(assemble+refactor+2-rhs solve), tiny")
    assert out["iterations"][0]["residual"] <= 1e-10
    made = sorted(os.listdir(tmp_path))
    assert made == ["circ_24x20x8.nc", "matrix_24x20x8.nc"]
    assert nk_loop.main(argv) == 0
    assert sorted(os.listdir(tmp_path)) == made
