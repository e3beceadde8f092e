"""The torch package's copy of the round-plan builder against the JAX one.

``nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan`` copies
``mf_jax.build_plan`` and its helpers (mf_jax imports jax, so the port
cannot import them). Each package builds its plan from its own symbolic
analysis of the matrix its own reader loads (the port's ``symbolic`` and
``matrixfile`` are copies too). Every round, field and child group must
be equal, or the two engines factor different fronts.
"""

import numpy as np
import pytest

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                     PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import indmap
from nk_ocn_tracer_jacobian_precond_tpu_torch.io import matrixfile
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import plan, symbolic

# (imt, jmt, km, seed, extra assembly options): the 20x16x6 fixture of
# tests/test_mf_jax.py and the bench "tiny" problem (seed 7)
PROBLEMS = {
    "fixture": (20, 16, 6, 33, {}),
    "tiny": (24, 20, 8, 7, {"adv_type": "centered"}),
}


def _problem(d, name):
    imt, jmt, km, seed, extra = PROBLEMS[name]
    circ, mat = str(d / f"{name}_circ.nc"), str(d / f"{name}_m.nc")
    make_circ_file(circ, imt=imt, jmt=jmt, km=km, seed=seed)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt],
                                        **extra))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    p_matrix = matrixfile.read_matrix_file(mat)
    p_maps = indmap.load_ind_maps(mat)
    return (matrix, symbolic_from_matrix(maps, matrix, leaf_size=32),
            p_matrix, symbolic.symbolic_from_matrix(p_maps, p_matrix,
                                                    leaf_size=32))


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_plan")
    return {name: _problem(d, name) for name in PROBLEMS}


def _assert_plans_equal(got, want):
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g.node_ids == w.node_ids, r
        assert (g.B, g.P, g.N, g.M) == (w.B, w.P, w.N, w.M), r
        for field in ("a_col", "a_csrc", "a_pos", "a_src", "p_arr",
                      "cells_own", "cells_bor"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (r, field)
        assert len(g.child_groups) == len(w.child_groups), r
        for cg, cw in zip(g.child_groups, w.child_groups):
            assert cg.src_round == cw.src_round
            for field in ("src_slots", "dst_slots", "inv"):
                a, b = getattr(cg, field), getattr(cw, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (r, field)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_build_plan_matches_jax(problems, name):
    matrix, sym, p_matrix, p_sym = problems[name]
    _assert_plans_equal(plan.build_plan(p_sym, p_matrix, batch_multiple=1),
                        mf_jax.build_plan(sym, matrix, batch_multiple=1))


def test_build_plan_matches_jax_with_spill(problems, monkeypatch):
    """Cap the ELL width estimate at 4 so rows spill, as
    tests/test_mf_jax.py::test_ell_spill_assembly_path does."""
    matrix, sym, p_matrix, p_sym = problems["fixture"]
    real_quantile = np.quantile
    monkeypatch.setattr(np, "quantile",
                        lambda a, q, **kw: min(real_quantile(a, q, **kw), 4.0))
    got = plan.build_plan(p_sym, p_matrix, batch_multiple=1)
    assert any((p.a_pos < p.N * p.N).any() for p in got)
    _assert_plans_equal(got, mf_jax.build_plan(sym, matrix, batch_multiple=1))


def test_build_plan_matches_jax_small_budget(problems):
    """A small memory budget splits rounds into several chunks."""
    matrix, sym, p_matrix, p_sym = problems["tiny"]
    got = plan.build_plan(p_sym, p_matrix, mem_budget_bytes=2e6)
    assert len(got) > len(plan.build_plan(p_sym, p_matrix))
    _assert_plans_equal(got, mf_jax.build_plan(sym, matrix,
                                               mem_budget_bytes=2e6))


def test_padding_helpers_match_jax():
    for x in range(0, 3000, 7):
        assert plan._pad_dim(x) == mf_jax._pad_dim(x)
        assert plan._round_up(x, 128) == mf_jax._round_up(x, 128)
        for mult in (1, 4):
            assert (plan._pad_batch(x, mult)
                    == mf_jax._pad_batch(x, mult))
