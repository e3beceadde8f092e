"""The roofline's counts on the tiny plan, against hand arithmetic."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference import stage1
from benchmark.tests.test_harness_reference import config


@pytest.fixture(scope="module")
def tiny():
    """The tiny centered matrix's round plans (leaf 16) and its nnz."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        IndexMaps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import (
        build_plan)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    r = stage1.assemble(config("centered"))
    m = SparseMatrix(nzval=r["nzval"], colind=r["colind"],
                     rowptr=r["rowptr"], coupled_tracer_cnt=1)
    maps = IndexMaps(**{k: r[k] for k in (
        "tracer_state_len", "int3_to_ind", "ind_to_i", "ind_to_j",
        "ind_to_k")})
    sym = symbolic_from_matrix(maps, m, leaf_size=16)
    return build_plan(sym, m), len(r["nzval"])


def test_one_panel_by_hand(tiny):
    plans, _ = tiny
    p = next(p for p in plans if p.B > 2 and p.P <= roofline.PANEL)
    P = p.P
    # one panel of R = T = P rows: sum over k of (P-k-1) divisions and
    # (P-k-1)^2 multiply-adds, i.e. sum_m m + 2 m^2 for m < P
    flops = P * (P - 1) / 2 + 2 * (P - 1) * P * (2 * P - 1) / 6
    nbytes = 2 * P * P * 8 + P * 8 + 4
    assert roofline.panel_work(1, P, 8) == (nbytes, flops)
    assert roofline.panel_work(p.B, P, 8) == (p.B * nbytes, p.B * flops)


def test_two_panels_by_hand():
    # P = 200: a 200 x 128 panel, then a 72 x 72 one
    f1 = sum((200 - k - 1) * (1 + 2 * (128 - k - 1)) for k in range(128))
    f2 = sum((72 - k - 1) * (1 + 2 * (72 - k - 1)) for k in range(72))
    b = (2 * 200 * 128 * 4 + 200 * 8 + 4) + (2 * 72 * 72 * 4 + 72 * 8 + 4)
    assert roofline.panel_work(3, 200, 4) == (3 * b, 3 * (f1 + f2))


def test_one_assembled_front_by_hand(tiny):
    plans, nnz = tiny
    p = plans[0]
    b = int(np.argmax(p.p_arr))
    entries = 0
    for row in range(p.N):
        for w in range(p.a_csrc.shape[2]):
            entries += int(p.a_csrc[b, row, w] != nnz)
    entries += sum(int(s != nnz) for s in p.a_src[b])
    front = SimpleNamespace(B=1, N=p.N, a_csrc=p.a_csrc[b:b + 1],
                            a_src=p.a_src[b:b + 1])
    assert roofline.assemble_work(front, nnz, 8) == (
        p.N * p.N * 8 + entries * (8 + 8 + 8), 0.0)


def test_every_entry_is_assembled_once(tiny):
    plans, nnz = tiny
    item = 8
    fronts = sum(p.B * p.N * p.N * item for p in plans)
    total = sum(roofline.assemble_work(p, nnz, item)[0] for p in plans)
    assert total == fronts + nnz * (item + 16)


def test_least_time_takes_the_larger_bound():
    t, by = roofline.least_s(3.35e12, 1.0, "float64")
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.least_s(1.0, 2 * 67e12, "float64")
    assert (t, by) == (pytest.approx(2.0), "operations")
    t, _ = roofline.stage_least_s("panel", [SimpleNamespace(B=1, P=3)], [0],
                                  0, "float64")
    assert t == pytest.approx((2 * 9 * 8 + 3 * 8 + 4) / 3.35e12)
