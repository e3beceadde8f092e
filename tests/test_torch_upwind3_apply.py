"""The reference's upwind3 deployment on the port's apply path, at a tiny
size on the CPU.

* The benchmark's frozen stage 1 (``benchmark/reference/stage1.py``) and
  the port's gen_A give the same CSR for upwind3 with derived transports:
  the port solves the matrix the reference judges against.
* The port's refined 1-RHS solves of the harness's seeded right-hand
  sides meet the 1e-10 contract, judged by the harness's plain reference
  (``benchmark/reference/check.py``: NumPy in long double, independent of
  the port), and the unrefined apply stays under the check's 1e-2.
* ``TorchMultifrontal.sweep_bytes`` equals ``benchmark/solve_roofline.py``'s
  count from the round plans, for tiny centered and upwind3, at the
  adaptive pack block and at one narrower than the top fronts (as 512 is
  at gx3deep upwind3).
* The solve's round spans carry their round's front shape (B, P, N), and
  the sweep's span its pack block.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import solve_roofline
from benchmark.reference import check, stage1
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import IndexMaps
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    SparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import profiling

DIMS = dict(imt=20, jmt=16, km=6)
# the benchmark configurations' leaf sizes
LEAF = {"centered": 16, "upwind3": 32}
TOL = 1e-10
SEEDS = [2 ** 31 + 7, 11, 3_000_000_123, 2 ** 31 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(adv_type: str) -> dict:
    return dict(grid=DIMS, circulation_seed=7,
                assembly=dict(adv_type=adv_type, hmix_type="isop_file",
                              vmix_type="file", sink_type="const",
                              sink_rate=1.21e-4, day_cnt=365.0,
                              l_adv_enforce_divfree=True))


@pytest.fixture(scope="module")
def problems() -> dict:
    """The frozen stage 1's CSR of each advection option at DIMS, as the
    harness hands it to the port: matrix, symbolic analysis, state length."""
    out = {}
    for adv_type in LEAF:
        r = stage1.assemble(config(adv_type))
        matrix = SparseMatrix(nzval=r["nzval"], colind=r["colind"],
                              rowptr=r["rowptr"], coupled_tracer_cnt=1)
        maps = IndexMaps(**{k: r[k] for k in (
            "tracer_state_len", "int3_to_ind", "ind_to_i", "ind_to_j",
            "ind_to_k")})
        sym = symbolic_from_matrix(maps, matrix, leaf_size=LEAF[adv_type])
        out[adv_type] = SimpleNamespace(r=r, matrix=matrix, sym=sym,
                                        n=int(r["tracer_state_len"]))
    return out


@pytest.fixture(scope="module")
def upwind3(problems):
    """The tiny upwind3 problem, factored once by the facade at float64
    on the CPU, and the plain reference over its CSR."""
    p = problems["upwind3"]
    p.fac = MultifrontalFactorization(p.matrix, sym=p.sym, device="cpu",
                                      refine_tol=TOL, precision="f64")
    p.ref = check.Reference(p.r["nzval"], p.r["colind"], p.r["rowptr"],
                            seed=0, scale=0.0)
    return p


def test_the_port_solves_the_frozen_stage1s_csr(problems, upwind3,
                                               tmp_path):
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import (
        run_gen_a)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        AssemblyOptions, PerTracerOptions)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata.transports import (
        derive_upwind3_transports)
    circ, mat = str(tmp_path / "circ.nc"), str(tmp_path / "matrix.nc")
    make_circ_file(circ, seed=7, **DIMS)
    derive_upwind3_transports(circ)
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, adv_type="upwind3", hmix_type="isop_file",
        vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.21e-4)]))
    m = read_matrix_file(mat)
    r = upwind3.r
    assert r["nzval"].tobytes() == m.nzval.astype(np.float64).tobytes()
    assert r["colind"].tobytes() == m.colind.astype(np.int64).tobytes()
    assert r["rowptr"].tobytes() == m.rowptr.astype(np.int64).tobytes()
    # upwind3's second neighbours: more entries a row than centered's
    centered = problems["centered"]
    assert len(r["nzval"]) > len(centered.r["nzval"]) * upwind3.n \
        / centered.n
    # the facade's refiner multiplies by that very CSR
    A = upwind3.fac._device_refiner().A.tocsr()
    assert np.array_equal(A.indptr, r["rowptr"])
    assert np.array_equal(A.indices, r["colind"])
    assert np.array_equal(A.data, r["nzval"])


@pytest.mark.parametrize("seed", SEEDS)
def test_refined_requests_meet_the_contract(upwind3, seed):
    """Three requests of the apply mix's seed, each a 1-RHS refined
    solve, judged in long double by the harness's reference; then the
    unrefined apply of the check's own right-hand side."""
    fac, ref, n = upwind3.fac, upwind3.ref, upwind3.n
    Bs = [check.step_rhs(n, seed, index, 1) for index in (1, 2, 3)]
    Xs = [fac.solve(B) for B in Bs]
    assert all(X.shape == (n, 1) for X in Xs)
    rels = ref.residuals(ref.values(0), Xs, Bs)
    assert max(float(r.max()) for r in rels) <= TOL
    st = fac._refiner.stats
    assert st["host_applies"] + st["cycles"] >= 1
    b_raw = check.raw_apply_rhs(n, seed)
    raw = ref.residuals(ref.values(0), [fac.solve(b_raw, refine=False)],
                        [b_raw])[0]
    assert float(raw.max()) <= 1e-2


@pytest.mark.parametrize("adv_type", ["centered", "upwind3"])
@pytest.mark.parametrize("pack", ["adaptive", "narrow"])
def test_sweep_bytes_equal_the_plans_count(problems, adv_type, pack,
                                           monkeypatch):
    p = problems[adv_type]
    if pack == "narrow":
        monkeypatch.setattr(mf_torch, "pack_block_size", lambda plans: 16)
    eng = mf_torch.TorchMultifrontal(p.sym, p.matrix, torch.device("cpu"))
    top = max(plan.P for plan in eng.plans)
    assert eng._pack_bs == (16 if pack == "narrow" else top)
    assert solve_roofline.state_len(eng.plans) == eng.flat_len == p.n
    for nrhs in (1, 4):
        want = solve_roofline.sweep_bytes(eng.plans, 8, nrhs)
        assert eng.sweep_bytes(nrhs) == want
    # the resident factors have the plans' padded shapes, perm in int64
    for (K, U12, L21, perm), q in zip(eng.factors, eng.plans):
        assert K.shape == (q.B, q.P, q.P) and perm.shape == (q.B, q.P)
        assert U12.shape == (q.B, q.P, q.M) and L21.shape == (q.B, q.M, q.P)
        assert K.dtype == torch.float64 and perm.dtype == torch.int64
    with pytest.raises(RuntimeError, match="no numeric factors"):
        mf_torch.TorchMultifrontal(p.sym, p.matrix, torch.device("cpu"),
                                   factorize=False).sweep_bytes()


@pytest.mark.parametrize("adv_type", ["centered", "upwind3"])
def test_round_spans_carry_the_front_shape(problems, adv_type):
    p = problems[adv_type]
    eng = mf_torch.TorchMultifrontal(p.sym, p.matrix, torch.device("cpu"))
    b = np.random.default_rng(3).standard_normal(p.n)
    with torch.profiler.profile(record_shapes=True) as prof:
        eng.solve(b)
    events = prof.profiler.kineto_results.events()
    nk = profiling.PREFIX
    sweeps = [e.kwinputs() for e in events if e.name() == nk + "engine.sweep"]
    assert [s["pack_bs"] for s in sweeps] == [eng._pack_bs]
    for side in ("fwd", "bwd"):
        got = sorted((a["round"], a["B"], a["P"], a["N"]) for a in (
            e.kwinputs() for e in events
            if e.name() == nk + "engine." + side))
        assert got == [(r, q.B, q.P, q.N) for r, q in enumerate(eng.plans)]
