"""The port's mesh engine (mf_torch.TorchMultifrontal with a mesh, through
the facade's ``n_devices=``) on gloo worlds on the CPU, against the JAX
package's mesh engine on its simulated 8-device mesh.

tests/test_dist_solver.py's fixtures and right-hand sides go through both
packages: the 24x20x6 transport matrix (seed 11), the 16x14x5 coupled
tracers (seed 3). For 2 and 4 ranks one spawned world runs every case
(tests/test_torch_mesh.py::solver_world) and each rank's view is held
against ``MultifrontalFactorization(impl="jax", n_devices=k)``:

* the same rounds, perms equal per round and whole factors to 1e-12 of
  their largest entry (tests/test_torch_mf.py's per-round bar), the
  tree-top rounds of at most two fronts included, which go through the
  panel, never the library LU, under a mesh in both packages;
* ``row_shard_min=64`` (the JAX engine's patched ROW_SHARD_MIN) row-shards
  the tree-top rounds: K by columns with the diagonal-block stack (the
  masked substitution), U12 and L21 by the border;
* refined solutions at rtol 1e-10 / atol 1e-12 (1e-9 / 1e-11 where
  tests/test_dist_solver.py uses those), bit for bit alike on every rank,
  with the same refiner decisions on every rank;
* batch-sharded rounds hold B/k fronts per rank, and the memory plan's
  per-device factor bytes equal what each rank holds;
* an "rhs" axis (2 x rhs 2 of 4 ranks), float32 factors (2 ranks), the
  JAX mesh engine's own factors sliced to each rank (factors_from_jax)
  and solved by the port, round checkpoints written by the first rank and
  read back into each rank's slice, and n_devices beyond the world, which
  raises.

A mesh of one rank (no process group) runs in this process against the
JAX engine on a mesh of one device.
"""

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                    PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.parallel import make_mesh as jax_mesh
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxMF)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import JaxMultifrontal
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
    load_ind_maps as port_maps)
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    read_matrix_file as port_read)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import make_mesh
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from test_torch_mesh import (JaxFactors, join_world, solver_world,
                             start_world)

WORLDS = (2, 4)


def _rhs(seed, n, k):
    return np.random.default_rng(seed).standard_normal((n, k))


def _jax_factors(jf):
    return [tuple(None if a is None else np.asarray(a) for a in f)
            for f in jf.engine.factors]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The fixtures' matrix files, the JAX oracles, then one gloo world per
    rank count: ({k: per-rank results}, {oracle: values})."""
    d = tmp_path_factory.mktemp("torch_dist_solver")
    circ, mat = str(d / "circ.nc"), str(d / "matrix.nc")
    make_circ_file(circ, imt=24, jmt=20, km=6, seed=11)
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.21e-4)]))
    ccirc, cmat = str(d / "ccirc.nc"), str(d / "cmatrix.nc")
    make_circ_file(ccirc, imt=16, jmt=14, km=5, seed=3)
    run_gen_a(cmat, opts=AssemblyOptions(
        circ_fname=ccirc, hmix_type="const", vmix_type="const",
        coupled_tracer_cnt=2,
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1e-4),
                    PerTracerOptions(sink_type="const", sink_rate=2e-4)],
        coupled_tracer_type="OCMIP_BGC_PO4_DOP"))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    cm, cmaps = read_matrix_file(cmat), load_ind_maps(cmat)
    n = matrix.flat_len
    engine_rhs = _rhs(13, n, 2)
    oracle, started = {}, {}
    # the JAX engines whose factors the ranks slice come first; the other
    # oracles run while the worlds do
    for k in WORLDS:
        old = JaxMultifrontal.ROW_SHARD_MIN
        JaxMultifrontal.ROW_SHARD_MIN = 64
        try:
            jf = JaxMF(matrix, impl="jax", maps=maps, n_devices=k)
            rows = [jf.engine._row_sharded(p) for p in jf.engine.plans]
            oracle[k] = dict(
                factors=_jax_factors(jf), rows=rows,
                plans=[(p.B, p.P, p.N, p.M) for p in jf.engine.plans],
                X5=jf.solve(_rhs(5, n, 3)), X7=jf.solve(_rhs(7, n, 3)),
                Y=np.asarray(jf.engine.solve(engine_rhs)))
        finally:
            JaxMultifrontal.ROW_SHARD_MIN = old
        cases = dict(transport=mat, coupled=cmat, engine_rhs=engine_rhs,
                     jax=JaxFactors(oracle[k]["factors"], rows),
                     f32=k == 2, rhs=k == 4)
        started[k] = start_world(k, d, cases, target=solver_world)
    for k in WORLDS:
        oracle[k]["coupled"] = JaxMF(cm, impl="jax", maps=cmaps,
                                     n_devices=k).solve(
                                         _rhs(9, cm.flat_len, 2))
    import jax.numpy as jnp
    oracle["f32"] = _jax_factors(JaxMF(matrix, impl="jax", maps=maps,
                                       n_devices=2, precision=jnp.float32))
    oracle["rhs"] = JaxMF(matrix, impl="jax", maps=maps, n_devices=4,
                          rhs_devices=2).solve(_rhs(21, n, 4))
    worlds = {k: join_world(h) for k, h in started.items()}
    return worlds, oracle, matrix


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if not a.size:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("k", WORLDS)
def test_distributed_matches_single_device(run, k):
    """The facade's n_devices=k solve: the JAX mesh engine's solution, the
    contract, and the same bits on every rank."""
    worlds, oracle, matrix = run
    ranks = worlds[k]
    X = ranks[0]["default"]["X"]
    for r in ranks[1:]:
        assert np.array_equal(r["default"]["X"], X)
    _close(X, oracle[k]["X5"], 1e-10, 1e-12)
    B = _rhs(5, matrix.flat_len, 3)
    A = matrix.to_scipy()
    rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-11


@pytest.mark.parametrize("k", WORLDS)
def test_distributed_factors_are_sharded(run, k):
    """Batch-sharded rounds hold B/k fronts on each rank (K and U12)."""
    worlds, _, _ = run
    for r in worlds[k]:
        case = r["default"]
        sharded = 0
        for (B, P, N, M), (kind, _, _), shapes in zip(
                case["plans"], case["layouts"], case["shapes"]):
            if B % k == 0:
                assert kind == "batch"
                assert shapes[0] == (B // k, P, P)
                assert shapes[1] == (B // k, P, M)
                sharded += 1
        assert sharded >= 1


@pytest.mark.parametrize("k", WORLDS)
def test_n_devices_flag_fails_loudly_when_unavailable(run, k):
    worlds, _, _ = run
    for r in worlds[k]:
        assert r["too_many"] == f"requested {8 * k} devices, have {k}"


@pytest.mark.parametrize("k", WORLDS)
def test_row_sharded_big_fronts_match_single_device(run, k):
    """row_shard_min=64: the tree-top rounds with fewer fronts than ranks
    keep K's columns P/k (masked substitution, with the diagonal-block
    stack) and U12's and L21's border M/k on each rank, where those
    divide, and the refined solution is the JAX mesh engine's."""
    worlds, oracle, _ = run
    assert [kind == "row" for kind, _, _ in
            worlds[k][0]["row"]["layouts"]] == oracle[k]["rows"]
    row_sharded = 0
    for r in worlds[k]:
        case = r["row"]
        for (B, P, N, M), (kind, masked, border), shapes in zip(
                case["plans"], case["layouts"], case["shapes"]):
            if kind != "row":
                continue
            assert masked == (P % k == 0) and border == (M > 0 and M % k == 0)
            if masked:
                assert shapes[0] == (B, P, P // k)
                assert shapes[4] == (B, P // min(128, P), min(128, P),
                                     min(128, P))
            if border:
                assert shapes[1] == (B, P, M // k)
                assert shapes[2] == (B, M // k, P)
            row_sharded += masked or border
    assert row_sharded >= 1, "no round exercised row sharding"
    _close(worlds[k][0]["row"]["X"], oracle[k]["X7"], 1e-9, 1e-11)


@pytest.mark.parametrize("k", WORLDS)
def test_perms_and_factors_match_jax(run, k):
    """The whole factors gathered from k ranks against the JAX mesh
    engine's, round by round: perms equal, values to 1e-12 of the largest
    entry, the rounds of at most two fronts included (no rank ever called
    the library LU)."""
    worlds, oracle, _ = run
    got = worlds[k][0]["row"]["factors"]
    want = oracle[k]["factors"]
    assert len(got) == len(want)
    assert worlds[k][0]["row"]["plans"] == oracle[k]["plans"]
    assert any(B <= 2 for B, _, _, _ in oracle[k]["plans"])
    for r in worlds[k]:
        assert r["small_lu_calls"] == 0
    for rnd, ((K, U12, L21, perm), (jK, jU, jL, jperm, _)) in enumerate(
            zip(got, want)):
        assert np.array_equal(perm.numpy(), jperm.astype(np.int64)), rnd
        for a, b in ((K, jK), (U12, jU), (L21, jL)):
            assert a.shape == b.shape
            assert _rel_err(a.numpy(), b) <= 1e-12, rnd


@pytest.mark.parametrize("k", WORLDS)
def test_round_checkpoints_under_mesh(run, k):
    """factor_checkpoint_dir under a mesh: the round files of the whole
    factors (written by the first rank alone) stream back into each rank's
    layout (offload) and solve to the same bits as the resident engine;
    a second engine on the directory loads every round and assembles
    none, with the same bits again."""
    worlds, oracle, _ = run
    for r in worlds[k]:
        ck = r["ckpt"]
        assert ck["offload"] and ck["assembled"] == 0
        assert ck["files"] == [f"round_{i:04d}.npz"
                               for i in range(len(oracle[k]["plans"]))]
        assert np.array_equal(ck["X"], r["row"]["X"])
        assert np.array_equal(ck["X_again"], r["row"]["X"])


@pytest.mark.parametrize("k", WORLDS)
def test_distributed_coupled_tracers(run, k):
    worlds, oracle, _ = run
    _close(worlds[k][0]["coupled"], oracle[k]["coupled"], 1e-9, 1e-11)


@pytest.mark.parametrize("k", WORLDS)
def test_memplan_matches_mesh_shard_sizes(run, k):
    """plan_memory's per-device factor bytes equal the bytes each rank
    holds, at the default row_shard_min and at 64."""
    worlds, _, _ = run
    for r in worlds[k]:
        for case in ("default", "row"):
            assert r[case]["resident"] == r[case]["planned"], case


def test_rhs_axis_data_parallel_solve(run):
    """A 2 x rhs 2 mesh of 4 ranks: each mesh column solves 2 of the 4
    columns; the JAX (front 2, rhs 2) mesh engine's solution."""
    worlds, oracle, _ = run
    ranks = worlds[4]
    for rank, r in enumerate(ranks):
        axes, shape, coords = r["rhs"]["mesh"]
        assert (axes, shape, coords) == (("front", "rhs"), (2, 2),
                                         (rank // 2, rank % 2))
        assert np.array_equal(r["rhs"]["X"], ranks[0]["rhs"]["X"])
    _close(ranks[0]["rhs"]["X"], oracle["rhs"], 1e-9, 1e-11)


def test_f32_mesh_factors_match_jax(run):
    """Float32 factors on 2 ranks (K2's plain version on each rank's local
    fronts here) against the JAX float32 mesh engine's: perms equal, and
    values within tests/test_torch_precision.py's float32 bar between the
    packages (2e-4 of the largest entry: the two packages' float32 TRSM
    and GEMM round differently in the last bits); the refined solve meets
    the contract, escalating to float64 if it must."""
    worlds, oracle, matrix = run
    case = worlds[2][0]["f32"]
    for (K, U12, L21, perm), (jK, jU, jL, jperm, _) in zip(
            case["factors"], oracle["f32"]):
        assert K.dtype == torch.float32
        assert np.array_equal(perm.numpy(), jperm.astype(np.int64))
        for a, b in ((K, jK), (U12, jU), (L21, jL)):
            assert _rel_err(a.numpy(), b) <= 2e-4
    B = _rhs(9, matrix.flat_len, 2)
    A = matrix.to_scipy()
    rel = np.linalg.norm(A @ case["X"] - B, axis=0) / np.linalg.norm(B,
                                                                     axis=0)
    assert rel.max() <= 1e-10


@pytest.mark.parametrize("k", WORLDS)
def test_factors_from_jax_mesh_solve(run, k):
    """The JAX mesh engine's factors, sliced to each rank's layout
    (factors_from_jax with the mesh), solved by the port's mesh engine:
    the JAX mesh engine's own (unrefined) solve."""
    worlds, oracle, _ = run
    want = oracle[k]["Y"]
    assert any(worlds[k][0]["from_jax"]["masked"])
    for r in worlds[k]:
        _close(r["from_jax"]["Y"], want, 1e-10, 1e-12 * np.abs(want).max())


@pytest.mark.parametrize("k", WORLDS)
def test_refiner_decisions_equal_on_every_rank(run, k):
    """Every rank's refiner took the same phases on the same residuals,
    and at float32 every rank took the same escalation decision: they come
    from values every rank holds equal."""
    worlds, _, _ = run
    for case in ("default", "row"):
        stats = [r[case]["stats"] for r in worlds[k]]
        assert all(s == stats[0] for s in stats[1:]), case
        assert stats[0]["best_rel"] <= 1e-13
    if k == 2:      # float32 factors: the escalation decision too
        f32 = [(r["f32"]["stats"], r["f32"]["escalation"])
               for r in worlds[k]]
        assert all(f == f32[0] for f in f32[1:])


def test_mesh_of_one_matches_jax(tmp_path):
    """A mesh of one rank (no process group, no communication) in this
    process against the JAX engine on a mesh of one device: the same
    rounds and perms, the B <= 2 rounds through the panel in both, factors
    to 1e-12 and refined solutions to 1e-10."""
    circ, mat = str(tmp_path / "circ.nc"), str(tmp_path / "matrix.nc")
    make_circ_file(circ, imt=24, jmt=20, km=6, seed=11)
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.21e-4)]))
    jf = JaxMF(read_matrix_file(mat), impl="jax", maps=load_ind_maps(mat),
               mesh=jax_mesh(1, ("front",)))
    matrix = port_read(mat)
    tf = MultifrontalFactorization(matrix, maps=port_maps(mat), device="cpu",
                                   mesh=make_mesh(1, ("front",)))
    assert tf.engine._pack_bs == jf.engine._pack_bs == 128
    assert any(p.B <= 2 for p in tf.engine.plans)
    for (K, U12, L21, perm), (jK, jU, jL, jperm, _) in zip(
            tf.engine.factors, _jax_factors(jf)):
        assert np.array_equal(perm.numpy(), jperm.astype(np.int64))
        for a, b in ((K, jK), (U12, jU), (L21, jL)):
            assert _rel_err(a.numpy(), b) <= 1e-12
    B = _rhs(5, matrix.flat_len, 3)
    _close(tf.solve(B), jf.solve(B), 1e-10, 1e-12)
