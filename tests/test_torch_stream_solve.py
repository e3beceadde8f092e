"""The port's out-of-core stream solve against the JAX package's, on the
CPU.

A factor-only pass writes v3 trimmed round checkpoints, and
``stream_solve`` walks them on the host, one round's factors at a time.
Checkpoints cross between the packages in both directions: the port's
stream solve on a JAX factor-only pass's files, and the JAX package's on
the port's; both reach the 1e-10 contract (tests/test_stream_solve.py on
the port). The problem is the 20x16x6 fixture of tests/test_mf_jax.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                     PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import JaxMultifrontal
from nk_ocn_tracer_jacobian_precond_tpu.solver.stream_solve import (
    stream_solve as jax_stream_solve)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.checkpoint import (
    stored_dtype)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (
    TorchMultifrontal)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.stream_solve import (
    StreamSolver, stream_solve)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread per process keeps the many small torch ops of the plain kernel
    versions from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The fixture, its port facade (in-memory factors, the cross-check)
    and a factor-only port pass's checkpoint directory."""
    d = tmp_path_factory.mktemp("torch_stream")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    fac = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                    refine_tol=1e-11)
    ck = str(d / "ck")
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=ck,
                            factor_only=True)
    return matrix, maps, fac, ck, eng._pack_bs


def _rhs(matrix, seed, nrhs=2):
    return np.random.default_rng(seed).standard_normal(
        (matrix.flat_len, nrhs))


def _check(matrix, fac, B, X, rel):
    """Residuals at the contract, and the in-memory solution."""
    assert rel.max() <= 1e-10
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert np.allclose(res, rel, rtol=1e-6, atol=0)
    X2 = fac.solve(B)
    assert np.abs(X - X2).max() <= 1e-8 * np.abs(X2).max()


def test_stream_solve_from_factor_only_checkpoints(problem, monkeypatch):
    """The port's factor-only files, the port's stream solve: the contract,
    the in-memory solution, and no plan constant uploaded by the stream
    solve's engine."""
    matrix, maps, fac, ck, pack_bs = problem

    def no_upload(self, plan):
        raise AssertionError("the stream solve uploaded plan constants")
    monkeypatch.setattr(TorchMultifrontal, "_device_constants", no_upload)
    B = _rhs(matrix, 9)
    X, rel = stream_solve(matrix, maps, fac.sym, ck, B, pack_bs=pack_bs,
                          refine_tol=1e-11)
    _check(matrix, fac, B, X, rel)
    x, r = stream_solve(matrix, maps, fac.sym, ck, B[:, 0], pack_bs=pack_bs)
    assert x.shape == (matrix.flat_len,) and r.max() <= 1e-10


@pytest.mark.parametrize("nrhs", [1, 4], ids=lambda n: f"nrhs={n}")
def test_stream_apply_equals_engine_apply(problem, nrhs):
    """One unrefined StreamSolver.apply over the factor-only pass's round
    files against the in-memory engine's solve of the same equilibrated
    system at float64: the same factors, substituted front by front on the
    host against batch by batch in the engine, agree to 1e-12 relative."""
    matrix, maps, fac, ck, pack_bs = problem
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, factorize=False,
                            checkpoint_dir=ck)
    solver = StreamSolver(eng._ckpt_for(fac._fac_matrix), fac.sym, eng.plans,
                          pack_bs, eng.flat_len)
    B = _rhs(matrix, 13, nrhs)
    want = fac.engine.solve(B)
    assert np.abs(solver.apply(B) - want).max() <= 1e-12 * np.abs(want).max()


def test_stream_solve_rejects_incomplete_checkpoints(problem, tmp_path):
    matrix, maps, fac, _, pack_bs = problem
    ck = str(tmp_path / "ck")
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=ck,
                      factor_only=True, stop_after=1)
    with pytest.raises(RuntimeError, match="cannot stream-solve"):
        stream_solve(matrix, maps, fac.sym, ck, np.ones(matrix.flat_len),
                     pack_bs=pack_bs)
    # another writer width keys other checkpoints: none of these match
    with pytest.raises(RuntimeError, match="0/"):
        stream_solve(matrix, maps, fac.sym, problem[3],
                     np.ones(matrix.flat_len), pack_bs=64)


def test_port_stream_solve_on_jax_checkpoints(problem, tmp_path):
    """A JAX factor-only pass writes the rounds; the port streams them."""
    matrix, maps, fac, _, pack_bs = problem
    ck = str(tmp_path / "ck")
    eng = JaxMultifrontal(fac.sym, fac._fac_matrix, precision=jnp.float64,
                          checkpoint_dir=ck, factor_only=True)
    assert eng._pack_bs == pack_bs
    B = _rhs(matrix, 10)
    X, rel = stream_solve(matrix, maps, fac.sym, ck, B, pack_bs=pack_bs,
                          refine_tol=1e-11)
    _check(matrix, fac, B, X, rel)


def test_jax_stream_solve_on_port_checkpoints(problem):
    """The port's factor-only files, the JAX package's stream solve."""
    matrix, maps, fac, ck, pack_bs = problem
    B = _rhs(matrix, 11)
    X, rel = jax_stream_solve(matrix, maps, fac.sym, ck, B, pack_bs=pack_bs,
                              refine_tol=1e-11)
    _check(matrix, fac, B, X, rel)


def test_stream_solve_f32_checkpoints(problem, tmp_path):
    """Float32 factors written by a factor-only pass stream-solve with the
    writer's dtype, read from the round files, in the key, refined to the
    contract in float64."""
    matrix, maps, fac, f64_ck, pack_bs = problem
    ck = str(tmp_path / "ck")
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, prec=torch.float32,
                      checkpoint_dir=ck, factor_only=True)
    with np.load(os.path.join(ck, "round_0000.npz")) as z:
        assert z["blocks"].dtype == np.float32
    assert stored_dtype(ck) == np.float32
    assert stored_dtype(f64_ck) == np.float64
    assert stored_dtype(str(tmp_path)) is None
    B = _rhs(matrix, 12)
    X, rel = stream_solve(matrix, maps, fac.sym, ck, B, pack_bs=pack_bs)
    _check(matrix, fac, B, X, rel)
