"""The port's device refiner (FGMRES-IR3) against the JAX package's, on the
CPU.

Same inputs through both: the Givens least-squares step, the ELL SpMV,
one flexible GMRES cycle on identical float32 factors (factors_from_jax),
and the facade's refinement, whose steps (host preconditioner applies,
device cycles) must be those of the JAX facade at float64 on the 20x16x6
fixture of tests/test_mf_jax.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
    SparseMatrix, read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                     PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver import refine as jrefine
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    SparseMatrix as TorchSparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import refine
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)

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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _res(matrix, X, B) -> np.ndarray:
    A = matrix.to_scipy()
    return np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The 20x16x6 fixture of tests/test_mf_jax.py and its symbolic
    analysis."""
    d = tmp_path_factory.mktemp("torch_refine")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    return matrix, maps, symbolic_from_matrix(maps, matrix)


@pytest.fixture(scope="module")
def f32_pair(problem):
    """Both facades at float32 factors; the port's engine solves on the
    JAX engine's own factors."""
    matrix, maps, sym = problem
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=sym,
                          precision="f32")
    tf = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                   precision="f32")
    return jf, tf


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_givens_lstsq_matches_jax(dtype):
    """Random Hessenberg systems (m = 8, 3 RHS, one RHS with a zero
    subdiagonal): 1e-12 relative at f64, 1e-4 at f32 (the JAX version's
    sqrt and products may round differently, amplified by kappa(H) ~1e2
    here)."""
    rng = np.random.default_rng(7)
    m, nrhs = 8, 3
    H = rng.standard_normal((m + 1, m, nrhs))
    H *= (np.arange(m + 1)[:, None] <= np.arange(m)[None, :] + 1)[:, :, None]
    H[5, 4, 2] = 0.0
    beta = np.abs(rng.standard_normal(nrhs)) + 0.5
    npd = np.float64 if dtype == torch.float64 else np.float32
    H, beta = H.astype(npd), beta.astype(npd)
    want = np.asarray(jrefine._givens_lstsq(jnp.asarray(H), jnp.asarray(beta),
                                            m))
    got = refine._givens_lstsq(torch.from_numpy(H), torch.from_numpy(beta), m)
    assert got.dtype == dtype and got.shape == (m, nrhs)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert _rel(got.numpy(), want) <= tol
    if dtype == torch.float64:
        for r in range(nrhs):
            e1 = np.zeros(m + 1)
            e1[0] = beta[r]
            y = np.linalg.lstsq(H[:, :, r], e1, rcond=None)[0]
            assert _rel(got[:, r].numpy(), y) <= 1e-12


def test_spmv_matches_scipy(problem, f32_pair):
    """The ELL SpMV at f64 against scipy's CSR product (1e-14 relative:
    summation order only), at f32 against f32 values (1e-6)."""
    matrix, _, _ = problem
    ref = f32_pair[1]._device_refiner()
    X = np.random.default_rng(3).standard_normal((matrix.flat_len, 2))
    want = matrix.to_scipy() @ X
    got = ref._spmv(torch.from_numpy(X))
    assert got.dtype == torch.float64 and _rel(got.numpy(), want) <= 1e-14
    got32 = ref._spmv(torch.from_numpy(X.astype(np.float32)))
    assert got32.dtype == torch.float32 and _rel(got32.numpy(), want) <= 1e-6


@pytest.mark.parametrize("m", [4, 8])
def test_cycle_matches_jax_f32(problem, f32_pair, m):
    """One FGMRES cycle (f32 Krylov vectors) on identical f32 factors,
    against JAX's _cycle_body: the corrections agree to 5e-4 relative
    (measured up to 8e-5: f32 Gram-Schmidt and SpMV sums in another order,
    amplified by kappa(H)), and each leaves a residual within 1.5x of the
    other's."""
    matrix, _, _ = problem
    jf, tf = f32_pair
    eng = mf_torch.TorchMultifrontal(tf.sym, tf._fac_matrix, CPU,
                                     factorize=False, prec=torch.float32)
    eng.factors = mf_torch.factors_from_jax(jf.engine, CPU)
    assert eng.factors[0][0].dtype == torch.float32
    jr = jrefine.DeviceRefiner(jf.engine, matrix, dr=jf.dr, dc=jf.dc)
    tr = refine.DeviceRefiner(eng, matrix, dr=tf.dr, dc=tf.dc)
    b = np.random.default_rng(m).standard_normal(
        (matrix.flat_len, 4)).astype(np.float32)
    dj = np.asarray(jr._make_cycle(m, 4, jnp.float32)(
        jnp.asarray(b), jr._env(jnp.float32)))
    dt = tr._cycle(torch.from_numpy(b), m, torch.float32)
    assert dt.dtype == torch.float32
    assert _rel(dt.numpy(), dj) <= 5e-4
    rj = _res(matrix, dj.astype(np.float64), b.astype(np.float64))
    rt = _res(matrix, dt.numpy().astype(np.float64), b.astype(np.float64))
    assert rt.max() < 1e-3
    assert np.all(rt <= 1.5 * rj) and np.all(rj <= 1.5 * rt)


def _count_refinement(monkeypatch):
    """Count plain-refinement applies (JAX: the facade's host
    preconditioner; port: DeviceRefiner._correct) and device cycles (JAX:
    the cycles its fused loops report, plus polish dispatches; port: calls
    of DeviceRefiner._cycle) of both refiners."""
    counts = dict(jax_host=0, jax_cycles=0, host=0, cycles=0)

    def counted(cls, name, key):
        real = getattr(cls, name)

        def wrapper(self, b):
            counts[key] += 1
            return real(self, b)
        monkeypatch.setattr(cls, name, wrapper)

    counted(JaxFactorization, "_precond_solve", "jax_host")
    counted(refine.DeviceRefiner, "_correct", "host")
    make_fused = jrefine.DeviceRefiner._make_fused
    make_cycle = jrefine.DeviceRefiner._make_cycle

    def fused(self, m, nrhs, K, dtype=jnp.float32):
        fn = make_fused(self, m, nrhs, K, dtype)

        def run(*args):
            X, rel, k = fn(*args)
            counts["jax_cycles"] += int(k)
            return X, rel, k
        return run

    def cycle(self, m, nrhs, dtype=jnp.float32):
        fn = make_cycle(self, m, nrhs, dtype)

        def run(*args):
            counts["jax_cycles"] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(jrefine.DeviceRefiner, "_make_fused", fused)
    monkeypatch.setattr(jrefine.DeviceRefiner, "_make_cycle", cycle)
    real_cycle = refine.DeviceRefiner._cycle

    def port_cycle(self, b, m, dtype):
        counts["cycles"] += 1
        return real_cycle(self, b, m, dtype)
    monkeypatch.setattr(refine.DeviceRefiner, "_cycle", port_cycle)
    return counts


@pytest.mark.parametrize("nrhs", [1, 4])
def test_refinement_steps_match_jax(problem, monkeypatch, nrhs):
    """At f64 the port's facade refines as the JAX facade does under x64:
    through the device refiner, plain refinement until it stalls, then
    host-exact polish cycles. Same number of host preconditioner applies
    (3) on a fresh factorization, and the same residual contract (<= 100 *
    refine_tol). (Plain refinement capped at 5 steps, then scipy GMRES, is
    not what the JAX facade does.) The JAX refiner stops after one polish
    cycle, where its float64 residual stalls above tol (inside that SpMV's
    own rounding); the port looks again in extended precision (the stall
    is within 10x of tol) and polishes once more, so it runs 2 cycles, the
    second one on a residual smaller than the float64 stall's. Plain
    refinement stalled within
    sight of the target, so the port, unlike the JAX refiner, memoizes no
    Krylov phase: a second solve of the same factorization takes the same
    3 + 2 steps, not a fused dispatch."""
    matrix, maps, sym = problem
    counts = _count_refinement(monkeypatch)
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=sym)
    tf = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu")
    assert jf.engine.prec == jnp.float64 and tf.engine.prec == torch.float64
    B = np.random.default_rng(5).standard_normal((matrix.flat_len, nrhs))
    Xj = np.asarray(jf.solve(B))
    Xt = tf.solve(B)
    assert counts["jax_host"] == counts["host"] == 3, counts
    assert counts["jax_cycles"] == 1 and counts["cycles"] == 2, counts
    assert tf._refiner.stats["host_applies"] == 3
    assert tf._refiner.stats["phases"] == ["ir", "ir", "ir", "polish",
                                           "polish"]
    assert jf._refiner._phase == "gmres" and tf._refiner._phase == "ir"
    rels = tf._refiner.stats["rels"]
    assert rels[-3] > tf._refiner.tol and rels[-2] < rels[-3], rels
    for X in (Xj, Xt):
        assert _res(matrix, X, B).max() <= 100 * tf.refine_tol
    assert _rel(Xt, Xj) <= 1e-12
    X2 = tf.solve(B)
    assert counts["host"] == 6 and counts["cycles"] == 4, counts
    assert tf._refiner.stats["phases"] == ["ir", "ir", "ir", "polish",
                                           "polish"]
    assert np.array_equal(X2, Xt)


def test_f32_refinement_matches_jax(problem, f32_pair):
    """At float32 factors this fixture refines without escalating in both
    facades: both keep their f32 factors, reach 1e-11, and agree to 1e-11
    relative."""
    matrix, _, _ = problem
    jf, tf = f32_pair
    B = np.random.default_rng(6).standard_normal((matrix.flat_len, 4))
    Xj, Xt = np.asarray(jf.solve(B)), tf.solve(B)
    assert jf.engine.prec == jnp.float32 and tf.engine.prec == torch.float32
    assert tf._refiner.stats["host_applies"] >= 1
    assert _res(matrix, Xt, B).max() <= 1e-11
    assert _rel(Xt, Xj) <= 1e-11


def test_refactor_rebinds_refiner(problem):
    """refactor(matrix) with new values on the same pattern rebinds the
    refiner (host and device operands) and keeps its phase memo; a new
    pattern is refused."""
    matrix, maps, sym = problem
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu")
    B = np.random.default_rng(8).standard_normal((matrix.flat_len, 2))
    X0 = fac.solve(B)
    ref = fac._refiner
    phase, vals = ref._phase, ref._ell_val64.clone()
    scaled = SparseMatrix(nzval=matrix.nzval * 2.0, colind=matrix.colind,
                          rowptr=matrix.rowptr,
                          coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    fac.refactor(scaled)
    assert fac._refiner is ref and ref._phase == phase
    assert torch.equal(ref._ell_val64, 2.0 * vals)
    X = fac.solve(B)
    assert _res(scaled, X, B).max() <= 1e-11
    assert _rel(X, X0 / 2.0) <= 1e-10
    other = SparseMatrix(nzval=matrix.nzval[:-1], colind=matrix.colind[:-1],
                         rowptr=np.r_[matrix.rowptr[:-1],
                                      matrix.rowptr[-1] - 1],
                         coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    with pytest.raises(ValueError, match="identical sparsity"):
        ref.rebind(other)


def test_polish_goes_on_to_tol(problem, monkeypatch):
    """Polish cycles go on while each halves the residual, down to tol,
    when tol is the contract itself (the NK loop's 1e-10): the JAX refiner
    stops once within 3x of tol and returns up to 3x the target. Scripted
    corrections: plain refinement contracts 100x a step down to a floor of
    5e-8 (so it stalls within sight of the target and hands over to
    polish), and each polish cycle leaves 0.4 of the residual: 5e-8, 2e-8,
    ..., 2.05e-10 (where the JAX rule stops), 8.2e-11 <= tol."""
    from scipy.sparse.linalg import splu
    matrix, maps, sym = problem
    tol = 1e-10
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                    refine_tol=tol)
    ref = fac._device_refiner()
    lu = splu(matrix.to_scipy().tocsc())
    B = np.random.default_rng(9).standard_normal((matrix.flat_len, 2))
    bnorm = np.linalg.norm(B, axis=0)

    def correct(R):
        R = R.numpy()
        rel = np.linalg.norm(R, axis=0) / bnorm
        keep = np.maximum(0.01, np.minimum(1.0, 5e-8 / rel))
        return torch.from_numpy(lu.solve(R * (1.0 - keep)))

    def cycle(b, m, dtype):
        return torch.from_numpy(0.6 * lu.solve(b.double().numpy())).to(dtype)
    monkeypatch.setattr(ref, "_correct", correct)
    monkeypatch.setattr(ref, "_cycle", cycle)
    X = fac.solve(B)
    s = ref.stats
    assert s["phases"][:5] == ["ir"] * 5 and s["phases"][5:] == (
        ["polish"] * 7), s
    assert 1e-10 < s["rels"][-2] <= 3e-10 and s["rels"][-1] <= tol, s
    assert _res(matrix, X, B).max() <= tol


def test_extended_residual_where_float64_rounds():
    """The refiner's extended-precision residual on a system with heavy
    cancellation (|A| |x| some 1e6 times |b|): against the exact residual
    (rational arithmetic), the float64 one (b minus csr_matvec's plain
    version on the refiner's ELL operands) is off by its own rounding, the long
    double one by a small fraction of that."""
    from fractions import Fraction

    import scipy.sparse as sp
    rng = np.random.default_rng(11)
    n = 40
    A = sp.random(n, n, density=0.2, random_state=rng, format="csr") * 1e6
    A = (A + sp.eye(n)).tocsr()
    X = rng.standard_normal((n, 2))
    B = A @ X + 1e-9 * rng.standard_normal((n, 2))
    exact = np.array([[float(Fraction(B[i, j]) - sum(
        Fraction(A.data[k]) * Fraction(X[A.indices[k], j])
        for k in range(A.indptr[i], A.indptr[i + 1])))
        for j in range(2)] for i in range(n)])
    ref = _bare_refiner(TorchSparseMatrix(
        nzval=A.data, colind=A.indices, rowptr=A.indptr,
        coupled_tracer_cnt=1))
    r64 = torch.from_numpy(B) - ck.csr_matvec_plain(
        ref._ell_col, ref._ell_val64, torch.from_numpy(X))
    err64 = np.abs(r64.numpy() - exact).max()
    err_ext = np.abs(ref._host_residual(B, X) - exact).max()
    assert err64 > 1e-12 and err_ext <= 1e-2 * err64, (err64, err_ext)


def _bare_refiner(matrix):
    """A refiner with no engine, holding ``matrix``'s operands on the CPU
    as a refiner stages them."""
    ref = refine.DeviceRefiner.__new__(refine.DeviceRefiner)
    ref.n, ref._rowptr, ref.device = (matrix.flat_len,
                                      np.asarray(matrix.rowptr), CPU)
    ref._bind_matrix(matrix)
    return ref


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64)).view(np.int64)


@pytest.mark.parametrize("nrhs", [1, 4])
def test_csr_residual_is_scipys_residual(problem, nrhs):
    """csr_matvec's plain version on the refiner's own ELL operands
    equals scipy's A @ X bit for bit (each row summed in CSR order, from
    zero), pad rows included; so the refiner's float64 product and its
    float64 residual, b minus it, equal scipy's."""
    matrix, _, _ = problem
    ref = _bare_refiner(matrix)
    n = matrix.flat_len
    rowlen = np.diff(np.asarray(matrix.rowptr))
    assert (rowlen < ref._ell_col.shape[1]).sum() > n // 2
    assert int((ref._ell_col == n).sum()) == (ref._ell_col.shape[1] * n
                                              - matrix.nnz)
    rng = np.random.default_rng(nrhs)
    X = rng.standard_normal((n, nrhs)) * np.exp(rng.uniform(-8, 8, (n, 1)))
    B = rng.standard_normal((n, nrhs))
    AX = matrix.to_scipy() @ X
    want = B - AX
    got = ck.csr_matvec(ref._ell_col, ref._ell_val64, torch.from_numpy(X))
    assert np.array_equal(_bits(got.numpy()), _bits(AX))
    got = ref._spmv(torch.from_numpy(X))
    assert np.array_equal(_bits(got.numpy()), _bits(AX))
    stats = dict(device_residuals=0)
    got = ref._residual64(torch.from_numpy(B), torch.from_numpy(X), stats)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert stats["device_residuals"] == 1


@pytest.fixture(scope="module")
def fac_1e12(problem):
    """The port's facade at float64 with refine_tol 1e-12, which plain
    refinement reaches in two corrections on this fixture, as in the
    benchmark's apply requests."""
    matrix, maps, sym = problem
    return MultifrontalFactorization(matrix, maps=maps, sym=sym,
                                     device="cpu", refine_tol=1e-12)


def test_plain_refinement_is_the_host_recipe(problem, fac_1e12):
    """A solve that plain refinement finishes (refine_tol 1e-12) returns
    the host recipe's X bit for bit: X = M^-1 B, then R = B - A X in
    scipy and X += M^-1 R while the residual is above tol, with the same
    phases, plain applies and outer steps."""
    matrix = problem[0]
    fac = fac_1e12
    B = np.random.default_rng(12).standard_normal((matrix.flat_len, 2))
    X = fac.solve(B)
    ref = fac._refiner
    st = ref.stats

    def precond(R):
        return ref._precond(torch.from_numpy(R)).numpy()
    A = matrix.to_scipy()
    bnorm = np.linalg.norm(B, axis=0)
    Xh, R, applies, outers = None, B, 0, 1
    while (np.linalg.norm(R, axis=0) / bnorm).max() > ref.tol:
        Xh = precond(R) if Xh is None else Xh + precond(R)
        R = B - A @ Xh
        applies += 1
        outers += 1
    assert applies >= 2 and st["phases"] == ["ir"] * applies, st
    assert st["host_applies"] == applies and st["outers"] == outers, st
    assert st["extended"] == 0 and st["device_residuals"] == outers - 1
    assert np.array_equal(X, Xh)
    np.testing.assert_allclose(st["best_rels"], np.linalg.norm(
        R, axis=0) / bnorm, rtol=1e-12)


class _NoHostMatrix:
    """Stands in for a scipy matrix that no code may touch."""

    def __getattr__(self, name):
        raise AssertionError(f"the host matrix was used ({name})")

    def __matmul__(self, other):
        raise AssertionError("a host SpMV")

    __rmatmul__ = __matmul__


def test_a_refined_solve_takes_no_host_spmv(problem, fac_1e12,
                                           monkeypatch):
    """With the refiner's scipy matrix and the facade's host check made to
    raise, a refined solve that needs no long-double pass succeeds: every
    float64 residual takes csr_matvec (one a step past outer 0, whose
    residual is B itself), and the facade judges the refiner's own
    per-column residuals."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf
    matrix = problem[0]
    fac = fac_1e12
    ref = fac._device_refiner()
    calls = []
    real = refine.csr_matvec

    def counted(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(refine, "csr_matvec", counted)
    monkeypatch.setattr(ref, "A", _NoHostMatrix())
    monkeypatch.setattr(fac, "A", _NoHostMatrix())

    def refuse(*a):
        raise AssertionError("the facade's host check ran")
    monkeypatch.setattr(mf, "_rel_residuals", refuse)
    B = np.random.default_rng(13).standard_normal((matrix.flat_len, 3))
    X = fac.solve(B)
    st = ref.stats
    assert st["extended"] == 0 and st["outers"] >= 2, st
    assert len(calls) == st["device_residuals"] == st["outers"] - 1
    assert len(st["best_rels"]) == 3
    assert max(st["best_rels"]) == st["best_rel"] <= 1e-12
    assert _res(matrix, X, B).max() <= 1e-12
