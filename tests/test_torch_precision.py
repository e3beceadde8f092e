"""The port's factor precision against the JAX package's, on the CPU.

The cases of tests/test_precision.py on its 14x12x6 fixture (precision
strings, escalation to float64 factors when the refiner gives up, and
escalation turned off), the float32 engine round by round against
mf_jax._partial_factor_body on the same fronts, the float64 substitution
of the tree-top rounds on float32 factors (mf_jax._hi_round), and the
float32 facade against the JAX facade at float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                     PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.device import resolve_precision
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf as tmf
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
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
    """max |a - b| / max |b| (0 for empty arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / np.abs(b).max())


def _max_res(matrix, X, B) -> float:
    A = matrix.to_scipy()
    return float((np.linalg.norm(A @ X - B, axis=0)
                  / np.linalg.norm(B, axis=0)).max())


@pytest.fixture(scope="module")
def small_problem(tmp_path_factory):
    """The fixture of tests/test_precision.py (14x12x6, seed 61)."""
    d = tmp_path_factory.mktemp("torch_prec")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=14, jmt=12, km=6, seed=61)
    pt = PerTracerOptions(sink_type="const", sink_rate=1e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ, hmix_type="const",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    sym = symbolic_from_matrix(maps, matrix, leaf_size=8)
    return matrix, maps, sym


def test_resolve_precision_strings():
    """The facade's and the CLI's spellings only: "f32", "f64", "auto"
    and None."""
    cuda, cpu = torch.device("cuda"), CPU
    assert resolve_precision("f32", cpu) == torch.float32
    assert resolve_precision("f64", cuda) == torch.float64
    # auto (and None) follow the JAX engine: f32 on the card, f64 on CPU
    assert resolve_precision("auto", cuda) == torch.float32
    assert resolve_precision(None, cuda) == torch.float32
    assert resolve_precision("auto", cpu) == torch.float64
    assert resolve_precision(None, cpu) == torch.float64
    for bad in ("bf16", "", "float64", "F64", torch.float32, 32):
        with pytest.raises(ValueError):
            resolve_precision(bad, cpu)


def test_facade_precision_choice(small_problem):
    """The facade's default stays float64; "f32" gives float32 factors,
    "auto" on the CPU float64, as the JAX engine picks there."""
    matrix, maps, sym = small_problem
    kw = dict(maps=maps, sym=sym, device="cpu")
    assert MultifrontalFactorization(matrix, **kw).engine.prec == torch.float64
    assert (MultifrontalFactorization(matrix, precision="auto", **kw)
            .engine.prec == torch.float64)
    f32 = MultifrontalFactorization(matrix, precision="f32", **kw)
    assert f32.engine.prec == torch.float32
    assert all(t.dtype == torch.float32
               for f in f32.engine.factors for t in f[:3])
    assert f32.validate()["nonfinite_factor_entries"] == 0


def test_escalation_flow(small_problem):
    """float32 factors and the giveup bar of
    tests/test_precision.py::test_escalation_flow (1e-9, below any float32
    apply error): the refiner gives up after one plain-refinement step,
    the facade refactors in float64 and the solve meets the contract."""
    matrix, maps, sym = small_problem
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                    refine_tol=1e-12, precision="f32",
                                    giveup=1e-9)
    assert fac.engine.prec == torch.float32
    b = np.random.default_rng(0).standard_normal(matrix.flat_len)
    x = fac.solve(b)
    assert fac.engine.prec == torch.float64      # escalated
    assert fac.timings["escalate"] > 0
    # the float32 attempt gave up after one plain-refinement step
    assert 1e-9 < fac.escalation["max_rel"] < 1.0
    assert fac.escalation["refiner"]["phases"] == ["ir"]
    assert all(t.dtype == torch.float64
               for f in fac.engine.factors for t in f[:3])
    assert _max_res(matrix, x[:, None], b[:, None]) <= 1e-10
    # later solves stay on the float64 factors
    fac.solve(b)
    assert fac.engine.prec == torch.float64


def test_escalation_disabled(small_problem):
    """escalate=False keeps the float32 engine and warns of the stall, as
    tests/test_precision.py::test_escalation_disabled (NK_ESCALATE=0)."""
    matrix, maps, sym = small_problem
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                    refine_tol=1e-12, precision="f32",
                                    giveup=1e-9, escalate=False)
    b = np.random.default_rng(0).standard_normal(matrix.flat_len)
    with pytest.warns(RuntimeWarning, match="stalled"):
        fac.solve(b)
    assert fac.engine.prec == torch.float32


def test_escalation_refused_when_f64_does_not_fit(small_problem,
                                                  monkeypatch):
    """A float64 factor set planned above 92% of the card's memory is
    refused with a warning, and the float32 factors stay."""
    matrix, maps, sym = small_problem
    monkeypatch.setattr(tmf, "_device_memory_limit", lambda device: 1000)
    fac = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                    refine_tol=1e-12, precision="f32",
                                    giveup=1e-9)
    b = np.random.default_rng(0).standard_normal(matrix.flat_len)
    with pytest.warns(RuntimeWarning, match="float64 factors need"):
        fac.solve(b)
    assert fac.engine.prec == torch.float32 and fac.escalation is None
    assert tmf._device_memory_limit.__name__ == "<lambda>"
    monkeypatch.undo()
    assert tmf._device_memory_limit(CPU) is None


def test_f32_escalates_as_jax(small_problem):
    """With the default giveup bar, float32 factors of this problem leave a
    raw apply error of ~0.31 on these right-hand sides: both facades give
    up after one plain-refinement step, refactor in float64 and reach the
    contract; the refined solutions agree to 1e-10 relative (both sit at
    the float64 attainable floor, ~2e-11 residual)."""
    matrix, maps, sym = small_problem
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=sym,
                          precision="f32")
    tf = MultifrontalFactorization(matrix, maps=maps, sym=sym, device="cpu",
                                   precision="f32")
    B = np.random.default_rng(1).standard_normal((matrix.flat_len, 3))
    raw = _max_res(matrix, tf.solve(B, refine=False), B)
    assert 0.25 < raw < 1.0, raw
    Xj, Xt = np.asarray(jf.solve(B)), tf.solve(B)
    assert jf.engine.prec == jnp.float64 and tf.engine.prec == torch.float64
    assert _max_res(matrix, Xt, B) <= 1e-10
    assert _rel(Xt, Xj) <= 1e-10


# --------------------------------------------------------------------------
# the float32 engine against the JAX engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_f32(tmp_path_factory):
    """The bench "tiny" problem (24x20x8, seed 7) factored at f32 by the
    torch engine with every round's input front recorded."""
    d = tmp_path_factory.mktemp("torch_prec_tiny")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=24, jmt=20, km=8, seed=7)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ, adv_type="centered",
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    rounds = []
    real = mf_torch.partial_factor

    def recording(F, P, p_arr, tau=0.0, pack_bs=mf_torch.PANEL,
                  allow_native_lu=True):
        F0 = F.clone()
        out = real(F, P, p_arr, tau, pack_bs, allow_native_lu)
        rounds.append((F0, P, p_arr.clone(), tau, pack_bs, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(mf_torch, "partial_factor", recording)
    try:
        fac = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                        precision="f32")
    finally:
        mp.undo()
    return matrix, maps, fac, rounds


@pytest.mark.parametrize("rnd", range(4))
def test_partial_factor_matches_jax_f32(tiny_f32, rnd):
    """Same f32 front F into both (two panels, one panel at off > 0, and
    the native-LU gate twice): equal pivots; K/U12/L21/S within 2e-4
    relative. Measured up to 5.5e-5: the f32 TRSM and GEMM of the two
    packages' BLAS round differently in the last bits (eps32 = 1.2e-7),
    and the pivot blocks' conditioning amplifies it. Whole-chain bit
    equality is not asked at f32: its pivots sit on the knife's edge."""
    F, P, p_arr, tau, pack_bs, got = tiny_f32[3][rnd]
    assert F.dtype == torch.float32
    want = mf_jax._partial_factor(
        jnp.asarray(F.numpy()), P=P, p_arr=jnp.asarray(p_arr.numpy()),
        tau=tau, use_pallas=False, allow_native_lu=True, pack_bs=pack_bs)
    K, U12, L21, S, perm = got
    assert np.array_equal(perm.numpy(), np.asarray(want[4]))
    for name, g, w in zip(("K", "U12", "L21", "S"), (K, U12, L21, S),
                          want[:4]):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= 2e-4, (name, _rel(g.numpy(), w))


def test_f32_tau_uses_f32_eps(tiny_f32):
    """tau = f32(sqrt(eps32) * max |a|) for float32 factors
    (mf_jax.py:2158-2160), and the CSR values go to the device in f32."""
    _, _, fac, rounds = tiny_f32
    nz = fac._fac_matrix.nzval.astype(np.float32)
    want = float(np.float32(np.sqrt(np.finfo(np.float32).eps)
                            * np.abs(nz).max()))
    assert fac.engine._tau == want
    assert all(r[3] == want for r in rounds)


def test_hi_rounds_match_jax(tiny_f32, monkeypatch):
    """The float64 substitution of tree-top rounds on float32 factors. With
    the threshold at P >= 1 in both packages (HI_ROUND_MIN_P here,
    NK_SOLVE_F64_MINP there) every round runs it, and the port's solve on
    the JAX engine's own f32 factors matches JaxMultifrontal.solve to
    1e-12 relative (float64 arithmetic on equal f32 factors, stored back
    in f32; measured equal). With f32 substitution the port's result moves
    by ~1e-4 (eps32 times the pivot blocks' conditioning), so the
    threshold decides the result."""
    matrix, maps, fac, _ = tiny_f32
    monkeypatch.setenv("NK_SOLVE_F64_MINP", "1")
    monkeypatch.setattr(mf_torch, "HI_ROUND_MIN_P", 1)
    jeng = mf_jax.JaxMultifrontal(fac.sym, fac._fac_matrix,
                                  precision=jnp.float32)
    assert jeng.prec == jnp.float32
    eng = mf_torch.TorchMultifrontal(fac.sym, fac._fac_matrix, CPU,
                                     factorize=False, prec=torch.float32)
    eng.factors = mf_torch.factors_from_jax(jeng, CPU)
    assert eng.factors[0][0].dtype == torch.float32
    assert all(eng._hi_round(p) for p in eng.plans)
    B = np.random.default_rng(2).standard_normal((matrix.flat_len, 2))
    X = eng.solve(B)
    assert _rel(X, np.asarray(jeng.solve(B))) <= 1e-12
    monkeypatch.setattr(mf_torch, "HI_ROUND_MIN_P", 4096)
    assert not any(eng._hi_round(p) for p in eng.plans)
    assert _rel(eng.solve(B), X) > 1e-7
