"""The torch engine and facade against the JAX engine, on the CPU at f64.

Same inputs go through both packages: per round, the same front F through
mf_jax._partial_factor_body and mf_torch.partial_factor; the solve on
identical factors; the whole factor-and-solve chain; the facade's
refined residuals on the fixtures of tests/test_mf_jax.py.
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
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
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


def _build(d, name, imt, jmt, km, seed, **extra):
    circ, mat = str(d / f"{name}_circ.nc"), str(d / f"{name}_m.nc")
    make_circ_file(circ, imt=imt, jmt=jmt, km=km, seed=seed)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt],
                                        **extra))
    return read_matrix_file(mat), load_ind_maps(mat)


def _rel(a, b) -> float:
    """max |a - b| / max |b| (0 for empty arrays)."""
    a, b = np.asarray(a), np.asarray(b)
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The bench "tiny" problem (24x20x8, seed 7) at leaf_size 32, factored
    by the torch engine with every round's input front recorded."""
    d = tmp_path_factory.mktemp("torch_mf_tiny")
    matrix, maps = _build(d, "tiny", 24, 20, 8, 7, adv_type="centered")
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
        fac = MultifrontalFactorization(matrix, maps=maps, device="cpu")
    finally:
        mp.undo()
    return matrix, maps, fac, rounds


@pytest.fixture(scope="module")
def fixture_pair(tmp_path_factory):
    """The 20x16x6 fixture of tests/test_mf_jax.py factored by both
    packages on one symbolic analysis."""
    d = tmp_path_factory.mktemp("torch_mf_fixture")
    matrix, maps = _build(d, "fixture", 20, 16, 6, 33)
    tf = MultifrontalFactorization(matrix, maps=maps, device="cpu")
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=tf.sym)
    return matrix, maps, tf, jf


def test_tiny_rounds(tiny):
    """The rounds the per-round test walks: two panels (one at off > 0),
    one panel, and the native-LU gate (B <= 2) twice."""
    _, _, fac, rounds = tiny
    shapes = [(p.B, p.P, p.N) for p in fac.engine.plans]
    assert shapes == [(16, 256, 384), (4, 128, 384), (2, 64, 320),
                      (1, 256, 256)]
    assert len(rounds) == 4


@pytest.mark.parametrize("rnd", range(4))
def test_partial_factor_matches_jax(tiny, rnd):
    """Same F into both: equal perms, K/U12/L21/S within 1e-12 relative."""
    F, P, p_arr, tau, pack_bs, got = tiny[3][rnd]
    want = mf_jax._partial_factor(
        jnp.asarray(F.numpy()), P=P, p_arr=jnp.asarray(p_arr.numpy()),
        tau=tau, use_pallas=False, allow_native_lu=True, pack_bs=pack_bs)
    K, U12, L21, S, perm = got
    assert np.array_equal(perm.numpy(), np.asarray(want[4]))
    for name, g, w in zip(("K", "U12", "L21", "S"), (K, U12, L21, S),
                          want[:4]):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= 1e-12, (name, _rel(g.numpy(), w))


def test_extend_add_matches_jax(tiny):
    """Wave-ordered index_add_ sums each front's children in link order,
    as the JAX scatter-add does: bit for bit on the CPU."""
    _, _, fac, rounds = tiny
    eng = fac.engine
    rnd = next(r for r, p in enumerate(eng.plans)
               if any(len(set(g.dst_slots.tolist())) < len(g.dst_slots)
                      for g in p.child_groups))
    plan = eng.plans[rnd]
    rng = np.random.default_rng(2)
    F0 = rng.standard_normal((plan.B, plan.N, plan.N))
    got = torch.from_numpy(F0.copy())
    want = jnp.asarray(F0)
    for g, (src_rnd, ss, ds, inv, waves) in zip(
            plan.child_groups, eng._consts[rnd]["groups"]):
        sp = eng.plans[src_rnd]
        S = rng.standard_normal((sp.B, sp.M, sp.M))
        mf_torch.extend_add(got, torch.from_numpy(S), ss, ds, inv, waves)
        want = mf_jax._extend_add(want, jnp.asarray(S),
                                  jnp.asarray(g.src_slots),
                                  jnp.asarray(g.dst_slots),
                                  jnp.asarray(g.inv))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_link_waves():
    ds = np.array([3, 1, 3, 0, 3, 1], dtype=np.int32)
    order, waves = mf_torch.link_waves(ds)
    assert waves == [(0, 3), (3, 5), (5, 6)]
    assert order.tolist() == [0, 1, 3, 2, 5, 4]
    for a, b in waves:
        assert len(set(ds[order[a:b]].tolist())) == b - a


def test_border_waves():
    """Pads dropped; each wave's destinations distinct; each border cell's
    updates in flattened update order."""
    bor = np.array([[5, 2, 9], [2, 5, 9], [2, 7, 9]])
    src, dst, waves = mf_torch.border_waves(bor, flat_len=9)
    assert waves == [(0, 3), (3, 5), (5, 6)]
    assert src.tolist() == [0, 1, 7, 3, 4, 6]
    assert dst.tolist() == [5, 2, 7, 2, 5, 2]


def test_engine_border_waves(fixture_pair):
    """On every round of the fixture: the waves cover every real border
    entry once, no index_add_ sees a duplicate, each cell sums in
    flattened order; the fixture has rounds with shared border cells."""
    _, _, tf, _ = fixture_pair
    eng = tf.engine
    shared = 0
    for plan, cc in zip(eng.plans, eng._consts):
        src, dst, waves = (t if isinstance(t, list) else t.numpy()
                           for t in cc["border"])
        flat = plan.cells_bor.reshape(-1)
        assert sorted(src.tolist()) == np.flatnonzero(
            flat < eng.flat_len).tolist()
        assert np.array_equal(dst, flat[src])
        for a, b in waves:
            assert len(set(dst[a:b].tolist())) == b - a
        for d in set(dst.tolist()):
            assert np.all(np.diff(src[dst == d]) > 0)
        shared += len(waves) > 1
    assert shared


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fwd_round_matches_jax(fixture_pair, dtype):
    """The border subtraction sums each shared border cell's updates in
    the order of the JAX scatter-add: the engine's forward round body
    (TorchMultifrontal._fwd) bit for bit with mf_jax._fwd_round on a round
    with shared border cells. K is the identity and each row of L21 has
    one entry, so y and L21 @ y are exact in both packages and only the
    order of the border sums can differ (reversing the waves does change
    the bits)."""
    _, _, tf, _ = fixture_pair
    eng = mf_torch.TorchMultifrontal(tf.sym, tf._fac_matrix, CPU,
                                     factorize=False,
                                     prec=getattr(torch, dtype))
    rnd = next(r for r in range(len(eng.plans))
               if len(eng._round_consts(r)["border"][2]) > 1)
    plan, cc = eng.plans[rnd], eng._round_consts(rnd)
    B, P, M, nrhs = plan.B, plan.P, plan.M, 3
    rng = np.random.default_rng(11)
    W = rng.standard_normal((eng.flat_len + 1, nrhs)).astype(dtype)
    W[-1] = 0
    K = np.broadcast_to(np.eye(P, dtype=dtype), (B, P, P)).copy()
    L21 = np.zeros((B, M, P), dtype)
    real = plan.cells_bor < eng.flat_len
    b, m = np.nonzero(real)
    L21[b, m, rng.integers(0, P, len(b))] = rng.standard_normal(len(b))
    perm = np.stack([rng.permutation(P) for _ in range(B)])
    U12 = np.zeros((B, P, M), dtype)
    args = (K, U12, L21, perm)
    want = mf_jax._fwd_round(jnp.asarray(W), *map(jnp.asarray, args), None,
                             jnp.asarray(plan.cells_own),
                             jnp.asarray(plan.cells_bor), bs=eng._pack_bs)
    factors = [(None,) * 4] * len(eng.plans)
    factors[rnd] = tuple(map(torch.from_numpy, args))
    eng.set_factors(factors)

    def fwd(border):
        return eng._fwd(rnd, torch.from_numpy(W.copy()),
                        dict(cc, border=border), hi=False)

    got = fwd(cc["border"])
    n = eng.flat_len
    assert np.array_equal(got.numpy()[:n], np.asarray(want)[:n])
    src, dst, waves = cc["border"]
    rev = fwd((src, dst, waves[::-1]))
    assert not np.array_equal(rev.numpy()[:n], np.asarray(want)[:n])


@pytest.mark.parametrize("nrhs", [1, 2, 4])
def test_solve_on_jax_factors_matches_jax(fixture_pair, nrhs):
    """The port's solve on the JAX engine's own factors (factors_from_jax)
    against JaxMultifrontal.solve: 1e-12 relative."""
    matrix, _, tf, jf = fixture_pair
    eng = mf_torch.TorchMultifrontal(tf.sym, tf._fac_matrix, CPU,
                                     factorize=False)
    eng.factors = mf_torch.factors_from_jax(jf.engine, CPU)
    B = np.random.default_rng(nrhs).standard_normal((matrix.flat_len, nrhs))
    assert _rel(eng.solve(B), np.asarray(jf.engine.solve(B))) <= 1e-12


@pytest.mark.parametrize("nrhs", [1, 2, 4])
def test_solve_matches_jax(fixture_pair, nrhs):
    """Whole chain, factor and solve. Refined solutions agree to 1e-12.
    Unrefined ones agree to 1e-11: each engine's unrefined solution is
    itself ~1e-12 from the refined one (JAX's measured 1.2e-12 on this
    fixture), since ill-conditioned tree-top pivot blocks amplify the
    last-bit differences of the two packages' LAPACK/BLAS calls."""
    matrix, _, tf, jf = fixture_pair
    B = np.random.default_rng(nrhs).standard_normal((matrix.flat_len, nrhs))
    X = tf.solve(B)
    assert _rel(X, np.asarray(jf.solve(B))) <= 1e-12
    assert _rel(tf.solve(B, refine=False),
                np.asarray(jf.solve(B, refine=False))) <= 1e-11
    if nrhs == 1:
        assert tf.solve(B[:, 0]).shape == (matrix.flat_len,)


def test_facade_residual(fixture_pair):
    matrix, _, tf, _ = fixture_pair
    B = np.random.default_rng(4).standard_normal((matrix.flat_len, 4))
    X = tf.solve(B)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res


def test_facade_coupled_tracers(tmp_path):
    """The coupled-tracer case of tests/test_mf_jax.py (12x10x4)."""
    circ, mat = str(tmp_path / "circ.nc"), str(tmp_path / "m.nc")
    make_circ_file(circ, imt=12, jmt=10, km=4, seed=35)
    pts = [PerTracerOptions(sink_type="const", sink_rate=2e-4),
           PerTracerOptions(sink_type="const", sink_rate=1e-4)]
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="const", vmix_type="const",
        coupled_tracer_cnt=2, per_tracer=pts,
        coupled_tracer_type="OCMIP_BGC_PO4_DOP"))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    fac = MultifrontalFactorization(matrix, maps=maps, leaf_size=6,
                                    device="cpu")
    b = np.random.default_rng(5).standard_normal(matrix.flat_len)
    x = fac.solve(b)
    A = matrix.to_scipy()
    # 1e-10 is the workflow's accuracy target; scipy's SuperLU reaches
    # ~1.2e-10 on this system
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_facade_residual_with_spill(fixture_pair, monkeypatch):
    matrix, maps, tf, _ = fixture_pair
    real_quantile = np.quantile
    monkeypatch.setattr(np, "quantile",
                        lambda a, q, **kw: min(real_quantile(a, q, **kw), 4.0))
    fac = MultifrontalFactorization(matrix, maps=maps, sym=tf.sym,
                                    device="cpu")
    assert any((p.a_pos < p.N * p.N).any() for p in fac.engine.plans)
    B = np.random.default_rng(7).standard_normal((matrix.flat_len, 2))
    X = fac.solve(B)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res


def test_refactor_and_validate(fixture_pair):
    """refactor() rebuilds the same factors (the CPU run is deterministic);
    validate() counts every factor entry and finds none non-finite."""
    _, _, tf, _ = fixture_pair
    before = [tuple(t.clone() for t in f) for f in tf.engine.factors]
    tf.refactor()
    for old, new in zip(before, tf.engine.factors):
        for a, b in zip(old, new):
            assert torch.equal(a, b)
    report = tf.validate()
    assert report["nonfinite_factor_entries"] == 0
    assert report["factor_entries"] == sum(
        t.numel() for f in tf.engine.factors for t in f[:3])
    tf.engine.factors[0][0][0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        tf.validate()
    tf.refactor()
    assert tf.validate()["nonfinite_factor_entries"] == 0


def test_facade_needs_maps_or_sym(fixture_pair):
    matrix, _, _, _ = fixture_pair
    with pytest.raises(ValueError, match="index maps"):
        MultifrontalFactorization(matrix, device="cpu")


@pytest.fixture(scope="module")
def raw_pair(fixture_pair):
    """The 20x16x6 fixture factored by both facades without Ruiz scaling
    (equilibrate_matrix=False), on one symbolic analysis."""
    matrix, maps, tf, _ = fixture_pair
    raw = MultifrontalFactorization(matrix, maps=maps, sym=tf.sym,
                                    device="cpu", equilibrate_matrix=False)
    jraw = JaxFactorization(matrix, impl="jax", maps=maps, sym=tf.sym,
                            equilibrate_matrix=False)
    return matrix, raw, jraw


@pytest.mark.parametrize("nrhs", [1, 2, 4])
def test_unequilibrated_solve_matches_jax(raw_pair, nrhs):
    """equilibrate_matrix=False through both facades: the raw matrix is
    factored (no dr, dc) and the refined solutions agree to 1e-12, as the
    equilibrated ones do (test_solve_matches_jax)."""
    matrix, raw, jraw = raw_pair
    assert raw.dr is None and raw.dc is None and jraw.dr is None
    assert raw._fac_matrix is matrix
    B = np.random.default_rng(nrhs).standard_normal((matrix.flat_len, nrhs))
    X = raw.solve(B)
    assert _rel(X, np.asarray(jraw.solve(B))) <= 1e-12
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res


def test_unequilibrated_refactor_skips_ruiz(fixture_pair, monkeypatch):
    """A refactor with equilibrate_matrix=False never calls equilibrate,
    with new values or without, and its solve meets the contract."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import api, mf
    matrix, maps, tf, _ = fixture_pair

    def refuse(*a, **kw):
        raise AssertionError("equilibrate called")
    monkeypatch.setattr(mf, "equilibrate", refuse)
    fac = api.factor(matrix, maps=maps, sym=tf.sym, device="cpu",
                     equilibrate_matrix=False)
    B = np.random.default_rng(9).standard_normal((matrix.flat_len, 2))
    fac.solve(B)
    new = SparseMatrix(nzval=matrix.nzval * 1.5, colind=matrix.colind,
                       rowptr=matrix.rowptr,
                       coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    fac.refactor(new)
    assert fac._fac_matrix is new and fac.dr is None and fac.dc is None
    fac.refactor()
    X = fac.solve(B)
    A = new.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res
    with pytest.raises(AssertionError, match="equilibrate called"):
        MultifrontalFactorization(matrix, maps=maps, sym=tf.sym,
                                  device="cpu")


def test_validate_detects_a_singular_matrix(tmp_path):
    """tests/test_observability.py's fixture through the port: validate()
    passes on the factored matrix and raises FloatingPointError on an
    all-zero one factored without equilibration."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import (
        run_gen_a as port_gen_a)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps as port_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix, read_matrix_file as port_read)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        AssemblyOptions as PortOptions, PerTracerOptions as PortPerTracer)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file as port_circ)
    circ, mat = str(tmp_path / "c.nc"), str(tmp_path / "m.nc")
    port_circ(circ, imt=12, jmt=10, km=4, seed=70)
    pt = PortPerTracer(sink_type="const", sink_rate=1e-4)
    port_gen_a(mat, opts=PortOptions(circ_fname=circ, hmix_type="const",
                                     vmix_type="file", per_tracer=[pt]))
    matrix, maps = port_read(mat), port_maps(mat)
    fac = MultifrontalFactorization(matrix, maps=maps, device="cpu")
    assert fac.validate()["nonfinite_factor_entries"] == 0
    sing = SparseMatrix(nzval=np.zeros_like(matrix.nzval),
                        colind=matrix.colind, rowptr=matrix.rowptr,
                        coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    fac2 = MultifrontalFactorization(sing, maps=maps, sym=fac.sym,
                                     device="cpu", equilibrate_matrix=False)
    with pytest.raises(FloatingPointError):
        fac2.validate()
