"""The port's checkpoints against the JAX package's, on the CPU.

Round checkpoints and whole-set factor files cross between the two
packages in both directions and solve to the 1e-10 contract; the port's
checkpoint key equals the JAX engine's; and the port's engine carries the
behaviour the JAX tests pin (tests/test_checkpoint.py,
tests/test_factor_only.py): resume, factor-only continuation, stop-after,
death before save, Schur repair, offload equal to resident. The problem is
the 20x16x6 fixture of tests/test_mf_jax.py (four rounds in a chain, so
Schur stacks cross rounds); JAX factors at f64 under tests/conftest.py.
"""

import os
import shutil
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                     PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver import checkpoint as jck
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import JaxMultifrontal
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import checkpoint as tck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import memplan
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf_torch import (
    TorchMultifrontal)

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
    """matrix, maps, the port's symbolic analysis and the equilibrated
    matrix the engines factor."""
    d = tmp_path_factory.mktemp("torch_ckpt")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    fac = MultifrontalFactorization(matrix, maps=maps, device="cpu")
    return matrix, maps, fac


@pytest.fixture(scope="module")
def jax_fac(problem):
    """The JAX facade at f64 on the same symbolic analysis (factors once)."""
    matrix, maps, fac = problem
    return JaxFactorization(matrix, impl="jax", maps=maps, sym=fac.sym)


@pytest.fixture(scope="module")
def jax_rounds(problem, tmp_path_factory):
    """Round checkpoints written by a factor-only JAX engine at f64."""
    matrix, _, fac = problem
    d = str(tmp_path_factory.mktemp("jax_rounds") / "ck")
    eng = JaxMultifrontal(fac.sym, fac._fac_matrix, precision=jnp.float64,
                          checkpoint_dir=d, factor_only=True)
    assert eng.factors is None
    return d


@pytest.fixture
def count_asm(monkeypatch):
    """The number of rounds the port assembles (K3's wrapper calls)."""
    calls = []
    real = ck.ell_assemble

    def counted(*args, **kw):
        calls.append(args[6])
        return real(*args, **kw)
    monkeypatch.setattr(ck, "ell_assemble", counted)
    return calls


def _max_res(matrix, X, B) -> float:
    A = matrix.to_scipy()
    return float((np.linalg.norm(A @ X - B, axis=0)
                  / np.linalg.norm(B, axis=0)).max())


def _rhs(matrix, seed, nrhs=2):
    return np.random.default_rng(seed).standard_normal(
        (matrix.flat_len, nrhs))


def _round_files(d):
    return sorted(f for f in os.listdir(d)
                  if f.endswith(".npz") and "_S" not in f)


def _assert_factors_equal(a, b):
    for ra, rb in zip(a, b, strict=True):
        for x, y in zip(ra, rb, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# the checkpoint key
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("pack_bs", [None, 64])
def test_ckpt_digest_matches_jax(problem, tmp_path, prec, pack_bs):
    """_ckpt_for hashes the same bytes as the JAX engine's: the values in
    the factor dtype, the plan shape, the layout version and, off 128, the
    pack block size (the fixture's adaptive width is 128; 64 keys in)."""
    matrix, _, fac = problem
    t = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, factorize=False,
                          prec=getattr(torch, f"float{prec[1:]}"),
                          checkpoint_dir=str(tmp_path))
    j = JaxMultifrontal(fac.sym, fac._fac_matrix, factorize=False,
                        precision=getattr(jnp, f"float{prec[1:]}"),
                        checkpoint_dir=str(tmp_path))
    assert t._pack_bs == j._pack_bs == 128
    if pack_bs is not None:
        t._pack_bs = j._pack_bs = pack_bs
    got = t._ckpt_for(fac._fac_matrix).nzhash
    assert got == j._ckpt_for(fac._fac_matrix).nzhash
    other = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU,
                              factorize=False, checkpoint_dir=str(tmp_path),
                              prec=torch.float32 if prec == "f64"
                              else torch.float64)
    if pack_bs is not None:
        other._pack_bs = pack_bs
    assert other._ckpt_for(fac._fac_matrix).nzhash != got


# --------------------------------------------------------------------------
# round checkpoints across the packages
# --------------------------------------------------------------------------

def test_port_resumes_jax_rounds(problem, jax_rounds, tmp_path, count_asm):
    """A JAX factor-only pass's round checkpoints resume in the port's
    facade: every round loads (no assembly), the factors stream back, and
    the refined solve meets the contract."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    shutil.copytree(jax_rounds, d)
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", factor_checkpoint_dir=d)
    assert count_asm == []
    eng = got.engine
    assert eng._scan_done(eng._ckpt) == set(range(len(eng.plans)))
    assert all(f[3].dtype == torch.int64 for f in eng.factors)
    B = _rhs(matrix, 1)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10
    # the same pivots and, to the two packages' LAPACK and BLAS rounding
    # over the whole chain (2.0e-12 measured), the same factors as the port
    # computes
    for a, b in zip(eng.factors, fac.engine.factors):
        assert torch.equal(a[3], b[3])
        for x, y in zip(a[:3], b[:3]):
            if y.numel():
                assert float((x - y).abs().max() / y.abs().max()) <= 1e-11


def test_jax_resumes_port_rounds(problem, tmp_path):
    """The reverse: round checkpoints written by a factor-only port engine
    resume in the JAX facade, every round from disk, to the contract."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True)
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=fac.sym,
                          factor_checkpoint_dir=d)
    eng = jf.engine
    assert eng._scan_done(eng._ckpt) == set(range(len(eng.plans)))
    B = _rhs(matrix, 2)
    assert _max_res(matrix, np.asarray(jf.solve(B)), B) <= 1e-10


def test_round_files_are_trimmed_and_v2_loads(problem, tmp_path):
    """The port writes the v3 trimmed format, whose padded reconstruction
    equals the engine's own padded factors (identity K padding); a v2
    padded file (with a narrower int perm, as older writers kept it) loads
    to the same tensors."""
    matrix, _, fac = problem
    eng = fac.engine
    d = str(tmp_path / "ck")
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True)
    with np.load(os.path.join(d, _round_files(d)[0])) as z:
        assert "blocks" in z.files and "FP" not in z.files
    v2 = tck.FactorRoundCheckpointer(str(tmp_path / "v2"), "key")
    v3 = tck.FactorRoundCheckpointer(d, "unused")
    for rnd, (plan, f) in enumerate(zip(eng.plans, eng.factors)):
        K, U12, L21, perm = (t.numpy() for t in f)
        np.savez(v2._path(rnd), FP=np.concatenate([K, U12], axis=2),
                 L21=L21, perm=perm.astype(np.int32), meta=v2._meta(plan),
                 nzhash="key")
        for ckp in (v2, v3):
            got = ckp.load_round(rnd, plan, eng, need_schur=False)
            assert got[4] is None
            _assert_factors_equal([got[:4]], [f])


# --------------------------------------------------------------------------
# whole-set factor files across the packages
# --------------------------------------------------------------------------

def test_factor_file_jax_to_port(problem, jax_fac, tmp_path, count_asm):
    """save_factors of the JAX facade loads into the port's facade
    (numeric_checkpoint): no round is factored, the refined solve meets the
    contract and the unrefined one equals the JAX facade's to the two
    packages' solve rounding."""
    matrix, maps, fac = problem
    f = str(tmp_path / "factors.npz")
    jck.save_factors(f, jax_fac)
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", numeric_checkpoint=f)
    assert count_asm == [] and "load_factors" in got.timings
    B = _rhs(matrix, 3)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10
    raw = np.asarray(jax_fac.solve(B, refine=False))
    assert (np.abs(got.solve(B, refine=False) - raw).max()
            <= 1e-12 * np.abs(raw).max())


def test_factor_file_port_to_jax(problem, tmp_path):
    """save_factors of the port's facade loads into the JAX facade, which
    then solves to the contract; its unrefined solve equals the port's."""
    matrix, maps, fac = problem
    f = str(tmp_path / "factors.npz")
    tck.save_factors(f, fac)
    jf = JaxFactorization(matrix, impl="jax", maps=maps, sym=fac.sym,
                          numeric_checkpoint=f)
    # loaded, not refactored: the JAX engine holds the port's bits
    for a, b in zip(jf.engine.factors, fac.engine.factors, strict=True):
        for x, y in zip(a[:4], b, strict=True):
            assert np.array_equal(np.asarray(x), y.numpy())
    B = _rhs(matrix, 4)
    assert _max_res(matrix, np.asarray(jf.solve(B)), B) <= 1e-10
    raw = fac.solve(B, refine=False)
    assert (np.abs(np.asarray(jf.solve(B, refine=False)) - raw).max()
            <= 1e-12 * np.abs(raw).max())


def test_factor_file_roundtrip_and_rejection(problem, tmp_path, count_asm):
    """The port's --factors path: the first facade factors and writes the
    file, the second loads it (no assembly) and solves bit for bit alike;
    stale values and another pack width are rejected by load_factors, and
    the facade then refactors, writes the file anew and meets the
    contract."""
    matrix, maps, fac = problem
    f = str(tmp_path / "factors.npz")
    first = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                      device="cpu", numeric_checkpoint=f)
    n_rounds = len(first.engine.plans)
    assert len(count_asm) == n_rounds and os.path.exists(f)
    second = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                       device="cpu", numeric_checkpoint=f)
    assert len(count_asm) == n_rounds
    _assert_factors_equal(second.engine.factors, first.engine.factors)
    B = _rhs(matrix, 5)
    assert np.array_equal(second.solve(B, refine=False),
                          first.solve(B, refine=False))

    m2 = type(matrix)(nzval=np.asarray(matrix.nzval) * 1.5,
                      colind=matrix.colind, rowptr=matrix.rowptr,
                      coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    stale = MultifrontalFactorization(m2, maps=maps, sym=fac.sym,
                                      device="cpu")
    with pytest.raises(ValueError, match="VALUES"):
        tck.load_factors(f, stale)
    second.engine._pack_bs = 64
    with pytest.raises(ValueError, match="pack_bs"):
        tck.load_factors(f, second)
    before = os.path.getmtime(f)
    third = MultifrontalFactorization(m2, maps=maps, sym=fac.sym,
                                      device="cpu", numeric_checkpoint=f)
    assert "load_factors" not in third.timings
    assert len(count_asm) == 3 * n_rounds       # stale refactored
    assert os.path.getmtime(f) >= before
    with np.load(f) as z:
        assert str(z["nzhash"][0]) == tck._nzhash(m2)
    assert _max_res(m2, third.solve(B), B) <= 1e-10


def test_symbolic_roundtrip_across_packages(problem, tmp_path):
    """save_symbolic of either package loads in the other to the same
    analysis; the port factors bit for bit alike on the reloaded one."""
    matrix, maps, fac = problem
    sym = fac.sym
    for save, load in ((tck.save_symbolic, jck.load_symbolic),
                       (jck.save_symbolic, tck.load_symbolic)):
        path = str(tmp_path / f"sym_{save.__module__.split('.')[0]}.npz")
        save(path, sym)
        got = load(path)
        assert np.array_equal(got.perm, sym.perm)
        assert (got.flat_len, got.rounds) == (sym.flat_len, sym.rounds)
        for nid, f in sym.fronts.items():
            g = got.fronts[nid]
            assert np.array_equal(f.cells, g.cells)
            assert (f.p, f.n, f.parent, f.round, f.children) \
                == (g.p, g.n, g.parent, g.round, g.children)
    again = MultifrontalFactorization(matrix, maps=maps, sym=got,
                                      device="cpu")
    _assert_factors_equal(again.engine.factors, fac.engine.factors)


# --------------------------------------------------------------------------
# factor-only, offload, resume (the port's engine alone)
# --------------------------------------------------------------------------

def test_factor_only_then_solve_elsewhere(problem, tmp_path, count_asm):
    """A factor-only engine writes every round and holds no factors; a
    normal engine on the directory loads every round (no assembly) and
    solves to the contract."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                            factor_only=True)
    n_rounds = len(eng.plans)
    assert eng._offload and eng.factors is None
    with pytest.raises(RuntimeError, match="no numeric factors"):
        eng.solve(np.zeros(matrix.flat_len))
    assert len(_round_files(d)) == n_rounds
    assert not [f for f in os.listdir(d) if f.endswith("_S.npy")]
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", factor_checkpoint_dir=d)
    assert len(count_asm) == n_rounds
    _assert_factors_equal(got.engine.factors, fac.engine.factors)
    B = _rhs(matrix, 6)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10


def test_stop_after_then_continue(problem, tmp_path, count_asm):
    """stop_after hands off after a round (its Schur stack kept on disk);
    a factor-only resume uploads no constants for the rounds on disk and
    assembles each remaining round once; the set then equals a resident
    factorization's."""
    matrix, _, fac = problem
    d = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="factor_only"):
        TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                          stop_after=1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, factor_only=True)
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True, stop_after=1)
    assert _round_files(d) == ["round_0000.npz", "round_0001.npz"]
    assert os.path.exists(os.path.join(d, "round_0001_S.npy"))
    n_rounds = len(fac.engine.plans)
    assert len(count_asm) == 2
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                            factor_only=True)
    assert [c is None for c in eng._consts] == [True, True] \
        + [False] * (n_rounds - 2)
    assert len(count_asm) == n_rounds
    res = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d)
    assert len(count_asm) == n_rounds
    _assert_factors_equal(res.factors, fac.engine.factors)


def test_resume_frees_loaded_schur_after_its_last_consumer(
        problem, tmp_path, monkeypatch):
    """A factor-only resume holds a Schur stack it loaded from disk only
    until its last consumer has extend-added it: when a later round
    assembles, the stack is gone."""
    _, _, fac = problem
    d = str(tmp_path / "ck")
    plans = fac.engine.plans
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True, stop_after=0)
    last = {}
    for rnd, plan in enumerate(plans):
        for g in plan.child_groups:
            last[g.src_round] = rnd
    loaded, seen = {}, []
    real_load = tck.FactorRoundCheckpointer.load_round

    def load(self, rnd, *a, **kw):
        out = real_load(self, rnd, *a, **kw)
        if out is not None and out[4] is not None:
            loaded[rnd] = weakref.ref(out[4])
        return out
    real_asm = ck.ell_assemble

    def asm(*a, **kw):
        rnd = 1 + len(seen)                   # rounds 1.. are computed
        seen.append(sorted(s for s, ref in loaded.items()
                           if ref() is not None and last[s] < rnd))
        return real_asm(*a, **kw)
    monkeypatch.setattr(tck.FactorRoundCheckpointer, "load_round", load)
    monkeypatch.setattr(ck, "ell_assemble", asm)
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True)
    assert loaded and len(seen) == len(plans) - 1
    assert seen == [[]] * (len(plans) - 1)


def test_vanished_checkpoint_is_recomputed(problem, tmp_path, count_asm):
    """A round whose checkpoint is gone by the time a factor-only engine
    refactors is recomputed, its constants built then, and the directory
    ends whole; a refactor with other values (another key) recomputes
    every round, the ones it had loaded before included."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    n_rounds = len(fac.engine.plans)
    TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                      factor_only=True, stop_after=1)
    eng = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d,
                            factor_only=True)
    assert eng._consts[0] is None
    os.remove(os.path.join(d, "round_0000.npz"))
    del count_asm[:]
    eng.refactor(fac._fac_matrix)
    assert count_asm == [eng.plans[0].N]
    assert eng._consts[0] is not None
    assert len(_round_files(d)) == n_rounds
    m2 = type(fac._fac_matrix)(
        nzval=np.asarray(fac._fac_matrix.nzval) * 2.0,
        colind=fac._fac_matrix.colind, rowptr=fac._fac_matrix.rowptr,
        coupled_tracer_cnt=fac._fac_matrix.coupled_tracer_cnt)
    del count_asm[:]
    eng.refactor(m2)
    assert len(count_asm) == n_rounds
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", factor_checkpoint_dir=d)
    assert len(count_asm) == 2 * n_rounds       # m2's files: a stale key
    B = _rhs(matrix, 13)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10


def _interrupted(fac, d, monkeypatch, n_keep, before_save):
    """Factor into ``d`` until a save of round >= n_keep (or the save of
    round n_keep - 1) raises, leaving the directory a process death
    leaves."""
    class _Died(RuntimeError):
        pass

    real = tck.FactorRoundCheckpointer.save_round

    def dying(self, rnd, *args, **kw):
        if before_save and rnd >= n_keep:
            raise _Died
        real(self, rnd, *args, **kw)
        if not before_save and rnd + 1 >= n_keep:
            raise _Died
    monkeypatch.setattr(tck.FactorRoundCheckpointer, "save_round", dying)
    with pytest.raises(_Died):
        TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, checkpoint_dir=d)
    monkeypatch.setattr(tck.FactorRoundCheckpointer, "save_round", real)


def test_death_before_save_leaves_resumable_prefix(problem, tmp_path,
                                                   monkeypatch, count_asm):
    """A death after the last round's extend-add consumed its sources'
    Schur stacks but before its own save leaves every earlier round
    resumable: sources' files go only after the consumer's save."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    n_rounds = len(fac.engine.plans)
    _interrupted(fac, d, monkeypatch, n_rounds - 1, before_save=True)
    del count_asm[:]
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", factor_checkpoint_dir=d)
    assert got.engine._scan_done(got.engine._ckpt) == set(range(n_rounds))
    assert len(count_asm) == 1
    B = _rhs(matrix, 7)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10


def test_schur_repair_keeps_banked_factors(problem, tmp_path, monkeypatch):
    """A round whose factors are on disk but whose needed Schur file is
    gone is recomputed for its Schur only: its factor file is not
    rewritten, every round ends on disk, the Schur files are swept, and
    the factors equal a resident factorization's."""
    matrix, maps, fac = problem
    d = str(tmp_path / "ck")
    plans = fac.engine.plans
    n_keep = len(plans) - 1
    _interrupted(fac, d, monkeypatch, n_keep, before_save=False)
    victims = sorted({g.src_round for p in plans[n_keep:]
                      for g in p.child_groups
                      if os.path.exists(os.path.join(
                          d, f"round_{g.src_round:04d}_S.npy"))})
    assert victims
    victim = os.path.join(d, f"round_{victims[0]:04d}.npz")
    os.remove(os.path.join(d, f"round_{victims[0]:04d}_S.npy"))
    mtime = os.path.getmtime(victim)
    got = MultifrontalFactorization(matrix, maps=maps, sym=fac.sym,
                                    device="cpu", factor_checkpoint_dir=d)
    assert os.path.getmtime(victim) == mtime
    files = os.listdir(d)
    assert sum(f.endswith(".npz") for f in files) == len(plans)
    assert not any(f.endswith("_S.npy") for f in files)
    _assert_factors_equal(got.engine.factors, fac.engine.factors)
    B = _rhs(matrix, 8)
    assert _max_res(matrix, got.solve(B), B) <= 1e-10


# --------------------------------------------------------------------------
# the engine's memory plan (its peaks are held against the card's in
# chip_smoke.py phase 7c; here, its pieces against the engine's own)
# --------------------------------------------------------------------------

def test_memory_plan_counts_the_engines_constants(problem):
    """engine_round_peaks counts each round's device constants as the
    engine builds them (the border's pads dropped: at most the plan's
    count)."""
    _, _, fac = problem
    eng = fac.engine
    for plan, cc in zip(eng.plans, eng._consts):
        got = sum(t.nbytes for t in (
            cc["a_col"], cc["a_csrc"], cc["a_pos"], cc["a_src"], cc["p_arr"],
            cc["own"], cc["bor"], *cc["border"][:2])) + sum(
            t.nbytes for g in cc["groups"] for t in g[1:4])
        planned = memplan._consts_bytes(plan)
        assert planned - 16 * plan.cells_bor.size <= got <= planned


def test_memory_plan_resident_holds_more(problem):
    """The resident engine (every constant first, factors kept) plans at
    least the factor-only pass's bytes in every round, and more in the
    last; a round never plans less than its front stack and outputs; a
    smaller pack width never plans more."""
    _, _, fac = problem
    plans, nnz = fac.engine.plans, fac._fac_matrix.nnz
    only = memplan.engine_round_peaks(plans, 8, nnz, 128)
    res = memplan.engine_round_peaks(plans, 8, nnz, 128, factor_only=False)
    assert all(r >= o for r, o in zip(res, only)) and res[-1] > only[-1]
    assert all(o >= 8 * p.B * (2 * p.N * p.N) for o, p in zip(only, plans))
    narrow = memplan.engine_round_peaks(plans, 8, nnz, 64)
    assert all(a <= b for a, b in zip(narrow, only))


@pytest.mark.parametrize("prec", [torch.float64, torch.float32])
def test_offload_equals_resident(problem, tmp_path, prec):
    """Offloaded factors (dropped after each save, streamed back from the
    trimmed files) equal resident ones (torch.equal), and so does the
    unrefined solve."""
    matrix, _, fac = problem
    runs = {}
    for name, offload in (("resident", False), ("offload", True)):
        runs[name] = TorchMultifrontal(
            fac.sym, fac._fac_matrix, CPU, prec=prec,
            checkpoint_dir=str(tmp_path / name), offload=offload)
    plain = TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, prec=prec)
    assert runs["offload"]._offload and not runs["resident"]._offload
    _assert_factors_equal(runs["offload"].factors, runs["resident"].factors)
    _assert_factors_equal(runs["offload"].factors, plain.factors)
    B = _rhs(matrix, 9)
    assert np.array_equal(runs["offload"].solve(B), plain.solve(B))

