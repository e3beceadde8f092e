"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and skip without one. The file imports
neither jax nor the JAX package (the machine with the card has no jax), so
it runs there on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (AssemblyOptions,
                                                           PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.plan import build_plan
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import make_circ_file


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The 20x16x6 fixture of tests/test_mf_jax.py."""
    d = tmp_path_factory.mktemp("torch_cuda")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    return read_matrix_file(mat), load_ind_maps(mat)


# panel shapes (B, R, T, off): tests/test_pallas_kernels.py's, a few-front
# multi-CTA cluster (16, 640), the 256-front gx3 shape, a ragged one, and
# tall panels that walk column slabs (R = 4096 and 8192)
PANEL_SHAPES = [(4, 256, 128, 128), (3, 128, 128, 0), (2, 512, 64, 0),
                (16, 640, 128, 0), (256, 512, 128, 0), (5, 40, 40, 0),
                (3, 4096, 128, 0), (4, 8192, 128, 0)]


def _panel_matches_plain(card, B, R, T, off, dtype):
    rng = np.random.default_rng(0)
    Pan = torch.from_numpy(rng.standard_normal((B, R, T))).to(card, dtype)
    p_arr = torch.from_numpy(
        np.linspace(0, off + R, B).astype(np.int32)).to(card)
    key = f"pivoted_panel_{ck.SUFFIX[dtype]}"
    for tau in (0.0, 0.05):
        before = ck.LAUNCHES[key]
        Pk, pk, permk = ck.pivoted_panel(Pan, off, p_arr, tau)
        Pp, pp, permp = ck.pivoted_panel_plain(Pan, off, p_arr, tau)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[key] == before + 1
        assert Pk.dtype == dtype and permk.dtype == torch.int64
        assert torch.equal(pk, pp) and torch.equal(permk, permp)
        assert torch.equal(Pk, Pp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,T,off", PANEL_SHAPES)
def test_panel_kernel_matches_plain(card, B, R, T, off):
    """K1 bit for bit against its plain version: values, piv and perm."""
    _panel_matches_plain(card, B, R, T, off, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,T,off", PANEL_SHAPES)
def test_panel_kernel_matches_plain_f32(card, B, R, T, off):
    """K2, the f32 instance, bit for bit against its plain version."""
    _panel_matches_plain(card, B, R, T, off, torch.float32)


@pytest.mark.cuda
def test_panel_smem_rule_matches_kernel(card):
    """cuda_kernels.panel_smem_bytes mirrors the kernel's own count, and
    the card keeps clusters of every size the rule may pick active."""
    lib = ck.build()
    for rows, nb, isz in ((103, 128, 8), (1024, 24, 8), (64, 128, 4),
                          (5, 40, 4)):
        assert (lib.nk_pivoted_panel_smem(rows, nb, isz)
                == ck.panel_smem_bytes(rows, nb, isz))
    for C in range(1, ck.PANEL_MAX_CLUSTER + 1):
        assert ck.active_clusters(C, -(-128 // C), 128, 8) > 0
    assert ck.active_clusters(1, 512, 128, 8) == 0


def _ell_kernel_matches_plain(card, problem, monkeypatch, dtype):
    matrix, maps = problem
    sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
    real_quantile = np.quantile
    monkeypatch.setattr(np, "quantile",
                        lambda a, q, **kw: min(real_quantile(a, q, **kw), 4.0))
    plans = build_plan(sym, matrix)
    monkeypatch.undo()
    assert any((p.a_pos < p.N * p.N).any() for p in plans)
    nz = np.zeros(matrix.nnz + 1)
    nz[:-1] = matrix.nzval
    nzd = torch.from_numpy(nz).to(card, dtype)
    for p in plans:
        spill = bool((p.a_pos < p.N * p.N).any())
        idx = [torch.from_numpy(a).to(card, torch.int64)
               for a in (p.a_col, p.a_csrc, p.a_pos, p.a_src)]
        p_arr = torch.from_numpy(p.p_arr).to(card)
        got = ck.ell_assemble(nzd, *idx, p_arr, p.N, p.P, spill)
        want = ck.ell_assemble_plain(nzd, *idx, p_arr, p.N, p.P, spill)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_ell_kernel_matches_plain_with_spill(card, problem, monkeypatch):
    _ell_kernel_matches_plain(card, problem, monkeypatch, torch.float64)


@pytest.mark.cuda
def test_ell_kernel_matches_plain_with_spill_f32(card, problem, monkeypatch):
    _ell_kernel_matches_plain(card, problem, monkeypatch, torch.float32)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card, problem):
    """Factor and solve on the card through both kernels: same perms as
    the CPU run, refined residual <= 1e-11."""
    matrix, maps = problem
    before = dict(ck.LAUNCHES)
    gpu = MultifrontalFactorization(matrix, maps=maps, device=card)
    assert all(ck.LAUNCHES[k] > before[k]
               for k in ("pivoted_panel_f64", "ell_assemble_f64"))
    cpu = MultifrontalFactorization(matrix, maps=maps, sym=gpu.sym,
                                    device="cpu")
    for g, c in zip(gpu.engine.factors, cpu.engine.factors):
        assert np.array_equal(g[3].cpu().numpy(), c[3].numpy())
    B = np.random.default_rng(4).standard_normal((matrix.flat_len, 4))
    X = gpu.solve(B)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res
    assert isinstance(gpu.engine, mf_torch.TorchMultifrontal)


@pytest.mark.cuda
def test_f32_engine_on_card_matches_cpu(card, problem):
    """The f32 engine on the card through K2 and K3-f32 against the same
    engine on the CPU: both refine to 1e-11 on their f32 factors without
    escalating, and agree to 1e-10 relative. Perms are not compared: at
    f32 the pivots sit on the knife's edge, and the card's and the CPU's
    TRSM/GEMM round differently in the last bits."""
    matrix, maps = problem
    before = dict(ck.LAUNCHES)
    gpu = MultifrontalFactorization(matrix, maps=maps, device=card,
                                    precision="f32")
    assert all(ck.LAUNCHES[k] > before[k]
               for k in ("pivoted_panel_f32", "ell_assemble_f32"))
    cpu = MultifrontalFactorization(matrix, maps=maps, sym=gpu.sym,
                                    device="cpu", precision="f32")
    B = np.random.default_rng(6).standard_normal((matrix.flat_len, 4))
    Xg, Xc = gpu.solve(B), cpu.solve(B)
    assert gpu.engine.prec == cpu.engine.prec == torch.float32
    A = matrix.to_scipy()
    for X in (Xg, Xc):
        res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
        assert res.max() < 1e-11, res
    assert np.abs(Xg - Xc).max() <= 1e-10 * np.abs(Xc).max()


def _max_res(matrix, X, B) -> float:
    A = matrix.to_scipy()
    return float((np.linalg.norm(A @ X - B, axis=0)
                  / np.linalg.norm(B, axis=0)).max())


@pytest.mark.cuda
def test_f32_fused_fgmres_on_card(card, problem):
    """The fused f32 FGMRES path on f32 factors on the card. This fixture's
    f32 factors refine by plain IR alone, so both refiners start in the
    memoized Krylov phase, where a factorization whose plain refinement
    stalled far from the target solves from: no host apply, fused cycles
    first, the factors stay f32, both reach 1e-11 and agree to 1e-10
    relative (both sit near the f64 attainable floor, ~3e-13)."""
    matrix, maps = problem
    B = np.random.default_rng(9).standard_normal((matrix.flat_len, 4))
    out = []
    for dev in (card, "cpu"):
        fac = MultifrontalFactorization(matrix, maps=maps, device=dev,
                                        precision="f32")
        ref = fac._device_refiner()
        ref._phase = "gmres"
        X = fac.solve(B)
        s = ref.stats
        assert fac.engine.prec == torch.float32 and fac.escalation is None
        assert s["phases"][0] == "gmres" and s["host_applies"] == 0, s
        assert s["cycles"] >= 2, s
        assert _max_res(matrix, X, B) <= 1e-11, s
        out.append(X)
    assert np.abs(out[0] - out[1]).max() <= 1e-10 * np.abs(out[1]).max()


@pytest.mark.cuda
def test_hi_rounds_on_card(card, problem, monkeypatch):
    """The float64 substitution of tree-top rounds on f32 factors
    (mf_torch._hi_round) on the card. With HI_ROUND_MIN_P at 1 every round
    runs it on CUDA tensors while the workspace stays f32; the refined
    solution reaches 1e-11 and agrees with the CPU run at the same setting
    to 1e-10 relative."""
    matrix, maps = problem
    monkeypatch.setattr(mf_torch, "HI_ROUND_MIN_P", 1)
    calls = []
    real = mf_torch.fwd_round

    def counted(W, *args, **kw):
        calls.append((W.device.type, W.dtype, args[-1]))
        return real(W, *args, **kw)
    monkeypatch.setattr(mf_torch, "fwd_round", counted)
    B = np.random.default_rng(10).standard_normal((matrix.flat_len, 2))
    out = []
    for dev in (card, "cpu"):
        fac = MultifrontalFactorization(matrix, maps=maps, device=dev,
                                        precision="f32")
        assert all(fac.engine._hi_round(p) for p in fac.engine.plans)
        out.append(fac.solve(B))
        assert fac.engine.prec == torch.float32
        assert _max_res(matrix, out[-1], B) <= 1e-11
    assert ("cuda", torch.float32, True) in calls
    assert all(hi for _, _, hi in calls)
    assert np.abs(out[0] - out[1]).max() <= 1e-10 * np.abs(out[1]).max()
