"""The port's CUDA kernels against their plain PyTorch versions, on a card,
and the engine's solve sweep replayed as a CUDA graph against its eager
sweep.

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
@pytest.mark.parametrize("nrhs", [1, 4, 9])
def test_csr_residual_kernel_matches_plain(card, problem, nrhs):
    """The refiner's product kernel on its own ELL operands, bit for bit
    against its plain version on the card and scipy's A @ X (so b minus it
    is scipy's B - A @ X), pad rows included; a refined solve counts one
    launch per device residual."""
    matrix, maps = problem
    fac = MultifrontalFactorization(matrix, maps=maps, device=card)
    ref = fac._device_refiner()
    n = matrix.flat_len
    assert bool((ref._ell_col == n).any())
    rng = np.random.default_rng(nrhs)
    X = rng.standard_normal((n, nrhs)) * np.exp(rng.uniform(-8, 8, (n, 1)))
    B = rng.standard_normal((n, nrhs))
    Xd, Bd = (torch.from_numpy(a).to(card) for a in (X, B))
    before = ck.LAUNCHES["csr_matvec_f64"]
    got = ck.csr_matvec(ref._ell_col, ref._ell_val64, Xd)
    want = ck.csr_matvec_plain(ref._ell_col, ref._ell_val64, Xd)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["csr_matvec_f64"] == before + 1
    assert torch.equal(got, want)
    A = matrix.to_scipy()
    assert np.array_equal(got.cpu().numpy(), A @ X)
    assert np.array_equal((Bd - got).cpu().numpy(), B - A @ X)
    before = ck.LAUNCHES["csr_matvec_f64"]
    fac.solve(B)
    st = ref.stats
    assert (ck.LAUNCHES["csr_matvec_f64"] - before
            == st["device_residuals"] >= 1)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [40, 100, 200])
def test_csr_residual_kernel_wide_rows(card, E):
    """Rows wider than the fixture's, which take fewer rows a block and,
    from E = 97 on, more than 48 KB of shared memory; 1 and 9 right-hand
    sides (a pass of 8 and one of 1), a last block left part empty."""
    from scipy import sparse

    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.refine import (
        DeviceRefiner)
    n = 1000
    rng = np.random.default_rng(E)
    lens = rng.integers(1, E + 1, n)
    lens[0] = E
    indptr = np.r_[0, np.cumsum(lens)]
    indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lens])
    A = sparse.csr_matrix((rng.standard_normal(indptr[-1]), indices,
                           indptr), shape=(n, n))
    ref = DeviceRefiner.__new__(DeviceRefiner)
    ref.n, ref._rowptr, ref.device = n, A.indptr, card
    ref._bind_matrix(SparseMatrix(nzval=A.data, colind=A.indices,
                                  rowptr=A.indptr, coupled_tracer_cnt=1))
    assert ref._ell_col.shape == (n, E)
    for nrhs in (1, 9):
        X = rng.standard_normal((n, nrhs))
        B = rng.standard_normal((n, nrhs))
        Xd, Bd = (torch.from_numpy(a).to(card) for a in (X, B))
        got = ck.csr_matvec(ref._ell_col, ref._ell_val64, Xd)
        want = ck.csr_matvec_plain(ref._ell_col, ref._ell_val64, Xd)
        assert torch.equal(got, want)
        assert np.array_equal(got.cpu().numpy(), A @ X)
        assert np.array_equal((Bd - got).cpu().numpy(), B - A @ X)


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
    real = mf_torch.upcast

    def counted(hi, rhs, *ts):
        calls.append((rhs.device.type, rhs.dtype, hi))
        return real(hi, rhs, *ts)
    monkeypatch.setattr(mf_torch, "upcast", counted)
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


@pytest.mark.cuda
def test_f32_unrefined_solves_repeat_bitwise(card, problem):
    """The border subtraction adds in waves of distinct destinations, so
    unrefined f32 solves on the same factors repeat bit for bit on the
    card (with index_add_'s atomics over shared border cells they differed
    by ~1e-4 relative)."""
    matrix, maps = problem
    fac = MultifrontalFactorization(matrix, maps=maps, device=card,
                                    precision="f32")
    B = np.random.default_rng(12).standard_normal((matrix.flat_len, 4))
    first = fac.solve(B, refine=False)
    for _ in range(3):
        assert np.array_equal(fac.solve(B, refine=False), first)


@pytest.mark.cuda
def test_offload_on_card_equals_resident(card, problem, tmp_path):
    """Round checkpoints written from the card and streamed back equal the
    resident factors (torch.equal); a resume from the directory assembles
    no round."""
    matrix, maps = problem
    res = MultifrontalFactorization(matrix, maps=maps, device=card)
    eng = res.engine
    off = mf_torch.TorchMultifrontal(res.sym, res._fac_matrix, card,
                                     checkpoint_dir=str(tmp_path))
    assert off._offload
    for a, b in zip(off.factors, eng.factors, strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    before = ck.LAUNCHES["ell_assemble_f64"]
    again = mf_torch.TorchMultifrontal(res.sym, res._fac_matrix, card,
                                       checkpoint_dir=str(tmp_path))
    assert ck.LAUNCHES["ell_assemble_f64"] == before
    for a, b in zip(again.factors, eng.factors, strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _assembly(d, **kw):
    """An assembly of the port's stage 1 at 14x10x5 (seed 9, as
    tests/test_device_update.py), with its canonical matrix and maps."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (gen_ind_maps,
                                                               load_grid)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        assemble_jacobian)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.assemble import to_csr
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
        FileFieldSource)
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=14, jmt=10, km=5, seed=9)
    grid = load_grid(circ)
    maps = gen_ind_maps(np.asarray(grid.KMT), grid.km)
    asm = assemble_jacobian(grid, AssemblyOptions(circ_fname=circ, **kw),
                            FileFieldSource(circ), None, maps)
    nzval, colind, rowptr = to_csr(asm)
    return asm, SparseMatrix(nzval=nzval, colind=colind, rowptr=rowptr,
                             coupled_tracer_cnt=1), maps


@pytest.mark.cuda
@pytest.mark.parametrize("vmix", ["file", "matrix_file"])
def test_update_on_card_equals_cpu(card, tmp_path, vmix):
    """The value update (gather and left fold) on the card, bit for bit
    with the CPU tensor path and the host numpy path, on bench's options
    (W = 1) and on upwind3 + matrix_file vmix (W > 1)."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.device_update import (
        build_update_plan)
    asm, matrix, _ = _assembly(tmp_path, adv_type="upwind3",
                               hmix_type="isop_file", vmix_type=vmix)
    plan = build_update_plan(asm, matrix)
    assert (plan.ell_src.shape[1] > 1) == (vmix == "matrix_file")
    s = plan.stack_fields(asm) * (1.0 + 1e-3 * np.random.default_rng(
        42).standard_normal(plan.total))
    host = plan.update(s)
    cpu = plan.update(torch.from_numpy(s))
    dev = plan.update(torch.from_numpy(s).to(card))
    assert dev.device.type == "cuda"
    assert torch.equal(dev.cpu(), cpu)
    np.testing.assert_array_equal(cpu.numpy(), host)


@pytest.mark.cuda
def test_stencil_matvec_on_card_matches_csr(card, tmp_path):
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        StencilOperator)
    asm, matrix, maps = _assembly(tmp_path, adv_type="upwind3",
                                  hmix_type="isop_file",
                                  vmix_type="matrix_file")
    op = StencilOperator.from_assembly(asm)
    assert op.device.type == "cuda"
    x = np.random.default_rng(7).standard_normal(matrix.flat_len)
    y = op.matvec_factory(maps)(torch.from_numpy(x).to(card)).cpu().numpy()
    want = matrix.to_scipy() @ x
    np.testing.assert_allclose(y, want, rtol=1e-12,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.cuda
def test_bench_main_on_card(card, tmp_path, capsys):
    """The factor-and-solve bench at tiny on the card: bench's JSON line,
    residuals within the contract, K1 and K3 launched, the card's peak."""
    import json
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import bench
    before = dict(ck.LAUNCHES)
    assert bench.main(["--size", "tiny", "--cache", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["residual"] <= 1e-10 and out["baseline_residual"] <= 1e-10
    assert out["device"] == torch.cuda.get_device_name(card)
    assert out["peak_mem_gb"] > 0 and out["escalated"] is None
    assert out["value"] == out["factor_s"] + out["solve_s"]
    for k in ("pivoted_panel_f64", "ell_assemble_f64"):
        assert ck.LAUNCHES[k] > before[k], k


@pytest.mark.cuda
def test_nccl_world_of_one_sharded_apply(card, tmp_path):
    """An NCCL group of one rank: an all-reduce runs on the card, and the
    one-band sharded apply of make_mesh(1) is ``apply`` bit for bit."""
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        StencilOperator, init_process_group, make_mesh)
    asm, matrix, maps = _assembly(tmp_path, adv_type="upwind3",
                                  hmix_type="isop_file", vmix_type="file")
    dev = init_process_group("cuda", 0, 1, str(tmp_path / "store"))
    try:
        assert dist.get_backend() == "nccl" and dev.type == "cuda"
        t = torch.ones(3, device=dev)
        dist.all_reduce(t)
        assert torch.equal(t.cpu(), torch.ones(3))
        op = StencilOperator.from_assembly(asm, dev)
        mesh = make_mesh(1)
        apply_fn, layout, pad_field, unpad_field = op.sharded_apply_factory(
            mesh)
        x = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (op.nt,) + op.shape)).to(dev)
        y = unpad_field(layout.gather(apply_fn(layout.scatter(
            pad_field(x)))))
        assert y.device.type == "cuda"
        assert torch.equal(y, op.apply(x))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_engine_nccl_world_of_one(card, problem, tmp_path):
    """The mesh engine as an NCCL group of one rank (make_mesh(1,
    ("front",))): every round, the rounds of at most two fronts included,
    goes through K1 and K3 on the card, the perms are those of the same
    mesh engine on the CPU (the plain versions), and the refined solve
    meets the contract and agrees with the CPU's."""
    import torch.distributed as dist
    from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import (
        init_process_group, make_mesh)
    matrix, maps = problem
    dev = init_process_group("cuda", 0, 1, str(tmp_path / "store"))
    try:
        assert dist.get_backend() == "nccl"
        before = dict(ck.LAUNCHES)
        gpu = MultifrontalFactorization(matrix, maps=maps, device=dev,
                                        mesh=make_mesh(1, ("front",)))
        eng = gpu.engine
        panels = sum(-(-p.P // mf_torch.PANEL) for p in eng.plans)
        assert any(p.B <= 2 for p in eng.plans)
        assert ck.LAUNCHES["pivoted_panel_f64"] - before[
            "pivoted_panel_f64"] == panels
        assert ck.LAUNCHES["ell_assemble_f64"] - before[
            "ell_assemble_f64"] == len(eng.plans)
        cpu = MultifrontalFactorization(matrix, maps=maps, sym=gpu.sym,
                                        device="cpu",
                                        mesh=make_mesh(1, ("front",)))
        for g, c in zip(eng.factors, cpu.engine.factors):
            assert np.array_equal(g[3].cpu().numpy(), c[3].numpy())
        B = np.random.default_rng(4).standard_normal((matrix.flat_len, 4))
        X = gpu.solve(B)
        A = matrix.to_scipy()
        res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
        assert res.max() < 1e-11, res
        np.testing.assert_allclose(X, cpu.solve(B), rtol=1e-9, atol=1e-12)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_masked_substitution_on_card_matches_plain(card):
    """The masked block substitutions (a row-sharded round's, here with
    one rank holding every column, so the sum over ranks is the product
    itself) on the card against the plain block substitutions of the same
    packed block, and against themselves on the CPU."""
    rng = np.random.default_rng(3)
    B, P, nrhs, bs = 2, 512, 4, mf_torch.PANEL
    # a packed LU whose unit-lower and upper triangles are well conditioned
    A = torch.from_numpy(rng.standard_normal((B, P, P)) / np.sqrt(P)
                         + 4 * np.eye(P))
    rhs = torch.from_numpy(rng.standard_normal((B, P, nrhs)))
    for masked, plain in ((mf_torch.block_lower_apply_masked,
                           mf_torch.block_lower_apply),
                          (mf_torch.block_upper_apply_masked,
                           mf_torch.block_upper_apply)):
        out = {}
        for dev in (card, torch.device("cpu")):
            K = mf_torch.pack_diag_inv(A.to(dev), bs)
            KD = mf_torch.extract_diag_blocks(K, bs)
            r = rhs.to(dev)
            out[dev.type] = masked(K, KD, r, 0, lambda t: t)
            want = plain(K, r, bs)
            assert out[dev.type].device.type == dev.type
            torch.testing.assert_close(out[dev.type], want, rtol=1e-12,
                                       atol=1e-12)
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_stage_timer_moves_no_launch_on_card(card, problem):
    """drivers.profile on the card: a refactor launches the same kernels
    with the stage timer on as off, the per-round rows are the plans'
    rounds, and the stages plus the walk add up to the synchronized
    wall."""
    import math
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.profile import (
        STAGE_NAMES, profile_refactor)
    matrix, maps = problem
    fac = MultifrontalFactorization(matrix, maps=maps, device=card)
    before = dict(ck.LAUNCHES)
    fac.refactor()
    off = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    before = dict(ck.LAUNCHES)
    prof = profile_refactor(fac, card)      # a warm and a timed refactor
    both = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    assert both == {k: 2 * v for k, v in off.items()}
    plans = fac.engine.plans
    assert off["ell_assemble_f64"] == len(plans)
    assert off["pivoted_panel_f64"] == prof["calls"]["panel"] == sum(
        math.ceil(p.P / 128) for p in plans if p.B > 2)
    assert [(r["B"], r["P"], r["N"], r["children"]) for r in prof["rows"]] \
        == [(p.B, p.P, p.N, len(p.child_groups)) for p in plans]
    for r in prof["rows"]:
        assert all(r[k] >= 0 for k in STAGE_NAMES + ("walk",))
    assert abs(sum(prof["totals"].values()) + prof["walk_ms"]
               - prof["wall_ms"]) <= 0.01 * prof["wall_ms"]


def _card_engine(card, problem, matrix=None):
    """A float64 engine on the card over the facade's equilibrated matrix
    (``matrix`` replaces its values), and that facade."""
    matrix0, maps = problem
    fac = MultifrontalFactorization(matrix0, maps=maps, device=card)
    eng = mf_torch.TorchMultifrontal(fac.sym, matrix or fac._fac_matrix,
                                     card)
    return eng, fac


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 4])
def test_sweep_graph_replays_the_eager_sweep_bitwise(card, problem, nrhs):
    """The solve sweep as one CUDA graph: the first sweep at a width is
    eager, the second captures and replays, every later one replays; all
    give the eager sweep's bits, and the counters say so."""
    eng, _ = _card_engine(card, problem)
    assert eng._graphable()
    B = np.random.default_rng(21).standard_normal((eng.flat_len, nrhs))
    got = [eng.solve(B) for _ in range(4)]
    assert all(np.array_equal(x, got[0]) for x in got[1:])
    assert eng.sweep_counts == dict(eager=1, captured=1, replayed=2)
    assert list(eng._graphs) == [(nrhs, torch.float64)]
    # the eager body once more, on the same factors
    W = torch.zeros((eng.flat_len + 1, nrhs), dtype=torch.float64,
                    device=card)
    W[:eng.flat_len] = torch.from_numpy(B).to(card)
    eager = eng._sweep(W)[:eng.flat_len].cpu().numpy()
    assert np.array_equal(eager, got[0])


@pytest.mark.cuda
def test_sweep_graphs_by_width_and_after_a_refactor(card, problem):
    """1 and 4 right-hand sides get a graph each; a refactor with new
    values drops both, and the next solves equal a fresh engine's eager
    solve on those values (a graph kept across the refactor would read the
    freed factors, or the new ones at the old addresses by chance)."""
    import dataclasses
    eng, fac = _card_engine(card, problem)
    B = np.random.default_rng(22).standard_normal((eng.flat_len, 4))
    for nrhs in (1, 4, 1, 4, 1, 4):
        eng.solve(B[:, :nrhs])
    assert eng.sweep_counts == dict(eager=2, captured=2, replayed=2)
    gen = eng.generation
    noise = np.random.default_rng(23).standard_normal(
        len(fac._fac_matrix.nzval))
    new = dataclasses.replace(
        fac._fac_matrix, nzval=fac._fac_matrix.nzval * (1 + 1e-3 * noise))
    eng.refactor(new)
    assert eng._graphs == {} and eng.generation > gen
    fresh = mf_torch.TorchMultifrontal(fac.sym, new, card)
    for nrhs in (1, 4):
        want = fresh.solve(B[:, :nrhs])
        for _ in range(3):
            assert np.array_equal(eng.solve(B[:, :nrhs]), want)
    assert fresh.sweep_counts == dict(eager=2, captured=0, replayed=0)
    assert eng.sweep_counts == dict(eager=4, captured=4, replayed=4)


@pytest.mark.cuda
def test_profiler_records_the_replayed_kernels(card, problem):
    """A profiler started after the capture sees every kernel of a replay:
    one sweep on the replay route shows as many device operations as the
    eager body launches, plus the two copies, while the host launches one
    graph."""
    eng, _ = _card_engine(card, problem)
    W = torch.zeros((eng.flat_len + 1, 1), dtype=torch.float64, device=card)
    W[:eng.flat_len] = 1.0
    for _ in range(2):
        eng.solve_workspace(W.clone())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ops = {}
    for route, fn in (("eager", eng._sweep), ("replay", eng.solve_workspace)):
        x = W.clone()
        torch.cuda.synchronize(card)
        with torch.profiler.profile(activities=acts) as prof:
            fn(x)
            torch.cuda.synchronize(card)
        ev = prof.profiler.kineto_results.events()
        ops[route] = sum(1 for e in ev if e.device_type()
                         == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation())
        ops[route + "_graph_launches"] = sum(
            1 for e in ev if "GraphLaunch" in e.name())
    assert eng.sweep_counts["replayed"] == 1
    assert ops["eager_graph_launches"] == 0
    assert ops["replay_graph_launches"] == 1
    assert ops["replay"] == ops["eager"] + 2, ops
