"""The port's kernels (plain PyTorch versions on the CPU) against the JAX
package's formulations, and the wrappers' routing rules.

On the CPU each wrapper runs its kernel's plain version; the CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py and
chip_smoke.py), where they are held bit for bit to these plain versions.
"""

from fractions import Fraction

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
from nk_ocn_tracer_jacobian_precond_tpu.solver.pallas_kernels import (
    pallas_ell_assemble, pallas_pivoted_panel, pallas_pivoted_panel_df64)
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.device import resolve_device
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import plan as tplan

T_ = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread per process keeps the many small torch ops of the plain kernel
    versions from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# K1: pivoted panel
# --------------------------------------------------------------------------

# the cases of tests/test_pallas_kernels.py::test_pallas_panel_matches_xla,
# with float64 data
PANEL_CASES = [(4, 256, 128, 128), (3, 128, 128, 0), (2, 512, 64, 0)]


@pytest.mark.parametrize("B,R,T,off", PANEL_CASES)
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_panel_plain_matches_xla_f64(B, R, T, off, tau):
    rng = np.random.default_rng(0)
    Pan = rng.standard_normal((B, R, T))
    # one dummy front (p = 0: unpivoted, so elements grow), partial, full
    p_arr = np.linspace(0, off + R, B).astype(np.int32)
    Px, piv_x = mf_jax._pivoted_panel(jnp.asarray(Pan), off,
                                      jnp.asarray(p_arr), tau)
    Pt, piv_t, _ = ck.pivoted_panel(T_(Pan), off, T_(p_arr), tau)
    assert np.array_equal(piv_t.numpy(), np.asarray(piv_x))
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Px), rtol=0,
                               atol=1e-13)


def test_panel_plain_matches_df64_kernel():
    """The data of test_df64_panel_pivots_match_f64_reference, through the
    df64 Pallas kernel in interpret mode: same pivots, values within the
    df64 kernel's own ~2^-48 bar."""
    rng = np.random.default_rng(4)
    B, R, T = 2, 128, 64
    A0 = rng.standard_normal((B, R, T)) * np.exp(
        rng.uniform(-2, 2, (B, R, T)))
    p_arr = np.array([R, 96], dtype=np.int32)
    hi = A0.astype(np.float32)
    lo = (A0 - hi.astype(np.float64)).astype(np.float32)
    oh, ol, piv_d = pallas_pivoted_panel_df64(
        jnp.asarray(hi), jnp.asarray(lo), 0, jnp.asarray(p_arr),
        tau=1e-8, interpret=True)
    Pd = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    Pt, piv_t, _ = ck.pivoted_panel(T_(A0), 0, T_(p_arr), 1e-8)
    assert np.array_equal(piv_t.numpy(), np.asarray(piv_d))
    np.testing.assert_allclose(Pt.numpy(), Pd, rtol=0, atol=1e-11)


@pytest.mark.parametrize("B,R,T,off", [(4, 256, 128, 128), (2, 128, 128, 0),
                                       (2, 512, 64, 0)])
def test_panel_plain_factors_correctly(B, R, T, off):
    """P A = L U to 1e-12 on O(1) data, every row eligible to pivot."""
    rng = np.random.default_rng(3)
    A0 = rng.standard_normal((B, R, T))
    p_arr = np.full(B, off + R, dtype=np.int32)
    Pt, piv, _ = ck.pivoted_panel(T_(A0), off, T_(p_arr), 0.0)
    Pp, piv = Pt.numpy(), piv.numpy()
    for b in range(B):
        A = A0[b].copy()
        for k in range(T):
            s = piv[b, k]
            A[[k, s]] = A[[s, k]]
        L = np.vstack([np.tril(Pp[b][:T], -1) + np.eye(T), Pp[b][T:]])
        U = np.triu(Pp[b][:T])
        np.testing.assert_allclose(L @ U, A, rtol=0, atol=1e-12)


@pytest.mark.parametrize("B,R,T,off", PANEL_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_panel_plain_perm_matches_jax_seq_to_perm(B, R, T, off, dtype):
    """The panel's third output, perm, is mf_jax._seq_to_perm of its piv
    (the composition the engine used to build on the host side)."""
    rng = np.random.default_rng(0)
    Pan = rng.standard_normal((B, R, T)).astype(dtype)
    p_arr = np.linspace(0, off + R, B).astype(np.int32)
    _, piv, perm = ck.pivoted_panel(T_(Pan), off, T_(p_arr), 0.05)
    want = np.asarray(mf_jax._seq_to_perm(jnp.asarray(piv.numpy()), R))
    assert perm.dtype == torch.int64 and perm.shape == (B, R)
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(ck.seq_to_perm(piv, R).numpy(), want)
    # perm moves the input's rows where the factored panel has them
    assert not np.array_equal(perm.numpy(), np.tile(np.arange(R), (B, 1)))


def test_engine_takes_the_kernels_perm():
    """partial_factor no longer composes the swaps itself."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
    assert not hasattr(mf_torch, "seq_to_perm")


# every (B, R) of the gx3 plan's kernel rounds (T = 128): rounds (B, P)
# (256, 512), (128, 256), (256, 128), (128, 256), (64, 512), (32, 512),
# (16, 640), (8, 512), (4, 768), one panel per 128 columns
GX3_ROUNDS = [(256, 512), (128, 256), (256, 128), (64, 512), (32, 512),
              (16, 640), (8, 512), (4, 768)]
GX3_PANELS = sorted({(B, P - off) for B, P in GX3_ROUNDS
                     for off in range(0, P, 128)})


def _valid_config(B, R, T, itemsize):
    C, nb = ck.panel_launch_config(B, R, T, itemsize)
    rows = -(-R // C)
    assert 1 <= C <= ck.PANEL_MAX_CLUSTER and 1 <= nb <= T
    assert ck.panel_smem_bytes(rows, nb, itemsize) <= ck.SMEM_BLOCK
    return C, nb


@pytest.mark.parametrize("B,R", GX3_PANELS)
@pytest.mark.parametrize("itemsize", [8, 4])
def test_panel_launch_config_gx3(B, R, itemsize):
    """Every gx3 panel stays whole in its cluster's shared memory; few
    fronts of tall panels spread over the largest cluster, many fronts of
    short panels take one CTA each (no cluster barrier)."""
    C, nb = _valid_config(B, R, 128, itemsize)
    assert nb == 128
    if B <= 8 and R >= 256:
        assert C == ck.PANEL_MAX_CLUSTER
    if R == 128 and B >= 64:
        assert C == 1


# clusters an H100 80GB HBM3 keeps active at once for the (256, 512, 128)
# f64 panel, C = 1..8 (cudaOccupancyMaxActiveClusters; 0: does not fit)
H100_ACTIVE_F64_R512 = [0, 0, 39, 30, 47, 39, 32, 45]


def test_panel_launch_config_largest_gx3_shape():
    """(256, 512, 128) at f64: 512 rows do not fit one or two CTAs; with
    the card's own active-cluster counts the rule takes 8 CTAs, the
    fastest size in scripts/panel_sweep.py's run on the card."""
    act = (lambda C, rows, nb, itemsize: H100_ACTIVE_F64_R512[C - 1])
    assert ck.panel_launch_config(256, 512, 128, 8, act) == (8, 128)
    assert ck.panel_smem_bytes(64, 128, 8) <= ck.SMEM_BLOCK
    assert ck.estimate_active_clusters(1, 512, 128, 8) == 0


def test_panel_launch_config_follows_active_clusters():
    """A cluster size the card cannot keep active is never taken, and with
    clusters scarce one CTA per front wins where it fits."""
    only_one = (lambda C, rows, nb, itemsize: 132 if C == 1 else 0)
    assert ck.panel_launch_config(4, 256, 128, 4, only_one) == (1, 128)
    no_one = (lambda C, rows, nb, itemsize:
              0 if C == 1 else ck.estimate_active_clusters(C, rows, nb,
                                                           itemsize))
    assert ck.panel_launch_config(256, 128, 128, 4, no_one)[0] > 1


@pytest.mark.parametrize("R", [1664, 2048, 4096, 7680, 8192, 13824])
@pytest.mark.parametrize("itemsize", [8, 4])
def test_panel_launch_config_tall(R, itemsize):
    """Tall panels walk column slabs on the largest cluster; the slab is
    the widest multiple of 8 that fits. 7680 is the tallest panel of the
    upwind3 gx3deep plan (the mesh engine's tree-top round (1, 7680,
    13824)), 13,824 that plan's widest front as one panel."""
    C, nb = _valid_config(4, R, 128, itemsize)
    rows = -(-R // C)
    if ck.panel_smem_bytes(rows, 128, itemsize) <= ck.SMEM_BLOCK:
        assert nb == 128
    else:
        assert C == ck.PANEL_MAX_CLUSTER and nb % 8 == 0 and nb < 128
        assert ck.panel_smem_bytes(rows, nb + 8, itemsize) > ck.SMEM_BLOCK
    if R >= 4096:
        assert nb < 128
    if (R, itemsize) in ((7680, 8), (8192, 8), (13824, 4)):
        assert (C, nb) == (8, 24)
    if (R, itemsize) == (13824, 8):
        assert (C, nb) == (8, 8)


def test_panel_launch_config_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        ck.panel_launch_config(2, 40000, 128, 8)
    with pytest.raises(ValueError, match="T <= 128"):
        ck.panel_launch_config(2, 256, 256, 8)
    assert ck.panel_launch_config(1, 8, 8, 8) == (1, 8)


def test_fma_plain_rounds_once():
    """fma_plain(a, b, c) is a * b + c correctly rounded (checked against
    exact rational arithmetic), across magnitudes and cancellation."""
    rng = np.random.default_rng(11)
    n = 3000
    a = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    b = rng.standard_normal(n)
    c = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    c[:500] = -a[:500] * b[:500]          # near-total cancellation
    got = ck.fma_plain(T_(a), T_(b), T_(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# K2: pivoted panel at f32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,R,T,off", PANEL_CASES)
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_panel_plain_matches_xla_f32(B, R, T, off, tau):
    """The f32 data of test_pallas_panel_matches_xla: bit for bit against
    mf_jax._pivoted_panel at f32 and against the Pallas kernel K2 in
    interpret mode, pivots equal. XLA:CPU contracts the reference's update
    into an FMA at f32 too (test_xla_update_is_fused_f32), so the plain
    version rounds it once."""
    rng = np.random.default_rng(0)
    Pan = rng.standard_normal((B, R, T)).astype(np.float32)
    p_arr = np.linspace(0, off + R, B).astype(np.int32)
    Px, piv_x = mf_jax._pivoted_panel(jnp.asarray(Pan), off,
                                      jnp.asarray(p_arr), tau)
    Pp, piv_p = pallas_pivoted_panel(jnp.asarray(Pan), off,
                                     jnp.asarray(p_arr), tau, interpret=True)
    Pt, piv_t, _ = ck.pivoted_panel(T_(Pan), off, T_(p_arr), tau)
    assert Pt.dtype == torch.float32
    for Pw, piv_w in ((Px, piv_x), (Pp, piv_p)):
        assert np.array_equal(piv_t.numpy(), np.asarray(piv_w))
        assert np.array_equal(Pt.numpy(), np.asarray(Pw))


def test_xla_update_is_fused_f32():
    """The answer the f32 plain version rests on: with the update rounded
    twice (a * b, then the sum) it leaves the JAX reference on the
    growing p = 0 front, so XLA:CPU does fuse it at f32."""
    rng = np.random.default_rng(0)
    B, R, T, off = PANEL_CASES[1]
    Pan = rng.standard_normal((B, R, T)).astype(np.float32)
    p_arr = np.linspace(0, off + R, B).astype(np.int32)
    Px, _ = mf_jax._pivoted_panel(jnp.asarray(Pan), off, jnp.asarray(p_arr),
                                  0.0)
    mp = pytest.MonkeyPatch()
    mp.setattr(ck, "fma_plain", lambda a, b, c: a * b + c)
    try:
        Pu, _, _ = ck.pivoted_panel_plain(T_(Pan), off, T_(p_arr), 0.0)
    finally:
        mp.undo()
    assert not np.array_equal(Pu.numpy(), np.asarray(Px))


@pytest.mark.parametrize("B,R,T,off", [(4, 256, 128, 128), (2, 128, 128, 0),
                                       (2, 512, 64, 0)])
def test_panel_plain_factors_correctly_f32(B, R, T, off):
    """P A = L U at f32, every row eligible. The bound is the one of
    test_pallas_panel_factors_correctly: float32 elimination of a random
    panel leaves ~1e-4 absolute error on O(10) entries, 2e-3 is far below
    any pivoting mistake."""
    rng = np.random.default_rng(3)
    A0 = rng.standard_normal((B, R, T)).astype(np.float32)
    p_arr = np.full(B, off + R, dtype=np.int32)
    Pt, piv, _ = ck.pivoted_panel(T_(A0), off, T_(p_arr), 0.0)
    Pp, piv = Pt.numpy().astype(np.float64), piv.numpy()
    for b in range(B):
        A = A0[b].astype(np.float64)
        for k in range(T):
            s = piv[b, k]
            A[[k, s]] = A[[s, k]]
        L = np.vstack([np.tril(Pp[b][:T], -1) + np.eye(T), Pp[b][T:]])
        U = np.triu(Pp[b][:T])
        np.testing.assert_allclose(L @ U, A, rtol=0, atol=2e-3)


def test_fma_plain_rounds_once_f32():
    """fma_plain at f32 is a * b + c correctly rounded to f32 (checked
    against exact rational arithmetic), including the case where rounding
    the exact f64 product-sum to nearest first lands on an f32 midpoint
    and a second rounding would go the wrong way."""
    rng = np.random.default_rng(12)
    n = 3000
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-10, 10, n)))
    b = rng.standard_normal(n)
    c = rng.standard_normal(n) * np.exp(rng.uniform(-10, 10, n))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    # exact a * b + c = 1 + 2^-23 + 2^-24 - 2^-60: just below a midpoint
    a[-1], b[-1], c[-1] = (2.0 ** -24 * (1 + 2.0 ** -18), 1 - 2.0 ** -18,
                           1 + 2.0 ** -23)
    got = ck.fma_plain(T_(a), T_(b), T_(c)).numpy()
    assert got.dtype == np.float32
    want = np.array([_to_f32(Fraction(float(x)) * Fraction(float(y))
                             + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[-1] != got[-1]


def _to_f32(q: Fraction) -> np.float32:
    """The rational q rounded to nearest float32, ties to even (by
    comparing the neighbours of a close candidate exactly)."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - q),
                                     int(np.array(x).view(np.int32)) & 1))


# --------------------------------------------------------------------------
# K3: ELL front assembly
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spill_plans(tmp_path_factory):
    """Round plans of the 20x16x6 fixture with the ELL width capped at 4,
    so rows spill (as tests/test_mf_jax.py::test_ell_spill_assembly_path)."""
    d = tmp_path_factory.mktemp("torch_kernels")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
    real_quantile = np.quantile
    mp = pytest.MonkeyPatch()
    mp.setattr(np, "quantile",
               lambda a, q, **kw: min(real_quantile(a, q, **kw), 4.0))
    try:
        plans = tplan.build_plan(sym, matrix)
    finally:
        mp.undo()
    nz = np.zeros(matrix.nnz + 1)
    nz[:-1] = matrix.nzval
    assert any((p.a_pos < p.N * p.N).any() for p in plans)
    return plans, nz


def _torch_args(p, nz, dtype=torch.float64):
    return (T_(nz).to(dtype), T_(p.a_col).long(), T_(p.a_csrc).long(),
            T_(p.a_pos).long(), T_(p.a_src).long(), T_(p.p_arr))


def test_ell_assemble_plain_matches_jax_scatter(spill_plans):
    """Every round, bit for bit against _assemble(impl="scatter")."""
    plans, nz = spill_plans
    for p in plans:
        spill = bool((p.a_pos < p.N * p.N).any())
        want = mf_jax._assemble(
            jnp.asarray(nz), jnp.asarray(p.a_col), jnp.asarray(p.a_csrc),
            jnp.asarray(p.a_pos), jnp.asarray(p.a_src), jnp.asarray(p.p_arr),
            N=p.N, P=p.P, spill=spill, impl="scatter")
        got = ck.ell_assemble(*_torch_args(p, nz), p.N, p.P, spill)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_ell_assemble_plain_matches_jax_scatter_f32(spill_plans):
    """Every round at f32, bit for bit against _assemble(impl="scatter")."""
    plans, nz = spill_plans
    nz32 = nz.astype(np.float32)
    for p in plans:
        spill = bool((p.a_pos < p.N * p.N).any())
        want = mf_jax._assemble(
            jnp.asarray(nz32), jnp.asarray(p.a_col), jnp.asarray(p.a_csrc),
            jnp.asarray(p.a_pos), jnp.asarray(p.a_src), jnp.asarray(p.p_arr),
            N=p.N, P=p.P, spill=spill, impl="scatter")
        got = ck.ell_assemble(*_torch_args(p, nz, torch.float32), p.N, p.P,
                              spill)
        assert got.dtype == torch.float32
        assert np.asarray(want).dtype == np.float32
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_ell_part_matches_pallas_f32(spill_plans):
    """The ELL store alone (no spill, no identity) at f32, bit for bit
    against the Pallas kernel in interpret mode."""
    plans, nz = spill_plans
    p = min(plans, key=lambda q: q.B * q.N * q.N)
    vals = nz.astype(np.float32)[p.a_csrc]
    want = pallas_ell_assemble(jnp.asarray(p.a_col), jnp.asarray(vals),
                               interpret=True)
    args = _torch_args(p, nz, torch.float32)
    got = ck.ell_assemble_plain(*args[:5], torch.zeros(p.B, dtype=torch.int32),
                                p.N, 0, spill=False)
    assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# routing and device rules
# --------------------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu_without_building():
    Pan = torch.randn(2, 8, 8, dtype=torch.float64)
    p_arr = torch.tensor([8, 4], dtype=torch.int32)
    before = dict(ck.LAUNCHES)
    ck.pivoted_panel(Pan, 0, p_arr, 0.0)
    assert ck.LAUNCHES == before
    assert ck._lib is None        # importing and running on CPU needs no nvcc


def test_wrappers_reject_other_devices_and_bad_inputs():
    p_arr = torch.tensor([8, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.pivoted_panel(torch.empty(2, 8, 8, dtype=torch.float64,
                                     device="meta"), 0,
                         p_arr.to("meta"), 0.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.pivoted_panel(torch.zeros(2, 8, 8, dtype=torch.float16), 0,
                         p_arr, 0.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.ell_assemble(torch.zeros(3, dtype=torch.bfloat16),
                        *(torch.zeros(2, 4, 1, dtype=torch.int64),) * 2,
                        *(torch.zeros(2, 1, dtype=torch.int64),) * 2,
                        p_arr, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ck.pivoted_panel(torch.zeros(2, 8, 16,
                                     dtype=torch.float64)[:, :, :8], 0,
                         p_arr, 0.0)
    with pytest.raises(ValueError, match="T <= 128"):
        ck.pivoted_panel(torch.zeros(2, 256, 256, dtype=torch.float64), 0,
                         p_arr, 0.0)


def test_csr_residual_takes_its_plain_version_and_rejects_bad_inputs():
    """On the CPU csr_matvec, the residual's product, runs its plain
    version without building or counting a launch; it takes float64
    (n, E) operands and a contiguous (n, nrhs) float64 x, and nothing
    else."""
    col = torch.tensor([[0, 1, 3], [2, 3, 3], [0, 1, 2]])
    val = torch.tensor([[2.0, -1.0, 0.0], [4.0, 0.0, 0.0],
                        [0.5, 0.25, 1.0]], dtype=torch.float64)
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.5, 8.0]],
                     dtype=torch.float64)
    before = dict(ck.LAUNCHES)
    y = ck.csr_matvec(col, val, x)
    assert ck.LAUNCHES == before and ck._lib is None
    assert torch.equal(y, torch.tensor([[-1.0, 5.0], [2.0, 32.0],
                                        [1.75, 8.75]], dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        ck.csr_matvec(col, val, x.float())
    with pytest.raises(TypeError, match="float64"):
        ck.csr_matvec(col, val.float(), x)
    with pytest.raises(ValueError, match="shape"):
        ck.csr_matvec(col, val, x[:2])
    with pytest.raises(ValueError, match="contiguous"):
        ck.csr_matvec(col, val, torch.zeros(2, 3, dtype=torch.float64).T)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.csr_matvec(col.to("meta"), val.to("meta"), x.to("meta"))


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
