"""The diagonal step of the solve's block substitutions on the CPU: the
triangle kernel's plain version (cuda_kernels.tri_block_apply_plain)
against the library route it replaces, and the block substitutions'
choice of route (the kernel on a card at narrow widths, the library
route on the CPU and at wide ones).

The kernel itself runs only on a card (tests/test_torch_cuda.py), where it
is held bit for bit to the plain version.
"""

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(B, P, seed, dtype=torch.float64):
    """A packed pivot factor K (B, P, P) of a well-conditioned LU, at pack
    block min(P, 64), and the generator that drew it."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((B, P, P)) / np.sqrt(P)
                         + 4 * np.eye(P))
    return mf_torch.pack_diag_inv(A, min(P, 64)).to(dtype), rng


def _library(KD, t, lower):
    return t + torch.tril(KD, -1) @ t if lower else torch.triu(KD) @ t


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 2, 3, 17, 31, 64, 100])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_plain_matches_the_library_route(dtype, T, lower):
    """The plain version against t + tril(KD, -1) t / triu(KD) t on a
    strided diagonal block inside a larger K, with and without g. The two
    sum in different orders: 1e-13 relative (float64) or 2e-6 (float32)
    of the sum of the products' magnitudes, a few ulps of the longest
    row's accumulation (at most 100 terms here)."""
    K = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (3, 130, 130))).to(dtype)
    o = 130 - T - 5                   # a block off K's corner
    KD = K[:, o:o + T, o:o + T]
    rng = np.random.default_rng(7)
    rhs = torch.from_numpy(rng.standard_normal((3, T, 4))).to(dtype)
    g = torch.from_numpy(rng.standard_normal((3, T, 4))).to(dtype)
    tol = 1e-13 if dtype == torch.float64 else 2e-6
    for gg in (None, g):
        t = rhs if gg is None else rhs - gg
        got = ck.tri_block_apply_plain(KD, rhs, gg, lower)
        want = _library(KD, t, lower)
        mag = _library(KD.abs(), t.abs(), lower)
        assert got.dtype == dtype and got.shape == want.shape
        assert ((got - want).abs() <= tol * mag).all()


def test_plain_sums_in_the_kernels_order():
    """Row 5 of a T = 40 upper block (w = 32 lanes): lane l sums k = l and
    l + 32 when both lie in the row, then the lanes pairwise, 16 apart,
    8, 4, 2, 1; written out with Python floats."""
    rng = np.random.default_rng(3)
    KD = torch.from_numpy(rng.standard_normal((1, 40, 40)))
    t = torch.from_numpy(rng.standard_normal((1, 40, 1)))
    got = ck.tri_block_apply_plain(KD, t, None, lower=False)[0, 5, 0].item()
    kd, tt = KD[0, 5].tolist(), t[0, :, 0].tolist()
    lanes = []
    for lane in range(32):
        acc = 0.0
        for k in range(lane, 40, 32):
            if k >= 5:
                acc = acc + kd[k] * tt[k]
        lanes.append(acc)
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [a + b for a, b in zip(lanes[:h], lanes[h:])]
    assert got == lanes[0]
    assert ck.tri_group_width(1) == 1 and ck.tri_group_width(3) == 4
    assert ck.tri_group_width(32) == 32 and ck.tri_group_width(1024) == 32


def test_wrapper_writes_its_output_on_the_cpu_and_checks_inputs():
    """On the CPU the wrapper writes the plain version into a strided
    ``out`` without building or counting a launch, and rejects other
    dtypes, shapes and devices."""
    rng = np.random.default_rng(5)
    K = torch.from_numpy(rng.standard_normal((2, 12, 12)))
    rhs = torch.from_numpy(rng.standard_normal((2, 12, 3)))
    big = torch.zeros((2, 20, 3), dtype=torch.float64)
    before = dict(ck.LAUNCHES)
    out = ck.tri_block_apply(K[:, 4:10, 4:10], rhs[:, :6], big[:, 8:14],
                             rhs[:, 6:12].contiguous(), lower=True)
    assert ck.LAUNCHES == before and ck._lib is None
    assert out.data_ptr() == big[:, 8:14].data_ptr()
    assert torch.equal(big[:, 8:14], ck.tri_block_apply_plain(
        K[:, 4:10, 4:10], rhs[:, :6], rhs[:, 6:12], lower=True))
    assert not big[:, :8].any() and not big[:, 14:].any()
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.tri_block_apply(K.half(), rhs.half(), rhs.half())
    with pytest.raises(TypeError, match="float64"):
        ck.tri_block_apply(K.float(), rhs, torch.empty_like(rhs))
    with pytest.raises(ValueError, match="shape"):
        ck.tri_block_apply(K[:, :6, :6], rhs, torch.empty_like(rhs))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.tri_block_apply(K.to("meta"), rhs.to("meta"),
                           torch.empty_like(rhs, device="meta"))


def _old_lower(K, rhs, bs):
    """block_lower_apply as it was before the triangle kernel: a tril copy
    and a matrix product for every diagonal block, the blocks joined by
    torch.cat."""
    ys = []
    for o in range(0, rhs.shape[1], bs):
        T = min(bs, rhs.shape[1] - o)
        t = rhs[:, o:o + T]
        if o:
            t = t - K[:, o:o + T, :o] @ torch.cat(ys, dim=1)
        ys.append(t + torch.tril(K[:, o:o + T, o:o + T], -1) @ t)
    return torch.cat(ys, dim=1)


def _old_upper(K, rhs, bs):
    xs = []
    P = rhs.shape[1]
    for o in reversed(range(0, P, bs)):
        T = min(bs, P - o)
        t = rhs[:, o:o + T]
        if xs:
            t = t - K[:, o:o + T, o + T:P] @ torch.cat(xs, dim=1)
        xs.insert(0, torch.triu(K[:, o:o + T, o:o + T]) @ t)
    return torch.cat(xs, dim=1)


@pytest.mark.parametrize("nrhs", [mf_torch.TRI_KERNEL_MAX_RHS + 1, 40])
def test_wide_right_hand_sides_keep_the_library_route(nrhs):
    """Above TRI_KERNEL_MAX_RHS columns (the factor's U12 = L11^-1 P A12,
    M columns) the block substitutions give the library route's bits, as
    before the kernel, launching nothing."""
    K, rng = _packed(3, 150, 11)
    rhs = torch.from_numpy(rng.standard_normal((3, 150, nrhs)))
    before = dict(ck.LAUNCHES)
    assert torch.equal(mf_torch.block_lower_apply(K, rhs, 64),
                       _old_lower(K, rhs, 64))
    assert torch.equal(mf_torch.block_upper_apply(K, rhs, 64),
                       _old_upper(K, rhs, 64))
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("nrhs", [1, 4, mf_torch.TRI_KERNEL_MAX_RHS])
def test_cpu_tensors_keep_the_library_route(nrhs):
    """On the CPU every width keeps the library route (the plain version,
    an emulation of the kernel's sum order, is the slower one there): the
    substitutions give the route's bits as before the kernel, and
    kernel_step says no."""
    K, rng = _packed(3, 150, 14)
    rhs = torch.from_numpy(rng.standard_normal((3, 150, nrhs)))
    assert not mf_torch.kernel_step(rhs)
    assert torch.equal(mf_torch.block_lower_apply(K, rhs, 64),
                       _old_lower(K, rhs, 64))
    assert torch.equal(mf_torch.block_upper_apply(K, rhs, 64),
                       _old_upper(K, rhs, 64))


def test_pack_diag_inv_writes_row_major_factors():
    """pack_diag_inv writes K row-major whatever its input's layout: the
    library LU (torch.linalg.lu_factor, column-major, as the tree-top
    rounds factor) packs to a contiguous K with the same values as a
    row-major copy of it packs to."""
    rng = np.random.default_rng(15)
    A = torch.from_numpy(rng.standard_normal((2, 96, 96)) / 10
                         + 4 * np.eye(96))
    lu, _ = torch.linalg.lu_factor(A)
    assert not lu.is_contiguous()
    K = mf_torch.pack_diag_inv(lu, 64)
    assert K.is_contiguous()
    assert torch.equal(K, mf_torch.pack_diag_inv(lu.contiguous(), 64))


@pytest.mark.parametrize("nrhs", [1, 4, mf_torch.TRI_KERNEL_MAX_RHS])
def test_narrow_right_hand_sides_take_the_kernel(nrhs, monkeypatch):
    """At most TRI_KERNEL_MAX_RHS columns on the card's route (the width
    rule of kernel_step without its device test): every diagonal block
    (150 = 64 + 64 + 22, the ragged last block included) goes through
    cuda_kernels.tri_block_apply, and the substitutions agree with the
    library route to rounding (1e-12 relative to the largest entry)."""
    K, rng = _packed(3, 150, 12)
    rhs = torch.from_numpy(rng.standard_normal((3, 150, nrhs)))
    monkeypatch.setattr(mf_torch, "kernel_step", lambda r: r.shape[-1]
                        <= mf_torch.TRI_KERNEL_MAX_RHS)
    calls = []
    real = ck.tri_block_apply

    def counted(KD, r, out, g=None, lower=True):
        calls.append((KD.shape[1], lower, g is None))
        return real(KD, r, out, g, lower)
    monkeypatch.setattr(ck, "tri_block_apply", counted)
    for fn, old, lower in ((mf_torch.block_lower_apply, _old_lower, True),
                           (mf_torch.block_upper_apply, _old_upper, False)):
        calls.clear()
        got, want = fn(K, rhs, 64), old(K, rhs, 64)
        assert sorted(calls) == sorted([(64, lower, lower),
                                        (64, lower, False),
                                        (22, lower, not lower)])
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-12 * scale


def test_masked_substitutions_take_the_same_diagonal_step(monkeypatch):
    """The masked forms (a row-sharded round's, here one rank holding every
    column) call the same diagonal step on their diagonal-block stack and
    give the plain block substitutions' bits."""
    K, rng = _packed(2, 256, 13)
    KD = mf_torch.extract_diag_blocks(K, 128)
    rhs = torch.from_numpy(rng.standard_normal((2, 256, 3)))
    steps = []
    real = mf_torch.diag_step

    def counted(*a, **kw):
        steps.append(kw["lower"])
        return real(*a, **kw)
    monkeypatch.setattr(mf_torch, "diag_step", counted)
    for masked, plain, lower in (
            (mf_torch.block_lower_apply_masked, mf_torch.block_lower_apply,
             True),
            (mf_torch.block_upper_apply_masked, mf_torch.block_upper_apply,
             False)):
        steps.clear()
        got = masked(K, KD, rhs, 0, lambda t: t)
        assert steps == [lower, lower]
        want = plain(K, rhs, 128)
        torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)
