"""The frozen stage 1 equals the port's gen_A byte for byte, and the
reference's inputs and residuals are what they say."""

import numpy as np
import pytest

from benchmark.reference import check, stage1

DIMS = dict(imt=24, jmt=20, km=8)


def config(adv_type: str, dims=DIMS) -> dict:
    return dict(grid=dims, circulation_seed=7,
                assembly=dict(adv_type=adv_type, hmix_type="isop_file",
                              vmix_type="file", sink_type="const",
                              sink_rate=1.21e-4, day_cnt=365.0))


def port_gen_a(tmp_path, adv_type: str, dims=DIMS):
    """The port's gen_A matrix file of the same options, read back."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import (
        run_gen_a)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        load_ind_maps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
        AssemblyOptions, PerTracerOptions)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import (
        make_circ_file)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata.transports import (
        derive_upwind3_transports)
    circ, mat = str(tmp_path / "circ.nc"), str(tmp_path / "matrix.nc")
    make_circ_file(circ, seed=7, **dims)
    if adv_type == "upwind3":
        derive_upwind3_transports(circ)
    opts = AssemblyOptions(
        circ_fname=circ, adv_type=adv_type, hmix_type="isop_file",
        vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.21e-4)])
    run_gen_a(mat, opts=opts)
    return read_matrix_file(mat), load_ind_maps(mat)


@pytest.mark.parametrize("adv_type", ["centered", "upwind3"])
@pytest.mark.parametrize("dims", [DIMS, dict(imt=20, jmt=16, km=6)])
def test_stage1_equals_the_ports_gen_a_byte_for_byte(tmp_path, adv_type,
                                                     dims):
    m, maps = port_gen_a(tmp_path, adv_type, dims)
    r = stage1.assemble(config(adv_type, dims))
    assert r["nzval"].tobytes() == m.nzval.astype(np.float64).tobytes()
    assert r["colind"].tobytes() == m.colind.astype(np.int64).tobytes()
    assert r["rowptr"].tobytes() == m.rowptr.astype(np.int64).tobytes()
    assert r["tracer_state_len"] == maps.tracer_state_len
    for k in ("int3_to_ind", "ind_to_i", "ind_to_j", "ind_to_k"):
        assert r[k].tobytes() == getattr(maps, k).astype(np.int64).tobytes()


def test_stage1_refuses_options_it_does_not_hold():
    c = config("centered")
    c["assembly"]["vmix_type"] = "matrix_file"
    with pytest.raises(ValueError):
        stage1.assemble(c)


def test_values_are_a_seeded_multiplicative_perturbation():
    nz0 = np.array([1.0, -2.0, 3e-5, -4e7, 0.5])
    a = check.Values(nz0, 2 ** 31 + 11, 1e-3)
    b = check.Values(nz0, 2 ** 31 + 11, 1e-3)
    assert np.array_equal(a(4), b(4))
    assert not np.array_equal(a(4), a(5))
    assert not np.array_equal(a(4), check.Values(nz0, 12, 1e-3)(4))
    rel = a(4) / nz0 - 1
    assert (np.sign(a(4)) == np.sign(nz0)).all()
    assert 0 < np.abs(rel).max() < 1e-2
    assert np.array_equal(check.Values(nz0, 3, 0.0)(1), nz0)


def test_residuals_in_long_double_agree_with_a_plain_product():
    rng = np.random.default_rng(0)
    n = 50
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    A += np.diag(n + rng.random(n))
    rowptr = np.concatenate([[0], np.cumsum((A != 0).sum(1))])
    colind = np.nonzero(A)[1]
    ref = check.Reference(A[A != 0], colind, rowptr, seed=1, scale=0.0)
    X = rng.standard_normal((n, 3))
    B = A @ X
    B[:, 1] += 1e-3 * rng.standard_normal(n)
    rel = ref.residuals(ref.values(0), [X], [B])[0]
    want = np.linalg.norm(B - A @ X, axis=0) / np.linalg.norm(B, axis=0)
    assert rel[0] < 1e-15 and rel[2] < 1e-15
    assert rel[1] == pytest.approx(want[1], rel=1e-12)
    X[3, 2] = np.nan
    assert ref.residuals(ref.values(0), [X], [B])[0][2] == np.inf


def test_residuals_keep_each_blocks_columns_in_place():
    rng = np.random.default_rng(1)
    n = 40
    A = np.diag(2.0 + rng.random(n)) + np.diag(rng.random(n - 1), 1)
    rowptr = np.concatenate([[0], np.cumsum((A != 0).sum(1))])
    ref = check.Reference(A[A != 0], np.nonzero(A)[1], rowptr, seed=1,
                          scale=0.0)
    Xs = [rng.standard_normal((n, k)) for k in (1, 4, 2)]
    Bs = [A @ X + 10.0 ** -(1 + i) * rng.standard_normal(X.shape)
          for i, X in enumerate(Xs)]
    got = ref.residuals(ref.values(0), Xs, Bs)
    assert [g.shape for g in got] == [(1,), (4,), (2,)]
    for X, B, g in zip(Xs, Bs, got):
        want = (np.linalg.norm(B - A @ X, axis=0)
                / np.linalg.norm(B, axis=0))
        np.testing.assert_allclose(g, want, rtol=1e-12)
