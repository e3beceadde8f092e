"""The port's host engine (solver/mf_numpy.py) and the facade's
``impl="numpy"`` against the JAX package's, on the CPU.

The port's NumpyMultifrontal is a copy of the JAX package's: on the same
equilibrated matrix and symbolic plan (the 20x16x6 fixture of
tests/test_mf_jax.py) every front's factors and the solve are equal bit
for bit. Through the facade, ``impl="numpy"`` refines on the host (plain
refinement, then scipy GMRES-IR) to the 1e-10 contract.
"""

import warnings

import numpy as np
import pytest

from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import (
    load_ind_maps as ref_load_maps)
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
    read_matrix_file as ref_read_matrix)
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf as ref_mf
from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_numpy as ref_np
from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
    symbolic_from_matrix as ref_symbolic)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (AssemblyOptions,
                                                           PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import api, mf, mf_numpy
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
    symbolic_from_matrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import make_circ_file


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The 20x16x6 fixture of tests/test_mf_jax.py, read by each package."""
    d = tmp_path_factory.mktemp("torch_mf_numpy")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    return ((read_matrix_file(mat), load_ind_maps(mat)),
            (ref_read_matrix(mat), ref_load_maps(mat)))


@pytest.fixture(scope="module")
def engines(fixture):
    (m_p, maps_p), (m_r, maps_r) = fixture
    s_p, _, _ = mf.equilibrate(m_p)
    s_r, _, _ = ref_mf.equilibrate(m_r)
    return (mf_numpy.NumpyMultifrontal(symbolic_from_matrix(maps_p, s_p), s_p),
            ref_np.NumpyMultifrontal(ref_symbolic(maps_r, s_r), s_r))


def test_factors_bitwise_equal_jax(engines):
    got, want = engines
    assert got.order == want.order
    assert list(got.factors) == list(want.factors)
    for nid, f in got.factors.items():
        g = want.factors[nid]
        assert f.p == g.p
        for name in ("lu11", "piv", "L21", "U12", "cells"):
            a, b = getattr(f, name), getattr(g, name)
            assert a.dtype == b.dtype and a.shape == b.shape, (nid, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{nid} {name}")


@pytest.mark.parametrize("nrhs", [0, 3])
def test_solve_bitwise_equal_jax(engines, nrhs):
    got, want = engines
    n = got.sym.flat_len
    b = np.random.default_rng(4).standard_normal((n, nrhs) if nrhs else n)
    x = got.solve(b)
    assert x.shape == b.shape
    np.testing.assert_array_equal(x, want.solve(b))


def test_facade_numpy_refined_solve(fixture):
    (matrix, maps), _ = fixture
    fac = api.factor(matrix, maps=maps, impl="numpy")
    assert fac.impl == "numpy" and fac.device is None
    assert isinstance(fac.engine, mf_numpy.NumpyMultifrontal)
    assert set(fac.timings) >= {"symbolic", "equilibrate", "factor"}
    B = np.random.default_rng(5).standard_normal((matrix.flat_len, 2))
    X = fac.solve(B)
    rel = (np.linalg.norm(matrix.to_scipy() @ X - B, axis=0)
           / np.linalg.norm(B, axis=0))
    assert rel.max() <= 1e-10
    x = fac.solve(B[:, 0])
    assert x.shape == (matrix.flat_len,)
    # new values on the same pattern: a refactor on the host
    m2 = type(matrix)(nzval=matrix.nzval * 1.5, colind=matrix.colind,
                      rowptr=matrix.rowptr,
                      coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    fac.refactor(m2)
    X2 = fac.solve(B)
    np.testing.assert_allclose(X2 * 1.5, X, rtol=1e-9, atol=1e-12)
    assert set(fac.timings) >= {"to_scipy", "rebind", "factor"}


def test_facade_numpy_matches_jax_numpy(fixture):
    """The same refined solve as the JAX facade's impl="numpy" (its host
    branch): the same engine, the same plain refinement steps."""
    (matrix, maps), (m_r, maps_r) = fixture
    B = np.random.default_rng(6).standard_normal((matrix.flat_len, 2))
    got = mf.MultifrontalFactorization(matrix, maps=maps, impl="numpy")
    want = ref_mf.MultifrontalFactorization(m_r, maps=maps_r, impl="numpy")
    np.testing.assert_array_equal(got.solve(B), want.solve(B))


def test_facade_numpy_validate_reads_front_factors(fixture):
    (matrix, maps), _ = fixture
    fac = mf.MultifrontalFactorization(matrix, maps=maps, impl="numpy")
    rep = fac.validate()
    want = sum(f.lu11.size + f.L21.size + f.U12.size
               for f in fac.engine.factors.values())
    assert rep == {"nonfinite_factor_entries": 0, "factor_entries": want}
    next(iter(fac.engine.factors.values())).lu11[0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        fac.validate()


def test_facade_numpy_checkpoint_warns(fixture, tmp_path):
    (matrix, maps), _ = fixture
    f = tmp_path / "factors.npz"
    with pytest.warns(RuntimeWarning, match="numeric_checkpoint"):
        mf.MultifrontalFactorization(matrix, maps=maps, impl="numpy",
                                     numeric_checkpoint=str(f))
    assert not f.exists()


def test_facade_rejects_unknown_impl(fixture):
    (matrix, maps), _ = fixture
    with pytest.raises(ValueError, match="impl"):
        mf.MultifrontalFactorization(matrix, maps=maps, impl="jax")


def test_facade_numpy_needs_no_card(fixture, monkeypatch):
    """The host engine never resolves a device: it runs where no card is,
    with the default device left at cuda."""
    (matrix, maps), _ = fixture
    monkeypatch.setattr(mf, "resolve_device", lambda d: pytest.fail(
        "the numpy engine resolved a device"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fac = mf.MultifrontalFactorization(matrix, maps=maps, impl="numpy")
    assert fac.device is None
