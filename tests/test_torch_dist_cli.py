"""The port's solve CLI in its distributed mode (-n, --rhs-devices) on
gloo ranks on the CPU, against the JAX package's CLI on its simulated
8-device mesh.

tests/test_dist_cli.py's fixture (20x16x5, seed 21, three tracers): the
JAX CLI solves one copy of the tracer file with n_devices=4 and
rhs_chunk=1; the port's ``main`` starts its own ranks (4 for ``-n 2``,
whose npcol defaults to nprow, and for ``-n 2,2 --rhs-devices 2``; 2 for
``-n 1,2``) and solves other copies. Every output meets the 1e-10
contract by an independent check (scipy's netcdf reader, scipy's SpMV),
keeps the land cells bit for bit and agrees with the JAX CLI's at rtol
1e-9. ``--factors`` written by one 2-rank run is loaded by a second,
which writes the same bits; a rank that fails ends the run with status 1.
"""

import os
import shutil

import numpy as np
import pytest
from scipy.io import netcdf_file

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.drivers.solve import run_solve
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (AssemblyOptions,
                                                    PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import (make_circ_file,
                                                         make_tracer_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import solve

VARS = ("IAGE_CUR", "PO4_CUR", "DIC_CUR")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fixture's files and the JAX CLI's n_devices=4 output."""
    d = tmp_path_factory.mktemp("torch_dcli")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=20, jmt=16, km=5, seed=21)
    tracer = str(d / "tracer.nc")
    make_tracer_file(tracer, 20, 16, 5, tracer_names=VARS, seed=21)
    mat = str(d / "matrix.nc")
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.2e-4)]))
    jax_out = str(d / "t_jax.nc")
    shutil.copy(tracer, jax_out)
    run_solve(mat, jax_out, ",".join(VARS), backend="multifrontal",
              n_devices=4, rhs_chunk=1)
    return d, mat, tracer, _read(jax_out)


def _read(path) -> dict:
    """Independent read (scipy's netcdf codec)."""
    with netcdf_file(path, "r", mmap=False) as f:
        return {v: np.array(f.variables[v][:], dtype=np.float64)
                for v in VARS}


def _solve(files, name, *flags, vars_=VARS):
    d, mat, tracer, _ = files
    out = str(d / f"t_{name}.nc")
    shutil.copy(tracer, out)
    rc = solve.main([*flags, "--device", "cpu", "-v", ",".join(vars_),
                     mat, out])
    return rc, out


def _check(files, out, vars_=VARS):
    """The contract, land bit for bit, the JAX CLI's output at 1e-9."""
    _, mat, tracer, want = files
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    A = matrix.to_scipy()
    before, got = _read(tracer), _read(out)
    i3 = maps.int3_to_ind
    wet = i3 >= 0
    for v in vars_:
        np.testing.assert_array_equal(got[v][~wet], before[v][~wet])
        np.testing.assert_allclose(got[v][wet], want[v][wet], rtol=1e-9,
                                   atol=1e-12)
        x = np.zeros(matrix.flat_len)
        b = np.zeros(matrix.flat_len)
        x[i3[wet]] = got[v][wet]
        b[i3[wet]] = before[v][wet]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-10, v


def test_run_solve_distributed_end_to_end(files):
    """``solve -n 2``: 4 gloo ranks, one RHS group at a time
    (--rhs-chunk 1: several read-solve-write cycles of the first rank)."""
    rc, out = _solve(files, "n2", "-n", "2", "--rhs-chunk", "1")
    assert rc == 0
    _check(files, out)


def test_rhs_devices_end_to_end(files):
    """``solve -n 2,2 --rhs-devices 2``: a 2 x rhs 2 mesh of 4 ranks; the
    first chunk of 2 RHS splits over the rhs axis, the last (1) does
    not."""
    rc, out = _solve(files, "rhs", "-n", "2,2", "--rhs-devices", "2",
                     "--rhs-chunk", "2")
    assert rc == 0
    _check(files, out)


def test_factors_checkpoint_under_mesh(files, capfd):
    """--factors with 2 ranks: the first run factors and writes the file
    (its first rank alone), the second loads it on both ranks, factors
    nothing and writes the same bits."""
    d = files[0]
    fck = str(d / "factors_mesh.npz")
    rc_a, ta = _solve(files, "fact_a", "-n", "1,2", "-D", "1", "--factors",
                      fck, vars_=VARS[:2])
    assert rc_a == 0 and os.path.exists(fck)
    capfd.readouterr()
    rc_b, tb = _solve(files, "fact_b", "-n", "1,2", "-D", "1", "--factors",
                      fck, vars_=VARS[:2])
    log = capfd.readouterr().out
    assert rc_b == 0
    assert log.count(f"numeric factors loaded from {fck}") == 2
    assert "rejected" not in log
    sa, sb = _read(ta), _read(tb)
    for v in VARS[:2]:
        np.testing.assert_array_equal(sb[v], sa[v])
    _check(files, tb, VARS[:2])


def test_failed_rank_exits_1(files, capfd):
    """A variable the tracer file lacks: the first rank raises while the
    other waits for its right-hand sides; the run ends with status 1 and
    the rank's error, and the file is left as it was."""
    rc, out = _solve(files, "bad", "-n", "1,2", vars_=("NOPE",))
    assert rc == 1
    assert "solve: " in capfd.readouterr().err
    before, got = _read(files[2]), _read(out)
    for v in VARS:
        np.testing.assert_array_equal(got[v], before[v])
