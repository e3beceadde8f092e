"""The torch package's solve CLI against the JAX package's, on the CPU.

The workflow recipe (24x20x6, two tracers): gen_A writes the matrix, each
driver solves a copy of the same tracer file in place. The outputs must
agree, keep land cells bit-identical, and meet the 1e-10 residual
contract; ``--factors`` writes, then loads the factors, ``--memplan``
prints the JAX CLI's lines, and -n beyond the cards there are, or an
rhs axis that does not divide the rank count, exits with status 1 (the
distributed runs themselves are tests/test_torch_dist_cli.py's).
"""

import shutil

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from nk_ocn_tracer_jacobian_precond_tpu.drivers import gen_a
from nk_ocn_tracer_jacobian_precond_tpu.drivers import solve as jax_solve
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.testdata import (make_circ_file,
                                                         make_tracer_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import solve
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import cuda_kernels as ck
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)

VARS = ("IAGE_CUR", "PO4_CUR")


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
def workflow(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=24, jmt=20, km=6, seed=3)
    make_tracer_file(str(d / "tracer.nc"), 24, 20, 6, tracer_names=VARS,
                     seed=3)
    opts = d / "opts.txt"
    opts.write_text(f"circ_fname {circ}\nadv_type centered\n"
                    "hmix_type isop_file\nvmix_type file\n"
                    "sink_type const 1.21e-4\n")
    mat = str(d / "matrix.nc")
    assert gen_a.main(["-o", str(opts), mat]) == 0
    outs = {}
    for name, main, extra in (("jax", jax_solve.main, []),
                              ("torch", solve.main, ["--device", "cpu"])):
        path = str(d / f"tracer_{name}.nc")
        shutil.copy(d / "tracer.nc", path)
        assert main([*extra, "-v", ",".join(VARS), mat, path]) == 0
        outs[name] = path
    return mat, str(d / "tracer.nc"), outs


def _read(path, var):
    with netcdf_file(path, "r", mmap=False) as f:
        return np.array(f.variables[var].data, dtype=np.float64)


@pytest.mark.parametrize("var", VARS)
def test_cli_matches_jax_driver(workflow, var):
    mat, before, outs = workflow
    maps = load_ind_maps(mat)
    x_t = maps.flatten_field(_read(outs["torch"], var))
    x_j = maps.flatten_field(_read(outs["jax"], var))
    assert np.abs(x_t - x_j).max() <= 1e-10 * np.abs(x_j).max()
    land = maps.int3_to_ind < 0
    orig = _read(before, var)
    assert np.array_equal(_read(outs["torch"], var)[land], orig[land])
    assert not np.array_equal(_read(outs["torch"], var)[~land], orig[~land])


@pytest.mark.parametrize("var", VARS)
def test_cli_residual(workflow, var):
    mat, before, outs = workflow
    maps = load_ind_maps(mat)
    A = read_matrix_file(mat).to_scipy()
    b = maps.flatten_field(_read(before, var))
    x = maps.flatten_field(_read(outs["torch"], var))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-10


@pytest.mark.parametrize("flags,msg", [
    (["-n", "2", "--device", "cuda"], "requested 4 devices, have "),
    (["-n", "2,1", "--device", "cuda"], "requested 2 devices, have "),
    (["--rhs-devices", "2", "--device", "cpu"], "must divide n_devices=1")])
def test_unported_options_exit_1(workflow, flags, msg, capsys):
    """The distributed options are ported (tests/test_torch_dist_cli.py
    runs them); what still exits 1 before any rank starts is -n beyond
    the cards there are (none here, one on the card's machine) and an rhs
    axis that does not divide the rank count."""
    mat, before, _ = workflow
    rc = solve.main([*flags, "-v", VARS[0], mat, before])
    assert rc == 1
    assert msg in capsys.readouterr().err


def test_run_solve_reports_residuals(workflow, tmp_path):
    mat, before, _ = workflow
    path = str(tmp_path / "t.nc")
    shutil.copy(before, path)
    out = solve.run_solve(mat, path, ",".join(VARS), device="cpu",
                          rhs_chunk=1)
    assert out["groups"] == [[v] for v in VARS]
    assert max(out["residuals"].values()) <= 1e-10
    assert isinstance(out["factorization"], MultifrontalFactorization)


@pytest.mark.parametrize("prec", ["f32", "auto"])
def test_cli_prec(workflow, tmp_path, prec):
    """--prec f32 factors in float32 (refining, or escalating to float64);
    --prec auto is float64 on the CPU. Either way the contract holds."""
    mat, before, outs = workflow
    path = str(tmp_path / "t.nc")
    shutil.copy(before, path)
    out = solve.run_solve(mat, path, ",".join(VARS), device="cpu",
                          precision=prec)
    assert max(out["residuals"].values()) <= 1e-10
    fac = out["factorization"]
    if prec == "auto":
        assert fac.engine.prec == torch.float64 and fac.escalation is None
    else:
        assert (fac.engine.prec == torch.float32) == (fac.escalation is None)
    maps = load_ind_maps(mat)
    for var in VARS:
        x = maps.flatten_field(_read(path, var))
        x_j = maps.flatten_field(_read(outs["jax"], var))
        assert np.abs(x - x_j).max() <= 1e-10 * np.abs(x_j).max()


def test_cli_rejects_unknown_prec(workflow, capsys):
    mat, before, _ = workflow
    with pytest.raises(SystemExit) as exc:
        solve.main(["--device", "cpu", "--prec", "bf16", "-v", VARS[0], mat,
                    before])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_cli_factors_save_then_load(workflow, tmp_path, capsys, monkeypatch):
    """--factors: the first run factors and writes the file, the second
    loads it (no round assembled) and writes the same solution bit for
    bit, within the contract."""
    mat, before, _ = workflow
    calls = []
    real = ck.ell_assemble
    monkeypatch.setattr(ck, "ell_assemble",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    f = str(tmp_path / "factors.npz")
    outs = []
    for run in range(2):
        path = str(tmp_path / f"t{run}.nc")
        shutil.copy(before, path)
        n = len(calls)
        assert solve.main(["-D", "1", "--device", "cpu", "--factors", f,
                           "-v", ",".join(VARS), mat, path]) == 0
        log = capsys.readouterr().out
        if run == 0:
            assert len(calls) > n and f"numeric factors saved to {f}" in log
        else:
            assert len(calls) == n and f"numeric factors loaded from {f}" \
                in log
        outs.append(path)
    A = read_matrix_file(mat).to_scipy()
    maps = load_ind_maps(mat)
    for var in VARS:
        b = maps.flatten_field(_read(before, var))
        x0, x1 = (maps.flatten_field(_read(p, var)) for p in outs)
        assert np.array_equal(x0, x1)
        assert np.linalg.norm(A @ x1 - b) / np.linalg.norm(b) <= 1e-10


@pytest.mark.parametrize("npgrid", ["1", "4"])
def test_cli_memplan_matches_jax(workflow, npgrid, capsys):
    """--memplan at f64 prints the JAX driver's lines for the same -n (on
    the CPU under x64 the JAX driver sizes float64 factors)."""
    mat, _, _ = workflow
    assert jax_solve.main(["--memplan", "-n", npgrid, mat]) == 0
    want = capsys.readouterr().out
    assert solve.main(["--memplan", "-n", npgrid, "--prec", "f64",
                       mat]) == 0
    got = capsys.readouterr().out
    assert got == want and "float64 factors" in got
    assert f"({int(npgrid) ** 2} device(s)" in got


@pytest.mark.parametrize("device,prec,dtype", [
    ("cuda", "auto", "float32"), ("cpu", "auto", "float64"),
    ("cuda", "f64", "float64")])
def test_cli_memplan_dtype_touches_no_device(workflow, device, prec, dtype,
                                             capsys):
    """--memplan sizes at the --prec dtype (auto: f32 on cuda, f64 on cpu)
    on the host alone: it runs for --device cuda with no card present."""
    mat, _, _ = workflow
    assert solve.main(["--memplan", "--device", device, "--prec", prec,
                       mat]) == 0
    assert f"{dtype} factors" in capsys.readouterr().out
