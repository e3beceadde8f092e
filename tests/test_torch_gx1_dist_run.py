"""scripts/torch_gx1_dist_run.py, the port of scripts/gx1_dist_run.py, at
the tiny size on a gloo world of 2 ranks on the CPU.

The runner's refined solutions (two seeded right-hand sides, leaf 16)
are held within 1e-10 of the JAX facade's with ``n_devices=2`` on the
simulated mesh (as tests/test_torch_dist_solver.py builds it); a rerun on
the same ``--ckpt`` directory loads every round, computes none and gives
the same bits; cuda with more ranks than cards exits 1 before it builds
anything, as does a ``--tol`` outside (0, 1e-10], by which the run is judged.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization as JaxMF)
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.nk_loop import (
    SIZES, problem_files)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_gx1_dist_run.py"


def _runner(cache, ckpt, out):
    return subprocess.Popen(
        [sys.executable, str(SCRIPT), "--size", "tiny", "--device", "cpu",
         "-n", "2,1", "--cache", str(cache), "--ckpt", str(ckpt), "--out",
         str(out)], cwd=cache, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=240)
    return proc.returncode, out


def _load(path):
    with np.load(path) as z:
        return z["X"], z["residuals"], json.loads(str(z["stats"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs of the runner on one checkpoint directory, the JAX
    oracle computed while the first one runs."""
    d = tmp_path_factory.mktemp("gx1_dist_run")
    mat, _ = problem_files(SIZES["tiny"], str(d))
    ckpt = d / "rounds"
    first = _runner(d, ckpt, d / "first.npz")
    matrix = read_matrix_file(mat)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 2))
    X_jax = JaxMF(matrix, impl="jax", maps=load_ind_maps(mat), leaf_size=16,
                  n_devices=2, refine_tol=1e-10).solve(B)
    rc1, log1 = _finish(first)
    rc2, log2 = _finish(_runner(d, ckpt, d / "second.npz"))
    return dict(d=d, X_jax=X_jax, rc=(rc1, rc2), log=(log1, log2))


def test_runner_matches_the_jax_mesh_facade(runs):
    rc, log = runs["rc"][0], runs["log"][0]
    assert rc == 0, log
    last = log.strip().splitlines()[-1]
    assert last.startswith("tiny distributed: ok=True max_rel="), last
    X, rel, st = _load(runs["d"] / "first.npz")
    assert st["ranks"] == 2 and st["ok"] and rel.max() <= 1e-10
    assert st["rounds_computed"] == st["rounds"] > 0
    assert st["rounds_loaded"] == 0
    X_jax = runs["X_jax"]
    assert np.abs(X - X_jax).max() <= 1e-10 * np.abs(X_jax).max()


def test_rerun_resumes_every_round_bit_for_bit(runs):
    rc, log = runs["rc"][1], runs["log"][1]
    assert rc == 0, log
    X1, rel1, st1 = _load(runs["d"] / "first.npz")
    X2, rel2, st2 = _load(runs["d"] / "second.npz")
    assert st2["rounds_loaded"] == st2["rounds"] == st1["rounds"]
    assert st2["rounds_computed"] == 0
    assert "0 rounds computed" in log
    np.testing.assert_array_equal(X2, X1)
    np.testing.assert_array_equal(rel2, rel1)


def _load_runner():
    spec = importlib.util.spec_from_file_location("torch_gx1_dist_run",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_too_few_cards_exits_1(tmp_path, capsys):
    assert _load_runner().main(["--size", "tiny", "--device", "cuda", "-n",
                                "64", "--cache", str(tmp_path)]) == 1
    assert "requested 4096 devices, have" in capsys.readouterr().err
    # it refused before building anything
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("tol", ["1e-8", "0"])
def test_tol_outside_the_contract_is_refused(tmp_path, capsys, tol):
    with pytest.raises(SystemExit) as e:
        _load_runner().main(["--size", "tiny", "--device", "cpu", "--tol",
                             tol, "--cache", str(tmp_path)])
    assert e.value.code == 2
    assert "outside (0, 1e-10]" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
