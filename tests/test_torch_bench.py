"""The port's factor-and-solve bench driver (drivers/bench.py) against the
JAX package's bench.py, on the CPU at the "tiny" size (24x20x8).

Same problem, same right-hand sides (default_rng(0)), same steps: the
port's gen_A problem equals bench.py's array for array; its scipy baseline
runs the same host code as bench.bench_scipy, so the solutions are equal
bit for bit; its device path's solution agrees with the JAX facade's
(bench.bench_mf) to 1e-12 relative when both refine to the facade's own
tolerance, as the refined facade solves of tests/test_torch_mf.py do, with
both residuals at most 1e-10. bench.py's
functions return no solution: they are read from its ``_residual``.
"""

import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

import bench
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import bench as port
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import nk_loop

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-10
# bench_mf is compared at the facade's own refine_tol: at bench's 1e-10 one
# plain-refinement step meets the target, and each package keeps what its
# own unrefined solve left (1.27e-12 apart at tiny, as the NK loop's
# iterates are, tests/test_torch_nk_loop.py)
TIGHT = 1e-13
# bench.py's JSON keys (bench.py:353-384) and the port's additions
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "precision",
              "factor_s", "solve_s", "residual", "cold_factor_s",
              "cold_solve_s", "symbolic_s", "baseline_factor_s",
              "baseline_solve_s", "baseline_class", "precision_note"}
PORT_KEYS = {"peak_mem_gb", "device", "escalated", "baseline_residual",
             "baseline_host"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The tiny problem made by both packages in their own directories,
    and bench's right-hand sides."""
    d_ref = str(tmp_path_factory.mktemp("bench_ref"))
    d_port = str(tmp_path_factory.mktemp("bench_port"))
    ref = bench.build_problem("tiny", d_ref)
    matrix, maps, circ = nk_loop.build_problem(nk_loop.SIZES["tiny"], d_port)
    B = np.random.default_rng(0).standard_normal((matrix.flat_len, 4))
    return ref, (matrix, maps, d_port), B


def _captured(monkeypatch):
    """bench.py's solutions, as its _residual sees them."""
    seen = []
    real = bench._residual

    def keep(matrix, X, B):
        seen.append(np.array(X))
        return real(matrix, X, B)
    monkeypatch.setattr(bench, "_residual", keep)
    return seen


def _run(capsys, *argv) -> dict:
    assert port.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_build_problem_equals_bench(problem):
    (m_ref, maps_ref), (matrix, maps, _), _ = problem
    assert bench.SIZES == nk_loop.SIZES
    for f in ("nzval", "colind", "rowptr"):
        a, b = getattr(m_ref, f), getattr(matrix, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert m_ref.coupled_tracer_cnt == matrix.coupled_tracer_cnt
    for f in ("int3_to_ind", "ind_to_k", "ind_to_j", "ind_to_i"):
        assert np.array_equal(getattr(maps_ref, f), getattr(maps, f)), f
    assert maps_ref.tracer_state_len == maps.tracer_state_len


def test_bench_scipy_bitwise_equal(problem, monkeypatch):
    """The same host code (splu, then refinement to tol) on the same B."""
    (m_ref, _), (matrix, _, _), B = problem
    seen = _captured(monkeypatch)
    t_f, t_s, res_ref = bench.bench_scipy(m_ref, B, TOL)
    s_f, s_s, res, X = port.bench_scipy(matrix, B, TOL)
    assert np.array_equal(X, seen[0])
    assert min(s_f, s_s, t_f, t_s) > 0
    assert res <= 1e-10 and res_ref <= 1e-10


def test_bench_mf_matches_jax(problem, monkeypatch):
    """bench_mf's steps through both packages: solutions within 1e-12 of
    each other, both residuals <= 1e-10, every time positive."""
    (m_ref, maps_ref), (matrix, maps, _), B = problem
    seen = _captured(monkeypatch)
    ref = bench.bench_mf(m_ref, maps_ref, B, TIGHT, "jax", prec="f64")
    m = port.bench_mf(matrix, maps, B, TIGHT, impl="torch", prec="f64",
                      device="cpu")
    X_ref = seen[0]
    rel = float(np.abs(m["X"] - X_ref).max() / np.abs(X_ref).max())
    assert rel <= 1e-12, rel
    assert m["res"] <= 1e-10 and ref["res"] <= 1e-10
    assert m["res"] == nk_loop.residual(matrix, m["X"], B)
    assert min(m[k] for k in ("factor", "solve", "cold_factor",
                              "cold_solve", "symbolic")) > 0
    assert m["peak_mem_gb"] is None and m["device"] == "cpu"
    assert m["escalated"] is None


@pytest.fixture(scope="module")
def first(problem, tmp_path_factory):
    """main at tiny on the CPU with a fresh baseline, in its own cache
    directory: the JSON line."""
    cache = str(tmp_path_factory.mktemp("bench_main"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port.main(["--size", "tiny", "--device", "cpu", "--cache",
                          cache]) == 0
    return cache, json.loads(out.getvalue().strip().splitlines()[-1])


def test_main_prints_bench_line(first):
    cache, out = first
    assert set(out) == BENCH_KEYS | PORT_KEYS
    assert out["metric"] == ("jacobian factor+4-rhs solve wall-clock, tiny "
                             "grid, residual<=1e-10")
    assert out["unit"] == "s" and out["precision"] == "f64"
    assert out["value"] == out["factor_s"] + out["solve_s"]
    base = out["baseline_factor_s"] + out["baseline_solve_s"]
    assert out["vs_baseline"] == base / out["value"]
    assert out["residual"] <= 1e-10 and out["baseline_residual"] <= 1e-10
    assert out["peak_mem_gb"] is None and out["device"] == "cpu"
    assert out["escalated"] is None
    host = port.host_cpu()
    assert out["baseline_host"] == host
    assert host["cpu_model"] in out["baseline_class"]
    assert "ONE CPU core" not in out["baseline_class"]
    with open(os.path.join(cache, "baseline_tiny.json")) as f:
        assert json.load(f) == [out["baseline_factor_s"],
                                out["baseline_solve_s"],
                                out["baseline_residual"]]


def test_reuse_baseline_runs_no_splu(first, monkeypatch, capsys):
    cache, out = first

    def refuse(*a, **kw):
        raise AssertionError("splu called")
    monkeypatch.setattr(scipy.sparse.linalg, "splu", refuse)
    again = _run(capsys, "--size", "tiny", "--device", "cpu", "--cache",
                 cache, "--reuse-baseline", "--nrhs", "2")
    assert again["baseline_factor_s"] == out["baseline_factor_s"]
    assert again["baseline_host"] == out["baseline_host"]
    assert again["metric"].startswith("jacobian factor+2-rhs solve")
    assert again["residual"] <= 1e-10
    # without the flag the baseline is measured afresh: splu is called
    with pytest.raises(AssertionError, match="splu called"):
        port.main(["--size", "tiny", "--device", "cpu", "--cache", cache])


def test_host_cpu_where_the_model_name_is_hidden(monkeypatch):
    """A virtual machine's /proc/cpuinfo may give the model name as
    "unknown": the vendor, family and model numbers name the CPU."""
    import builtins
    from unittest import mock
    info = ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
            "model\t\t: 207\nmodel name\t: unknown\n\nprocessor\t: 1\n"
            "model name\t: other\n")
    monkeypatch.setattr(builtins, "open", mock.mock_open(read_data=info))
    host = port.host_cpu()
    assert host["cpu_model"] == ("vendor_id GenuineIntel cpu family 6 "
                                 "model 207")
    assert host["cpu_count"] == os.cpu_count()


def test_default_cache_outside_the_repo():
    default = Path(port.DEFAULT_CACHE).resolve()
    assert REPO not in default.parents and default != REPO
    assert default.name != ".bench_cache"
    assert default.parent == Path(os.path.expanduser("~")).resolve() / \
        ".cache"


def test_nk_loop_line(first, capsys):
    cache, out = first
    line = _run(capsys, "--size", "tiny", "--device", "cpu", "--cache",
                cache, "--reuse-baseline", "--nk-loop", "2", "--nrhs", "2")
    assert line["metric"].startswith("NK outer-loop per-iteration cost")
    assert len(line["iterations"]) == 2
    base = out["baseline_factor_s"] + out["baseline_solve_s"]
    assert abs(line["vs_baseline"] - base / line["value"]) <= 1e-3 * (
        base / line["value"]) + 1e-3
    assert all(r["residual"] <= 1e-10 for r in line["iterations"])


def test_numpy_impl_runs(first, capsys):
    cache, _ = first
    line = _run(capsys, "--size", "tiny", "--device", "cpu", "--cache",
                cache, "--reuse-baseline", "--impl", "numpy", "--nrhs", "1")
    assert line["residual"] <= 1e-10
    assert line["value"] == line["factor_s"] + line["solve_s"]
    assert line["device"] == "cpu" and line["peak_mem_gb"] is None
    # the host engine is never labelled, nor run, as a card measurement
    with pytest.raises(SystemExit) as e:
        port.main(["--size", "tiny", "--cache", cache, "--reuse-baseline",
                   "--impl", "numpy"])
    assert e.value.code == 2
    assert "--impl numpy factors on the host" in capsys.readouterr().err
    with pytest.raises(ValueError, match="factors on the host"):
        port.bench_mf(None, None, None, TOL, impl="numpy", device="cuda")


def test_no_card_raises(monkeypatch):
    """cuda is the default device; without a card the bench raises
    before it makes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--size", "tiny", "--cache", "/nonexistent/never"])
