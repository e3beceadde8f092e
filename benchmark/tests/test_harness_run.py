"""A CPU rehearsal of benchmark/run.py on the tiny configuration: the
result's keys in their order, and the paths that need a card failing
without one rather than falling back."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run
from benchmark.tests.conftest import MIXES, ROOT, TINY

SEED = 2 ** 31 + 7
HEAD = ["correct", "attempted", "failed", "metrics", "device"]


def quiet(_msg):
    pass


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("mix", MIXES)
def test_result_line(tiny_spec, mix, trace):
    cell = f"{TINY}.{mix}"
    out = run.run_cell(tiny_spec, cell, SEED, 0.5, bool(trace),
                       device="cpu", log=quiet)
    keys = list(out)
    assert keys[:5] == HEAD and keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = {m["name"] for m in run.cell_metrics(tiny_spec, cell, trace)}
    got = set(out["metrics"])
    assert got <= want
    # device metrics read nothing on the CPU
    assert not got & {"peak_mem_gb", "device_idle_share.refactor",
                      "panel_roofline.refactor", "device_idle_share.apply"}
    if not trace:
        assert "setup_s" in got and len(got) >= 2
    assert out["device"]["platform"] == "cpu"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_every_step_is_judged(tiny_spec, monkeypatch):
    """One answer altered in every third step: each of them fails, and
    ``failed`` counts those of the window."""
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf
    real = mf.MultifrontalFactorization.solve
    calls = []

    def solve(self, b, refine=True):
        X = np.array(real(self, b, refine=refine))
        calls.append(refine)
        if refine and len(calls) % 3 == 0:
            X[0, 0] *= 1 + 1e-6
        return X
    monkeypatch.setattr(mf.MultifrontalFactorization, "solve", solve)
    logs = []
    out = run.run_cell(tiny_spec, f"{TINY}.apply", SEED, 0.5, False,
                       device="cpu", log=logs.append)
    n_steps = sum(calls)
    warmup = 3
    assert out["correct"] is False
    assert out["failed"] == sum(1 for i in range(warmup + 1, n_steps + 1)
                                if i % 3 == 0)
    assert out["attempted"] == n_steps - warmup
    assert any(f"all {n_steps} steps judged" in line for line in logs)


@pytest.mark.parametrize("key,value", [("loop", "open"), ("clients", 4)])
def test_a_load_the_harness_does_not_drive_is_refused(tiny_spec,
                                                      monkeypatch, key,
                                                      value):
    real = run.load_json

    def load_json(path):
        d = real(path)
        if path.parent.name == "traffic":
            d[key] = value
        return d
    monkeypatch.setattr(run, "load_json", load_json)
    with pytest.raises(SystemExit, match="harness drives"):
        run.run_cell(tiny_spec, f"{TINY}.apply", SEED, 0.5, False,
                     device="cpu", log=quiet)


def test_a_coupled_configuration_is_refused(tiny_spec, monkeypatch):
    real = run.load_json

    def load_json(path):
        d = real(path)
        if path.parent.name == "configs":
            d["coupled_tracer_cnt"] = 2
        return d
    monkeypatch.setattr(run, "load_json", load_json)
    with pytest.raises(SystemExit, match="one tracer"):
        run.run_cell(tiny_spec, f"{TINY}.apply", SEED, 0.5, False,
                     device="cpu", log=quiet)


def test_every_metric_has_a_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for cell in spec["workloads"]:
        names = {m["name"] for m in run.cell_metrics(spec, cell["name"],
                                                      False)}
        assert "setup_s" in names and len(names) >= 2
        assert run.cell_metrics(spec, cell["name"], True)


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_cli_without_a_card_exits_nonzero_and_prints_nothing():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gx3deep_centered.apply", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_no_card_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_the_card_path_does_not_fall_back_to_the_cpu(tiny_spec):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda-marked test runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.run_cell(tiny_spec, f"{TINY}.apply", SEED, 0.5, False,
                     device="cuda", log=quiet)


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for trace in ("0", "1"):
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "gx3deep_centered.apply", "--seed", "5", "--seconds",
             "1", "--trace", trace], cwd=tmp_path, env=_no_card_env(),
            capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout == ""
    # past the card check, the program itself is missing
    code = ("import json, sys; sys.path.insert(0, '.');"
            "from benchmark.tests.conftest import ROOT;"
            "from benchmark import run;"
            "spec = json.load(open('BENCHMARK.json'));"
            "run.run_cell(spec, 'gx3deep_centered.apply', 5, 1, False,"
            " device='cpu')")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_no_card_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "nk_ocn_tracer_jacobian_precond_tpu_torch" in res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("mix", MIXES)
def test_on_the_card(tiny_spec, mix):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(tiny_spec, f"{TINY}.{mix}", SEED, 1.0, True,
                       device="cuda", log=quiet)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
