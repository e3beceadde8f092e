"""The Newton-iteration mix (``traffic/nk_device.json``) on the CPU at a
tiny size: the port's update of each step's values against the
reference's own (``reference/fields.py``), the metrics the mix keeps for
its cell, the steps that ``failed`` counts under the faults the mix can
have, and the apply mix's inputs as they were before the mix came."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.reference import fields
from benchmark.tests.conftest import ROOT, TINY, pending_metrics
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    SparseMatrix)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch

SEED = 2 ** 31 + 23
CELL = f"{TINY}.nk_device"
# what the cell lists
LISTED = {0: {"refactor_solve_s", "peak_mem_gb", "setup_s"},
          1: {"update_ms.refactor", "facade_host_ms.refactor",
              "engine_factor_ms.refactor", "treetop_lu_ms.refactor",
              "panel_roofline.refactor", "assemble_roofline.refactor",
              "solve_ms.refactor", "device_idle_share.refactor"}}


def quiet(_msg):
    pass


@pytest.mark.parametrize("name", ["tiny_centered", "tiny_upwind3"])
def test_the_ports_update_is_the_references_values(name):
    """Three steps of the program's update (the port's plan, on the CPU)
    equal the reference's values bit for bit: both multiply the same
    float64 field entries by the same c and add each (row, column)'s
    contributions left to right in slot order."""
    config = run.load_json(ROOT / "benchmark" / "tests" / "configs"
                           / f"{name}.json")
    prob = run.problem(name, config)
    matrix = SparseMatrix(nzval=prob["nzval"], colind=prob["colind"],
                          rowptr=prob["rowptr"], coupled_tracer_cnt=1)
    update = run.FieldUpdate(config, matrix, SEED, 1e-3, torch.device("cpu"))
    ref = fields.FieldValues(config, SEED, 1e-3)
    assert np.array_equal(ref.colind, prob["colind"])
    assert np.array_equal(ref.rowptr, prob["rowptr"])
    assert ref.nzval0.tobytes() == prob["nzval"].tobytes()
    for index in (1, 2, 3):
        got, want = update(index), ref(index)
        assert got.tobytes() == want.tobytes()
        rel = np.abs(want / prob["nzval"] - 1)
        assert 0 < rel.max() < 1e-2
    assert update(1).tobytes() != update(2).tobytes()


def test_the_draws_follow_the_seed():
    config = run.load_json(ROOT / "benchmark" / "tests" / "configs"
                           / f"{TINY}.json")
    a = fields.FieldValues(config, SEED, 1e-3)
    b = fields.FieldValues(config, SEED, 1e-3)
    assert np.array_equal(a(4), b(4)) and not np.array_equal(a(4), a(5))
    assert not np.array_equal(a(4), fields.FieldValues(config, 12, 1e-3)(4))
    assert np.array_equal(fields.FieldValues(config, 3, 0.0)(1), a.nzval0)
    # signs stay: the scale keeps c near 1
    assert (np.sign(a(4)) == np.sign(a.nzval0)).all()


def test_the_mix_keeps_its_metrics_for_its_cell(tiny_spec):
    """Each metric kept for the mix's cell has a reader, moves the seconds
    per Newton iteration, and names a layer; the tiny cell reports them
    (its run: ``test_harness_run.py``)."""
    for trace in (0, 1):
        assert {m["name"] for m in run.cell_metrics(tiny_spec, CELL, trace)} \
            == LISTED[trace]
    pending = pending_metrics()
    assert [m["name"] for m in pending["end_to_end"]] == ["refactor_solve_s"]
    for m in pending["end_to_end"] + pending["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for m in pending["per_layer"]:
        assert m["moves"] == "refactor_solve_s" and m["layer"]
    assert {m["name"] for m in pending["per_layer"]} == LISTED[1]


def _unperturbed(self, index):
    """The harness's fault: the program gets the configuration's own
    values, while the reference perturbs them."""
    return self.plan.update(self.stacked0).cpu().numpy()


FAULTS = {
    "stale_engine": (mf_torch.TorchMultifrontal, "refactor",
                     lambda self, matrix: None),
    "unperturbed_values": (run.FieldUpdate, "__call__", _unperturbed),
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["control"])
def test_failed_counts_the_faulted_steps(tiny_spec, monkeypatch, fault):
    if fault == "control":
        kw = dict(precision=control.LOWER["f64"], refine=False)
    else:
        owner, attr, fn = FAULTS[fault]
        monkeypatch.setattr(owner, attr, fn)
        kw = {}
    logs = []
    out = run.run_cell(tiny_spec, CELL, SEED + 1, 0.5, False, device="cpu",
                       log=logs.append, **kw)
    assert out["correct"] is False
    assert out["attempted"] >= 1
    limit = out["checks"]["max_rel_residual"]["limit"]
    judged = [float(line.rsplit("judged ", 1)[1]) for line in logs
              if line.startswith("#   step") and " window:" in line]
    # the log lists every failed step with its residual
    assert out["failed"] == sum(1 for r in judged if r > limit) >= 1
    if fault == "stale_engine":
        # refinement puts some steps back at the contract; the unrefined
        # apply of the stale factors is caught
        c = out["checks"]["raw_apply_rel_residual"]
        assert c["value"] > c["limit"]
    else:
        # the values the program solved are not the step's, or float32
        # factors go unrefined: every step fails
        assert out["failed"] == out["attempted"]


def test_an_unknown_kind_of_values_is_refused(tiny_spec, monkeypatch):
    real = run.load_json

    def load_json(path):
        d = real(path)
        if path.parent.name == "traffic":
            d["values"] = "columns"
        return d
    monkeypatch.setattr(run, "load_json", load_json)
    with pytest.raises(SystemExit, match="harness draws"):
        run.run_cell(tiny_spec, CELL, SEED, 0.5, False, device="cpu",
                     log=quiet)


# sha256 of the values the apply mix hands the program's constructor and
# of its first five refined right-hand sides, at seed 2**31 + 7 on the
# tiny configuration, as the harness drew them before the fields mix
APPLY_DIGEST = ("b9645dc2383cffc894ee64237b6d8d00"
                "51e77267bc738b52349c3a32c814cff9")


def test_the_apply_mix_draws_what_it_drew(tiny_spec, monkeypatch):
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf
    seen = []
    init = mf.MultifrontalFactorization.__init__
    solve = mf.MultifrontalFactorization.solve

    def init_(self, matrix, *a, **kw):
        seen.append(np.asarray(matrix.nzval, dtype=np.float64).tobytes())
        init(self, matrix, *a, **kw)

    def solve_(self, b, refine=True):
        if refine:
            seen.append(np.asarray(b, dtype=np.float64).tobytes())
        return solve(self, b, refine=refine)
    monkeypatch.setattr(mf.MultifrontalFactorization, "__init__", init_)
    monkeypatch.setattr(mf.MultifrontalFactorization, "solve", solve_)
    out = run.run_cell(tiny_spec, f"{TINY}.apply", 2 ** 31 + 7, 0.5, False,
                       device="cpu", log=quiet)
    assert out["correct"] is True and len(seen) >= 6
    h = hashlib.sha256()
    for b in seen[:6]:
        h.update(b)
    assert h.hexdigest() == APPLY_DIGEST
