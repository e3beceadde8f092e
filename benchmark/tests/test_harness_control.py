"""The check has to fail what it must: the control (the program's float32
factors without refinement, benchmark/control.py) and the faults a cell
can have, planted under the timed path of a whole run on the tiny
configuration (the look for a card skipped). The exchange between chips
has no fault here: every cell runs on one card."""

import numpy as np
import pytest

from benchmark import control, run
from benchmark.tests.conftest import MIXES, TINY
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf, mf_torch


def quiet(_msg):
    pass


@pytest.mark.parametrize("mix", MIXES)
def test_the_control_is_not_correct(tiny_spec, mix):
    stale = [31, 32] if mix == "nk_device" else []
    rows = control.readings(tiny_spec, f"{TINY}.{mix}", 0.3, [11],
                            [21, 22, 23], stale, device="cpu", log=quiet)
    program, ctl, flt = rows[0], rows[1:4], rows[4:]
    assert program["variant"] == "program" and program["correct"]
    assert len(ctl) == 3 and len(flt) == len(stale)
    for r in ctl:
        assert r["variant"] == "control" and not r["correct"]
        assert (r["checks"]["max_rel_residual"]["value"]
                > r["checks"]["max_rel_residual"]["limit"])
    # the engine's stale factors: refinement hides them, the raw apply
    # does not
    for r in flt:
        assert r["variant"] == "stale_engine" and not r["correct"]
        assert (r["checks"]["raw_apply_rel_residual"]["value"]
                > r["checks"]["raw_apply_rel_residual"]["limit"])
    # and the engine refactors again once the variant is over
    assert mf_torch.TorchMultifrontal.refactor.__name__ == "refactor"


def _solve_fault(name):
    real = mf.MultifrontalFactorization.solve

    def solve(self, b, refine=True):
        X = np.array(real(self, b, refine=refine))
        if name == "half_batch":
            if X.ndim == 2 and X.shape[1] > 1:
                X[:, X.shape[1] // 2:] = 0.0
            else:
                X[len(X) // 2:] = 0.0
        elif name == "answer_altered":
            X = X * (1 + 1e-7)
        return X
    return solve


FAULTS = {
    # a step that returns its state unchanged: the engine keeps the last
    # factors (refined solutions may still meet the contract: the raw
    # apply of the factors does not), or the facade keeps everything
    "state_unchanged_engine": (mf_torch.TorchMultifrontal, "refactor",
                               lambda self, matrix: None),
    "state_unchanged_facade": (mf.MultifrontalFactorization, "refactor",
                               lambda self, matrix=None: None),
    # half of the batch left out
    "half_batch": (mf.MultifrontalFactorization, "solve",
                   _solve_fault("half_batch")),
    # an answer altered where it is produced
    "answer_altered": (mf.MultifrontalFactorization, "solve",
                       _solve_fault("answer_altered")),
}
CASES = [(mix, f) for mix in MIXES for f in FAULTS
         if mix == "nk_device" or not f.startswith("state")]


@pytest.mark.parametrize("mix,fault", CASES)
def test_each_fault_is_not_correct(tiny_spec, monkeypatch, mix, fault):
    owner, attr, fn = FAULTS[fault]
    monkeypatch.setattr(owner, attr, fn)
    out = run.run_cell(tiny_spec, f"{TINY}.{mix}", 2 ** 31 + 3, 0.5, False,
                       device="cpu", log=quiet)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
