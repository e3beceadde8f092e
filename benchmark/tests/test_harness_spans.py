"""The reader of the program's spans (``host_residual_ms.apply``) on
traced stretches made by hand: nothing without a trace or without the
program's spans, the hand-computed ms per traced request with them."""

from types import SimpleNamespace

import pytest

from benchmark import run

NAME = "host_residual_ms.apply"


def _run(idle_gaps, traced=4, window=10):
    steps = ([dict(phase="window")] * window
             + [dict(phase="traced")] * traced)
    trace = None if idle_gaps is None else dict(
        busy_s=0.2, window_s=0.8, device_ops=[], idle_gaps=idle_gaps)
    return SimpleNamespace(trace=trace, steps=steps)


def test_nothing_without_a_trace():
    assert run.load_reader(NAME)(_run(None)) is None


def test_nothing_where_the_program_opens_no_span():
    """The parent's idle gaps: the harness's range and torch operators."""
    gaps = [["bench.solve", 0.472], ["aten::bmm", 0.025]]
    assert run.load_reader(NAME)(_run(gaps)) is None


def test_the_residual_spans_per_traced_request():
    gaps = [["nk.refine.host_residual", 0.12], ["nk.mf.check", 0.08],
            ["nk.refine.host_residual_ext", 0.004], ["aten::bmm", 0.02],
            ["nk.engine.fwd", 0.01], ["bench.solve", 0.003]]
    assert run.load_reader(NAME)(_run(gaps)) == pytest.approx(
        1e3 * (0.12 + 0.08 + 0.004) / 4)
