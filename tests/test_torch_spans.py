"""The port's spans (utils/profiling.py::span) on the CPU.

* No profiler recording: ``span`` is the shared no-op, and a refined solve
  and a refactor create no record function at all.
* Under ``torch_trace``: a refined solve records the facade's, the
  refiner's and the engine's solve rounds' ranges, nested as the code
  nests them and as many as the refiner's ``stats`` and the plans say; a
  refactor with the stage timer inactive records its stages and rounds
  without a synchronize.
* Solutions and factors are bit-equal with the profiler on and off.
* drivers/profile.py's arithmetic over a timeline made by hand: busy
  time, idle gaps, span totals and the idle time under each span, with
  the annotation ranges kept off the device's timeline.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers import profile
from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.nk_loop import (
    build_problem)
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import profiling

DIMS = dict(imt=16, jmt=12, km=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """A small synthetic problem, factored once at float64 on the CPU,
    and its right-hand sides."""
    matrix, maps, _ = build_problem(DIMS, str(tmp_path_factory.mktemp("sp")))
    fac = MultifrontalFactorization(matrix, maps=maps, device="cpu",
                                    refine_tol=1e-10)
    B = np.random.default_rng(5).standard_normal((matrix.flat_len, 2))
    return SimpleNamespace(matrix=matrix, fac=fac, B=B)


def _host_spans(prof) -> list:
    """(start ns, end ns, name) of every ``nk.*`` range, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.PREFIX))


def _inside(spans, outer: str, inner: str) -> list:
    """For each ``outer`` range, the number of ``inner`` ranges in it."""
    return [sum(1 for c0, c1, m in spans if m == inner and a <= c0
                and c1 <= b) for a, b, n in spans if n == outer]


def test_span_without_a_profiler_is_the_shared_no_op(problem, monkeypatch):
    assert profiling.span("x") is profiling._NO_SCOPE
    assert profiling.span("y", round=3) is profiling._NO_SCOPE

    def refuse(*a, **k):
        raise AssertionError("a record function while no profiler records")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    problem.fac.solve(problem.B)
    problem.fac.refactor()


def test_a_refined_solve_records_its_spans(problem, tmp_path):
    fac = problem.fac
    with profiling.torch_trace(str(tmp_path / "t"), "cpu") as prof:
        fac.solve(problem.B)
    st = fac._refiner.stats
    rounds = len(fac.engine.plans)
    spans = _host_spans(prof)
    count = Counter(n for _, _, n in spans)
    nk = profiling.PREFIX
    # the facade judges the refiner's own residuals: no check of its own
    assert count[nk + "mf.solve"] == 1 and count[nk + "mf.check"] == 0
    # a residual on the device (or a host pass in extended precision) per
    # outer step, more only after a polish stall
    res = count[nk + "refine.residual"]
    ext = count[nk + "refine.host_residual_ext"]
    assert count[nk + "refine.host_residual"] == 0
    assert ext == st["extended"]
    assert st["outers"] <= res + ext <= st["outers"] + 2
    assert count[nk + "refine.correct"] == st["host_applies"] >= 1
    assert count[nk + "refine.polish"] == st["phases"].count("polish")
    # every preconditioner application is one sweep of every round
    sweeps = count[nk + "engine.sweep"]
    assert sweeps >= st["host_applies"]
    assert count[nk + "engine.fwd"] == count[nk + "engine.bwd"] \
        == rounds * sweeps
    # nesting: the solve holds everything; each plain correction holds one
    # sweep, each sweep one forward and one backward range per round
    for name in ("refine.residual", "refine.correct", "engine.sweep"):
        assert _inside(spans, nk + "mf.solve", nk + name) == [count[nk
                                                                   + name]]
    assert _inside(spans, nk + "refine.correct", nk + "engine.sweep") \
        == [1] * st["host_applies"]
    for name in ("engine.fwd", "engine.bwd"):
        assert _inside(spans, nk + "engine.sweep", nk + name) \
            == [rounds] * sweeps
    # the residuals hold no sweep
    assert _inside(spans, nk + "refine.residual",
                   nk + "engine.sweep") == [0] * res
    trace = next((tmp_path / "t").iterdir()).read_text()
    assert '"nk.refine.residual"' in trace


def test_round_numbers_are_the_ranges_arguments(problem):
    fac = problem.fac
    with torch.profiler.profile(record_shapes=True) as prof:
        fac.engine.solve(problem.B[:, 0])
    fwd = [e.kwinputs()["round"]
           for e in prof.profiler.kineto_results.events()
           if e.name() == profiling.PREFIX + "engine.fwd"]
    bwd = [e.kwinputs()["round"]
           for e in prof.profiler.kineto_results.events()
           if e.name() == profiling.PREFIX + "engine.bwd"]
    rounds = list(range(len(fac.engine.plans)))
    assert sorted(fwd) == rounds and sorted(bwd) == rounds


def test_a_refactor_records_stages_without_a_synchronize(problem,
                                                         monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a synchronize under an inactive timer")
    monkeypatch.setattr(profiling.StageTimer, "_sync", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    fac = problem.fac
    fac._device_refiner()
    assert not profiling.STAGES.active
    # the process's timer keeps an earlier recording's records (another
    # test module's, in this process): an inactive one adds none
    calls = dict(profiling.STAGES.calls)
    with torch.profiler.profile() as prof:
        fac.refactor(problem.matrix)
    count = Counter(n for _, _, n in _host_spans(prof))
    nk = profiling.PREFIX
    assert count[nk + "round"] == len(fac.engine.plans)
    assert count[nk + "stage.assemble"] == len(fac.engine.plans)
    assert count[nk + "stage.partial_factor"] >= 1
    for name in ("mf.to_scipy", "mf.equilibrate", "mf.rebind", "mf.factor"):
        assert count[nk + name] == 1
    assert dict(profiling.STAGES.calls) == calls


@pytest.mark.parametrize("what", ["solve", "refactor"])
def test_the_profiler_changes_no_bit(problem, what):
    fac = problem.fac

    def run():
        if what == "solve":
            return [fac.solve(problem.B)]
        fac.refactor(problem.matrix)
        return [t.clone() for f in fac.engine.factors for t in f]
    run()       # the refiner's memo settles on the first solve
    off = run()
    with torch.profiler.profile():
        on = run()
    again = run()
    assert len(on) == len(off) == len(again)
    for a, b, c in zip(off, on, again):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def _event(t0_us, t1_us, name, cuda=False, annotation=False, kind=True):
    """A stand-in for one raw kineto record; ``kind`` False leaves out
    ``activity_type``, as torch before 2.13 does."""
    act = ("gpu_user_annotation" if annotation and cuda
           else "user_annotation" if annotation else
           "kernel" if cuda else "cpu_op")
    dev = (torch.autograd.DeviceType.CUDA if cuda
           else torch.autograd.DeviceType.CPU)
    e = SimpleNamespace(
        start_ns=lambda: int(t0_us * 1e3),
        duration_ns=lambda: int((t1_us - t0_us) * 1e3),
        name=lambda: name, device_type=lambda: dev,
        is_user_annotation=lambda: annotation)
    if kind:
        e.activity_type = lambda: act
    return e


@pytest.mark.parametrize("kind", [True, False])
def test_timeline_arithmetic_by_hand(kind):
    """Host: bench.solve 0-100 us holding nk.mf.solve 5-95, which holds
    nk.refine.correct 10-40 (with nk.engine.sweep 12-38 and an aten op
    20-30 in it) and nk.refine.host_residual 45-80. Device: kernels
    14-18, 22-26, 26-30 (overlapping 28-29), a copy 36-44, and the
    user ranges' mirrors over all of them."""
    events = [
        _event(0, 100, "bench.solve", annotation=True, kind=kind),
        _event(5, 95, "nk.mf.solve", kind=kind),
        _event(10, 40, "nk.refine.correct", kind=kind),
        _event(12, 38, "nk.engine.sweep", kind=kind),
        _event(20, 30, "aten::bmm", kind=kind),
        _event(45, 80, "nk.refine.host_residual", kind=kind),
        _event(14, 18, "k1", cuda=True, kind=kind),
        _event(22, 26, "k2", cuda=True, kind=kind),
        _event(26, 30, "k3", cuda=True, kind=kind),
        _event(28, 29, "k4", cuda=True, kind=kind),
        _event(36, 44, "Memcpy DtoH", cuda=True, kind=kind),
        _event(14, 44, "bench.solve", cuda=True, annotation=True,
               kind=kind),
        _event(14, 30, "nk.engine.sweep", cuda=True, annotation=True,
               kind=kind),
    ]
    host, dev = profile.timeline(events)
    assert [n for _, _, n in dev] == ["k1", "k2", "k3", "k4", "Memcpy DtoH"]
    assert len(host) == 6
    w0, w1 = 0.0, 100e-6
    busy, gaps = profile.device_gaps(dev, w0, w1)
    assert busy == pytest.approx(20e-6)
    np.testing.assert_allclose(np.array(gaps) * 1e6, [
        (0, 14), (18, 22), (30, 36), (44, 100)], atol=1e-6)
    spans = profile.span_totals(host, w0, w1)
    assert set(spans) == {"nk.mf.solve", "nk.refine.correct",
                          "nk.engine.sweep", "nk.refine.host_residual"}
    assert spans["nk.refine.host_residual"] == pytest.approx([35e-6, 1])
    # 0-14: midpoint 7 in nk.mf.solve; 18-22: 20 in the sweep (the aten
    # op is no program span); 30-36: 33 in the sweep; 44-100: 72 in the
    # host residual
    under = profile.idle_under(host, gaps)
    assert under == pytest.approx({"nk.mf.solve": 14e-6,
                                   "nk.engine.sweep": 10e-6,
                                   "nk.refine.host_residual": 56e-6})
    assert profile.idle_under(host, [(96e-6, 100e-6)]) == pytest.approx(
        {profile.NO_SPAN: 4e-6})
    # a stretch is cut to its window
    assert profile.device_gaps(dev, 15e-6, 25e-6)[0] == pytest.approx(6e-6)
