"""The route of the engine's solve sweep (mf_torch.TorchMultifrontal.
solve_workspace) on the CPU, on the 20x16x6 fixture of
tests/test_mf_jax.py.

A CPU engine sweeps eagerly, always. The graph route is driven here by a
stand-in for the CUDA graph (``Replayed``: capturing runs the body once on
the static workspace, as capture walks the host code, and every replay
runs it again) on an engine that takes itself for a CUDA one. The route's
copy-in / copy-out gives the eager sweep's bits; each width gets a graph
of its own; new factors drop every graph; mesh, offload and hi-round
engines stay eager. The on-card tests are in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nk_ocn_tracer_jacobian_precond_tpu_torch.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
    read_matrix_file)
from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (AssemblyOptions,
                                                           PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel.mesh import make_mesh
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver import mf_torch
from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu_torch.testdata import make_circ_file
from nk_ocn_tracer_jacobian_precond_tpu_torch.utils import profiling

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The fixture's matrix, factored once on the CPU (the facade's
    equilibrated matrix and symbolic plan), and its right-hand sides."""
    d = tmp_path_factory.mktemp("sweep_graph")
    circ, mat = str(d / "circ.nc"), str(d / "m.nc")
    make_circ_file(circ, imt=20, jmt=16, km=6, seed=33)
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    run_gen_a(mat, opts=AssemblyOptions(circ_fname=circ,
                                        hmix_type="isop_file",
                                        vmix_type="file", per_tracer=[pt]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    fac = MultifrontalFactorization(matrix, maps=maps, device="cpu")
    B = np.random.default_rng(17).standard_normal((matrix.flat_len, 4))
    return fac, B


class Replayed:
    """Stands in for a captured CUDA graph: capturing runs ``body`` once
    (capture walks the host code; here it also computes, on the static
    workspace, which the route then overwrites), and each ``replay`` runs
    it again with every span of the engine off, as a replay runs no host
    code. ``made`` counts the captures."""

    made = 0

    def __init__(self, body):
        type(self).made += 1
        self.body = body
        body()

    def replay(self):
        real = mf_torch.span
        mf_torch.span = lambda name, **args: profiling._NO_SCOPE
        try:
            self.body()
        finally:
            mf_torch.span = real


@pytest.fixture
def cuda_like(monkeypatch):
    """Engines take themselves for CUDA ones, with the stand-in graph."""
    monkeypatch.setattr(mf_torch, "_can_capture", lambda device: True)
    monkeypatch.setattr(Replayed, "made", 0)
    monkeypatch.setattr(mf_torch, "_capture", Replayed)


def _engine(fac, **kw):
    return mf_torch.TorchMultifrontal(fac.sym, fac._fac_matrix, CPU, **kw)


def _counts(eager, captured, replayed) -> dict:
    return dict(eager=eager, captured=captured, replayed=replayed)


def test_the_cpu_engine_sweeps_eagerly(problem):
    fac, B = problem
    eng = _engine(fac)
    assert not eng._graphable()
    first = eng.solve(B[:, 0])
    for _ in range(3):
        assert np.array_equal(eng.solve(B[:, 0]), first)
    eng.solve(B)
    assert eng.sweep_counts == _counts(5, 0, 0)
    assert eng._graphs == {}


@pytest.mark.parametrize("nrhs", [1, 4])
def test_the_graph_route_gives_the_eager_bits(problem, cuda_like, nrhs):
    fac, B = problem
    b = B[:, :nrhs]
    want = _engine(fac).solve(b)
    eng = _engine(fac)
    assert eng._graphable()
    got = [eng.solve(b) for _ in range(4)]
    assert all(np.array_equal(x, want) for x in got)
    # the first sweep is the warm-up, the second captures (and replays
    # once for its result), every later one replays
    assert eng.sweep_counts == _counts(1, 1, 2)
    assert Replayed.made == 1
    assert list(eng._graphs) == [(nrhs, torch.float64)]
    static, graph = eng._graphs[(nrhs, torch.float64)]
    assert static.shape == (eng.flat_len + 1, nrhs)
    assert isinstance(graph, Replayed)


def test_solve_workspace_solves_in_place_on_every_route(problem, cuda_like):
    fac, B = problem
    eng = _engine(fac)
    want = None
    for _ in range(3):
        W = torch.zeros((eng.flat_len + 1, 2), dtype=torch.float64)
        W[:eng.flat_len] = torch.from_numpy(B[:, :2])
        out = eng.solve_workspace(W)
        assert out is W
        # the static workspace is the graph's own, never the caller's
        assert all(s.data_ptr() != W.data_ptr()
                   for s, _ in eng._graphs.values())
        if want is None:
            want = W.clone()
        assert torch.equal(W, want)
    assert eng.sweep_counts == _counts(1, 1, 1)


def test_each_width_gets_a_graph_of_its_own(problem, cuda_like):
    fac, B = problem
    eng = _engine(fac)
    want = {1: _engine(fac).solve(B[:, :1]), 4: _engine(fac).solve(B)}
    for nrhs in (1, 4, 1, 4, 1, 4):
        assert np.array_equal(eng.solve(B[:, :nrhs]), want[nrhs])
    assert eng.sweep_counts == _counts(2, 2, 2)
    assert sorted(eng._graphs) == [(1, torch.float64), (4, torch.float64)]
    statics = [s for s, _ in eng._graphs.values()]
    assert statics[0].data_ptr() != statics[1].data_ptr()


@pytest.mark.parametrize("how", ["refactor", "set_factors"])
def test_new_factors_drop_every_graph(problem, cuda_like, how):
    fac, B = problem
    eng = _engine(fac)
    for nrhs in (1, 1, 4, 4):
        eng.solve(B[:, :nrhs])
    assert len(eng._graphs) == 2
    gen = eng.generation
    if how == "refactor":
        scaled = dataclasses.replace(fac._fac_matrix,
                                     nzval=2.0 * fac._fac_matrix.nzval)
        eng.refactor(scaled)
        want = _engine(fac).solve(B[:, 0]) / 2.0
    else:
        eng.set_factors(_engine(fac).factors)
        want = _engine(fac).solve(B[:, 0])
    assert eng._graphs == {} and eng._swept == set()
    assert eng.generation > gen
    # the first sweep on the new factors is eager again, the next captures
    before = dict(eng.sweep_counts)
    for _ in range(3):
        assert np.allclose(eng.solve(B[:, 0]), want, rtol=1e-12, atol=0)
    assert {k: eng.sweep_counts[k] - before[k] for k in before} \
        == _counts(1, 1, 1)


@pytest.mark.parametrize("kind", ["mesh", "hi_round", "offload"])
def test_mesh_hi_round_and_offload_engines_stay_eager(problem, cuda_like,
                                                     monkeypatch, tmp_path,
                                                     kind):
    fac, B = problem
    kw = {}
    if kind == "mesh":
        kw["mesh"] = make_mesh(1, ("front",))
    elif kind == "hi_round":
        monkeypatch.setattr(mf_torch, "HI_ROUND_MIN_P", 1)
        kw["prec"] = torch.float32
    else:
        kw["checkpoint_dir"] = str(tmp_path)
    eng = _engine(fac, **kw)
    assert not eng._graphable()
    first = eng.solve(B[:, :2])
    for _ in range(3):
        assert np.array_equal(eng.solve(B[:, :2]), first)
    assert eng.sweep_counts == _counts(4, 0, 0)
    assert eng._graphs == {} and Replayed.made == 0


def test_the_sweep_span_names_its_route(problem, cuda_like):
    """``nk.engine.sweep`` carries the route in its arguments; the round
    spans open only where the host walks the rounds (eager, capture)."""
    fac, B = problem
    eng = _engine(fac)
    with torch.profiler.profile(record_shapes=True) as prof:
        for _ in range(3):
            eng.solve(B[:, 0])
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns())
    nk = profiling.PREFIX
    routes = [e.kwinputs()["route"] for e in events
              if e.name() == nk + "engine.sweep"]
    assert routes == ["eager", "capture", "replay"]
    fwd = sum(1 for e in events if e.name() == nk + "engine.fwd")
    assert fwd == 2 * len(eng.plans)
