"""Profiling and observability.

The reference's only perf visibility was SuperLU's PStatPrint and an
external memory profiler (SURVEY.md §5). Here: named spans of the
program's phases on torch.profiler's own timeline, a context manager
around torch.profiler for full traces of the host and the card, and the
synchronized stage timer of the engine's factor rounds.

The port of the JAX package's ``utils/profiling.py``: ``torch_trace``
takes the place of ``jax_trace``. ``StageTimer`` / ``STAGES`` take the
place of the JAX side's profiling scripts (``scripts/profile_factor.py``,
``scripts/profile_f64_rounds.py``), which re-walk the rounds by hand: the
engine enters the timer's scopes on its own round loop
(``solver/mf_torch.py``), and ``drivers/profile.py`` reads them.

``span(name)`` is the one span primitive: the facade, the refiner, the
engine's solve rounds, the stage timer's scopes and ``utils.logging.timed``
open it. While no torch profiler records it is one check and a shared
no-op context; while one records it is a host range ``nk.<name>`` in the
profiler's trace, on the clock of the card's kernels there, so each idle
stretch of the card can be put down to the program's phase on the host.
A span never synchronizes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "nk."


def span(name: str, **args):
    """The range ``nk.<name>`` while a torch profiler records (its
    ``args``, a round number say, go into the range's arguments, which the
    profiler keeps when it records shapes); otherwise the shared no-op.

    The range is an operator-scope record function, as torch's own
    operators are, not a user annotation (``torch.profiler.record_function``):
    the profiler mirrors each user annotation onto the device's timeline
    over the kernels launched inside it, where a reader of device busy time
    would count it as work."""
    if not torch.autograd._profiler_enabled():
        return _NO_SCOPE
    return _RecordFunctionFast(PREFIX + name, (), args)


class StageTimer:
    """Synchronized wall time of the factor's rounds and of the stages
    inside them (assembly, extend-add, panel, TRSM, ...), as the engine
    enters ``round(rnd, plan)`` and ``stage(name)`` scopes.

    Inactive by default: a scope is then only its ``span`` (no
    synchronize, no launch). Inside ``recording(device)``
    each scope synchronizes ``device`` on entry and exit, so a scope's time
    is the device work it enqueued plus its host work, and the timer
    records, per round (``rounds``: the plan's B, P, N and child-group
    count, inclusive ms, exclusive ms per stage, ``stages_ms`` the
    inclusive ms of its outermost stages) and in all (``excl``, ``calls``,
    the stages outside every round included), exclusive ms = a stage's
    time less that of the stages nested in it; ``wall_ms`` is the recording's whole time and ``top_ms`` that
    of its outermost stages, so ``wall_ms - top_ms`` is the walk outside
    every stage. Stages sit in module-level functions
    (``mf_torch.partial_factor``, ``pack_diag_inv``) as well as in the
    engine, so the process holds one timer, ``STAGES``: under a mesh each
    rank's process times its own rounds. Every scope opens a ``span``
    (``nk.round``, its round number in the range's arguments, and
    ``nk.stage.<name>``), active or not."""

    def __init__(self):
        self.active = False
        self._device: torch.device | None = None
        self._clear()

    def _clear(self) -> None:
        self.wall_ms = self.top_ms = 0.0
        self.rounds: list[dict] = []
        self.excl: dict = defaultdict(float)
        self.calls: dict = defaultdict(int)
        self._stack: list[list[float]] = []
        self._row: dict | None = None

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def recording(self, device: str | torch.device):
        """Activate the timer for the block, its records cleared first;
        yields the timer, whose records stay until the next recording."""
        if self.active:
            raise RuntimeError("the stage timer is recording already")
        self._clear()
        self._device = torch.device(device)
        self._sync()
        self.active = True
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._sync()
            self.wall_ms = (time.perf_counter() - t0) * 1e3
            self.active = False

    def round(self, rnd: int, plan):
        """The scope of round ``rnd`` (its ``plan`` gives B, P, N and the
        child groups)."""
        if not self.active:
            return span("round", round=rnd)
        return self._round(rnd, plan)

    def stage(self, name: str):
        """The scope of one stage (nested stages count apart)."""
        if not self.active:
            return span("stage." + name)
        return self._stage(name)

    @contextlib.contextmanager
    def _round(self, rnd: int, plan):
        row = dict(round=rnd, B=plan.B, P=plan.P, N=plan.N,
                   children=len(plan.child_groups), ms=0.0, stages_ms=0.0,
                   excl=defaultdict(float))
        self._sync()
        self._row = row
        t0 = time.perf_counter()
        try:
            with span("round", round=rnd):
                yield
        finally:
            self._sync()
            row["ms"] = (time.perf_counter() - t0) * 1e3
            self._row = None
            self.rounds.append(row)

    @contextlib.contextmanager
    def _stage(self, name: str):
        nested = [0.0]
        self._sync()
        self._stack.append(nested)
        t0 = time.perf_counter()
        try:
            with span("stage." + name):
                yield
        finally:
            self._sync()
            dt = (time.perf_counter() - t0) * 1e3
            self._stack.pop()
            ex = dt - nested[0]
            if self._stack:
                self._stack[-1][0] += dt
            else:
                self.top_ms += dt
                if self._row is not None:
                    self._row["stages_ms"] += dt
            self.excl[name] += ex
            self.calls[name] += 1
            if self._row is not None:
                self._row["excl"][name] += ex


_NO_SCOPE = contextlib.nullcontext()
# the process's stage timer (see StageTimer)
STAGES = StageTimer()


@contextlib.contextmanager
def torch_trace(trace_dir: str, device: str | torch.device = "cuda"):
    """Capture a torch.profiler trace of the block: host activity, plus the
    card's kernels and copies when ``device`` is a CUDA device (the
    caller's choice; nothing is probed). Yields the profiler (its
    ``key_averages()`` sums by operator and kernel) and writes a Chrome
    trace (chrome://tracing, Perfetto) into ``trace_dir`` at exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                       f"{os.getpid()}.json"))
