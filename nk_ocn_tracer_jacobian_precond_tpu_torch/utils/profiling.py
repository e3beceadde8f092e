"""Profiling and observability.

The reference's only perf visibility was SuperLU's PStatPrint and an
external memory profiler (SURVEY.md §5). Here: cumulative per-phase
wall-clock stats collectable from any timed() block, a context manager
around torch.profiler for full traces of the host and the card, and the
synchronized stage timer of the engine's factor rounds.

The port of the JAX package's ``utils/profiling.py``: ``PhaseStats`` and
``GLOBAL_STATS`` are copies; ``torch_trace`` takes the place of
``jax_trace``. ``StageTimer`` / ``STAGES`` take the place of the JAX
side's profiling scripts (``scripts/profile_factor.py``,
``scripts/profile_f64_rounds.py``), which re-walk the rounds by hand: the
engine enters the timer's scopes on its own round loop
(``solver/mf_torch.py``), and ``drivers/profile.py`` reads them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class PhaseStats:
    """Cumulative named-phase timing; thread-unsafe by design (host driver)."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> str:
        rows = sorted(self.seconds.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{name:32s} {sec:9.3f}s  x{self.calls[name]}"
                         for name, sec in rows)

    def to_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.seconds.items()})


GLOBAL_STATS = PhaseStats()


class StageTimer:
    """Synchronized wall time of the factor's rounds and of the stages
    inside them (assembly, extend-add, panel, TRSM, ...), as the engine
    enters ``round(rnd, plan)`` and ``stage(name)`` scopes.

    Inactive by default: a scope then costs one check and is a shared
    no-op context (no synchronize, no launch). Inside ``recording(device)``
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
    rank's process times its own rounds."""

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
            return _NO_SCOPE
        return self._round(rnd, plan)

    def stage(self, name: str):
        """The scope of one stage (nested stages count apart)."""
        if not self.active:
            return _NO_SCOPE
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
