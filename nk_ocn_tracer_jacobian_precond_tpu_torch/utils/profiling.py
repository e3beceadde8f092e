"""Profiling and observability.

The reference's only perf visibility was SuperLU's PStatPrint and an
external memory profiler (SURVEY.md §5). Here: cumulative per-phase
wall-clock stats collectable from any timed() block, and a context manager
around torch.profiler for full traces of the host and the card.

The port of the JAX package's ``utils/profiling.py``: ``PhaseStats`` and
``GLOBAL_STATS`` are copies; ``torch_trace`` takes the place of
``jax_trace``.
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
