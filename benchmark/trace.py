"""The device's busy time, its busiest operations and its idle gaps, read
from a torch.profiler trace of a stretch of the run.

The arithmetic is a copy of the port's ``drivers/profile.py::device_busy``
(the profiler's raw kineto records; building its Python event tree takes
minutes at gx3deep): busy time is the union of the intervals of every
operation on the device inside the traced stretch. Each idle gap between
them is put down to what the host was doing at its midpoint: the
innermost host event that covers it (a torch operator, a CUDA runtime
call, or one of the harness's own ranges).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

TOP = 10
# gaps shorter than this are launch latency, not host work
MIN_GAP_S = 20e-6
OWN = "bench."
STRETCH = OWN + "traced"


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block (host and, on a card, the device); yields a dict
    that holds the profiler once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    out = {}
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            yield out
    out["prof"] = prof


def summarize(prof) -> dict | None:
    """busy_s and window_s of the traced stretch, and the breakdown's
    ``device_ops`` and ``idle_gaps`` ([name, seconds], longest first).
    None when the trace holds no device operation."""
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the harness's ranges appear on the device's timeline too
            if not e.name().startswith(OWN):
                dev.append((t0, t1, e.name()))
        else:
            host.append((t0, t1, e.name()))
    win = [h for h in host if h[2] == STRETCH]
    if not dev or not win:
        return None
    w0, w1 = win[0][0], win[0][1]
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    per_op: dict = defaultdict(float)
    busy, end = 0.0, w0
    gaps = []
    for a, b, name in dev:
        per_op[name] += b - a
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    gaps = sorted((g for g in gaps if g[1] - g[0] >= MIN_GAP_S),
                  key=lambda g: g[0] - g[1])[:2000]
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    hd = he - hs
    by_host: dict = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        name = (host[cover[np.argmin(hd[cover])]][2] if len(cover)
                else "(no host event)")
        by_host[name] += b - a
    return dict(
        busy_s=busy, window_s=w1 - w0,
        device_ops=[[n[:160], s] for n, s in sorted(
            per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n[:160], s] for n, s in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:TOP]])
