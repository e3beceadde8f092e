"""The engine's numeric factor of a refactor (``fac.timings["factor"]``,
which ends in a synchronize), median over the window, ms."""

import statistics


def read(run):
    ms = [1e3 * s["split"]["factor"] for s in run.window() if "split" in s]
    return statistics.median(ms) if ms and run.card else None
