"""The benchmark's span around each step's refined solve (the solution is
on the host when it closes), median over the window, ms."""

import statistics


def read(run):
    ms = [1e3 * s["solve_s"] for s in run.window()]
    return statistics.median(ms) if ms and run.card else None
