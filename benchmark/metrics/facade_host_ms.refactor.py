"""The facade's host passes of a refactor (to_scipy, Ruiz equilibration,
the refiner's rebind; ``fac.timings``), median over the window, ms."""

import statistics


def read(run):
    ms = [1e3 * (s["split"]["to_scipy"] + s["split"]["equilibrate"]
                 + s["split"]["rebind"]) for s in run.window() if "split" in s]
    return statistics.median(ms) if ms else None
