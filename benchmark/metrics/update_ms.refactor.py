"""The value update of each Newton iteration (the program's re-assembly of
the step's values on the card and their copy to the host; the step's
``values_s``), median over the window, ms."""

import statistics


def read(run):
    ms = [1e3 * s["values_s"] for s in run.window() if "values_s" in s]
    return statistics.median(ms) if ms and run.card else None
