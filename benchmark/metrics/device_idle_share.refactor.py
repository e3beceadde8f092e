"""The share of the traced stretch in which no operation ran on the
device, %: 100 (1 - busy / window) from the profiler's trace."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
