"""The 95th percentile of the latency of every request in the window
(a request: one solve call, from its call to its solution on the host)."""

import statistics


def read(run):
    lat = [s["latency_s"] for s in run.window()]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
