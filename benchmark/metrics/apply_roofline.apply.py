"""The least time of the traced requests' device work, as a share of the
device's busy time over them (``busy_s`` of the traced stretch), %. The
least time is their bytes over the card's memory bandwidth
(``benchmark/solve_roofline.py``, from the round plans and each request's
refiner ``stats``): a lower bound, since a Krylov cycle is counted as one
application whatever its depth. None without a trace."""

from benchmark import solve_roofline


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0.0:
        return None
    traced = [s for s in run.steps
              if s["phase"] == "traced" and "refiner" in s]
    if not traced:
        return None
    item = 8 if run.dtype == "float64" else 4
    nbytes = sum(solve_roofline.request_bytes(run.plans, run.nnz, item,
                                              s["refiner"], s["nrhs"])
                 for s in traced)
    return 100.0 * solve_roofline.least_s(nbytes) / run.trace["busy_s"]
