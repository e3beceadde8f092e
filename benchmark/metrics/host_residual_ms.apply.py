"""The card's idle time under the program's host residuals, ms per traced
request: the idle gaps of the traced stretch whose innermost host event
(``benchmark/trace.py``'s ``idle_gaps``) is the refiner's float64 or
long-double residual (``nk.refine.host_residual``, ``_ext``) or the
facade's check after it (``nk.mf.check``), summed over the stretch and
divided by its requests. None without a trace, or where the program opens
none of these spans."""

SPANS = ("nk.refine.host_residual", "nk.refine.host_residual_ext",
         "nk.mf.check")


def read(run):
    if run.trace is None:
        return None
    gaps = dict(run.trace["idle_gaps"])
    found = [gaps[name] for name in SPANS if name in gaps]
    traced = sum(1 for s in run.steps if s["phase"] == "traced")
    if not found or not traced:
        return None
    return 1e3 * sum(found) / traced
