"""The refiner's corrections per right-hand side (its ``cycles`` plus
``host_applies``), mean over the window's requests."""


def read(run):
    steps = [s for s in run.window() if "refiner" in s]
    if not steps:
        return None
    return sum(s["refiner"]["cycles"] + s["refiner"]["host_applies"]
               for s in steps) / sum(s["nrhs"] for s in steps)
