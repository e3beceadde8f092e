"""Seconds per Newton iteration: the window's seconds over the iterations
it ran (each a refactor of new values and a solve of the step's
right-hand sides to the contract)."""


def read(run):
    steps = run.window()
    if not steps or not run.traffic["refactor_every_step"]:
        return None
    return run.window_s / len(steps)
