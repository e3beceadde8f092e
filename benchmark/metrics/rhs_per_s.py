"""Right-hand sides solved in the window over the window's seconds."""


def read(run):
    steps = run.window()
    if not steps:
        return None
    return sum(s["nrhs"] for s in steps) / run.window_s
