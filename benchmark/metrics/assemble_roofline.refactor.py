"""The least time of the assemble stage's work (benchmark/roofline.py, from the
round plans' shapes) over its exclusive time in the refactor that the
stage timer recorded after the window, %."""

from benchmark import roofline


def read(run):
    if not run.card or run.stages is None:
        return None
    rounds = [r["round"] for r in run.stages["rounds"]
              if r["excl"].get("assemble", 0.0) > 0.0]
    ms = sum(r["excl"]["assemble"] for r in run.stages["rounds"]
             if r["round"] in rounds)
    if not rounds or ms <= 0.0:
        return None
    least, _ = roofline.stage_least_s("assemble", run.plans, rounds, run.nnz,
                                      run.dtype)
    return 100.0 * least / (ms / 1e3)
