"""Least time of a factor stage's work on the card, from the round plans'
shapes: the yardstick of the ``*_roofline`` metrics.

A stage's work is counted from what it must read and write and compute,
not from the launches that do it today: each input byte read once, each
output byte written once, and the arithmetic the stage's function needs.
Its least time is the larger of bytes over the card's memory bandwidth and
operations over its peak rate at the factor dtype (NVIDIA's data sheet,
H100 SXM, dense); the share is that over the stage's measured time.

* ``panel``: the restricted-pivoting LU of each PANEL-column panel of a
  front's pivot block, R = P - off rows by T columns at offset off: the
  panel read and written, its row permutation written (int64), the
  front's pivot count read (int32); sum_k (R - k - 1) divisions and
  (R - k - 1)(T - k - 1) multiply-adds (two operations each).
* ``assemble``: the padded front written (B, N, N), and each CSR entry
  that lands in the round read once with its source and destination
  index (int64 each); no arithmetic.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes per second, and the
# highest FLOP/s of each dtype at its full precision (FP64 on the tensor
# cores, FP32 on the vector units: TF32 is a lower precision)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PANEL = 128
INDEX_BYTES = 8


def least_s(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / PEAK_FLOPS[dtype]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def panel_work(B: int, P: int, item: int) -> tuple[float, float]:
    """(bytes, flops) of the panels of one round of B fronts of pivot
    block P."""
    nbytes = flops = 0.0
    for off in range(0, P, PANEL):
        T = min(PANEL, P - off)
        R = P - off
        k = np.arange(T, dtype=np.float64)
        flops += B * float(np.sum((R - k - 1) * (1 + 2 * (T - k - 1))))
        nbytes += B * (2 * R * T * item + R * INDEX_BYTES + 4)
    return nbytes, flops


def assemble_work(plan, nnz: int, item: int) -> tuple[float, float]:
    """(bytes, flops) of the assembly of one round: its fronts written,
    its CSR entries read with their two indices."""
    entries = (int(np.count_nonzero(np.asarray(plan.a_csrc) < nnz))
               + int(np.count_nonzero(np.asarray(plan.a_src) < nnz)))
    nbytes = plan.B * plan.N * plan.N * item + entries * (item
                                                          + 2 * INDEX_BYTES)
    return float(nbytes), 0.0


def stage_least_s(stage: str, plans, rounds, nnz: int,
                  dtype: str) -> tuple[float, str]:
    """Least seconds of ``stage`` ("panel" or "assemble") over the rounds
    in ``rounds`` (indices into ``plans``), with what bounds it."""
    item = 8 if dtype == "float64" else 4
    nbytes = flops = 0.0
    for r in rounds:
        p = plans[r]
        b, f = (panel_work(p.B, p.P, item) if stage == "panel"
                else assemble_work(p, nnz, item))
        nbytes += b
        flops += f
    return least_s(nbytes, flops, dtype)
