"""Least bytes of a preconditioner application's device work, from the
round plans' shapes: the yardstick of ``apply_roofline.apply``.

Counted as ``benchmark/roofline.py`` counts a factor stage: each byte the
work must read read once, each byte it writes written once, whatever the
launches that do it read again.

* ``sweep``: one forward-plus-backward sweep of the solve rounds reads
  each round's packed pivot block K (B, P, P) once (its lower triangle
  forward, its upper backward), L21 (B, M, P) and U12 (B, P, M) once
  each and the row permutation (B, P, int64), and reads and writes the
  workspace (n + 1, nrhs) once, at the factor dtype. The padded fronts
  count: the batched products read them.
* ``residual``: the refiner's float64 product y = A x (kernel R1): the
  values and their int32 columns (nnz * 12 bytes), the row pointers
  ((n + 1) * 4), x read and y written (2 n nrhs * 8).

n is the plans' own count of eliminated cells (every cell is eliminated
once: the sum of ``p_arr``).
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import HBM_BYTES_PER_S

PERM_BYTES = 8


def state_len(plans) -> int:
    """The rows of the system: the cells the plans eliminate."""
    return int(sum(int(np.sum(p.p_arr)) for p in plans))


def sweep_bytes(plans, item: int, nrhs: int = 1) -> int:
    """Bytes of one forward-plus-backward sweep of ``nrhs`` right-hand
    sides over factors of ``item`` bytes an entry."""
    factors = sum(p.B * p.P * ((p.P + 2 * p.M) * item + PERM_BYTES)
                  for p in plans)
    return factors + 2 * (state_len(plans) + 1) * nrhs * item


def residual_bytes(nnz: int, n: int, nrhs: int = 1) -> int:
    """Bytes of one float64 product of the n-row matrix of ``nnz``
    entries with ``nrhs`` right-hand sides."""
    return nnz * 12 + (n + 1) * 4 + 2 * n * nrhs * 8


def request_bytes(plans, nnz: int, item: int, refiner: dict,
                  nrhs: int) -> int:
    """Least bytes of one refined request, from the refiner's ``stats``:
    a sweep for each plain correction and each Krylov cycle
    (``host_applies`` + ``cycles``), and one float64 residual after each
    plain correction. A lower bound: a cycle of depth m applies the
    preconditioner m times, and the residuals inside the Krylov cycles
    and their float32 products are not counted."""
    sweeps = refiner["host_applies"] + refiner["cycles"]
    return (sweeps * sweep_bytes(plans, item, nrhs)
            + refiner["host_applies"]
            * residual_bytes(nnz, state_len(plans), nrhs))


def least_s(nbytes: float) -> float:
    """Seconds to move ``nbytes`` at the card's memory bandwidth."""
    return nbytes / HBM_BYTES_PER_S
