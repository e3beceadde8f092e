"""The benchmark's inputs drawn from the seed, and the plain reference that
judges the program's solutions.

Every input is a function of (seed, stream, index): the Jacobian values
of step ``index`` are the configuration's values times 1 + scale * z,
z standard normal (multiplicative: zeros stay zeros, signs stay; see
``Values``), and its right-hand sides are standard normal. The harness draws them to hand to
the program; the reference draws them again here, with its own copy of
the configuration's CSR, and never reads what the program made of them.

A solution is judged by its relative residual ||b - A x|| / ||b|| per
column, accumulated in long double from the reference's own values:
float64's own rounding of A x reaches the 1e-10 contract on some
gx3deep right-hand sides. The columns are judged on a pool of threads
(numpy's loops release the interpreter), one per host core.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VALUES, OFFSET, RHS, RAW_APPLY = range(4)     # the seed's streams
SEED_MOD = 2 ** 64


def _rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % SEED_MOD, stream, index])


class Values:
    """The Jacobian values of each step of a seed: nzval0 (1 + scale z),
    z a window of nnz entries, at an offset drawn for the step, of one
    pool of 2 nnz standard normals drawn for the seed (a step then costs
    one pass over the values, not nnz fresh draws)."""

    def __init__(self, nzval0: np.ndarray, seed: int, scale: float):
        self.nzval0 = np.asarray(nzval0, dtype=np.float64)
        self.nnz = len(self.nzval0)
        self.seed = seed
        self.scaled = self.nzval0 * scale
        self.pool = _rng(seed, VALUES).standard_normal(2 * self.nnz,
                                                       dtype=np.float32)

    def __call__(self, index: int) -> np.ndarray:
        off = int(_rng(seed=self.seed, stream=OFFSET, index=index)
                  .integers(0, self.nnz))
        return self.nzval0 + self.scaled * self.pool[off:off + self.nnz]


def step_rhs(n: int, seed: int, index: int, nrhs: int) -> np.ndarray:
    """The (n, nrhs) right-hand sides of step ``index``."""
    return _rng(seed, RHS, index).standard_normal((n, nrhs))


def raw_apply_rhs(n: int, seed: int) -> np.ndarray:
    """The right-hand side of the unrefined apply of the last factors."""
    return _rng(seed, RAW_APPLY).standard_normal((n, 1))


class Reference:
    """The configuration's CSR pattern and base values, held by the
    reference; ``residuals`` judges solutions against the values of a
    step, which ``values`` draws again from the seed."""

    def __init__(self, nzval0, colind, rowptr, seed: int, scale: float):
        self.colind = np.array(colind, dtype=np.int64)
        rowptr = np.array(rowptr, dtype=np.int64)
        self.n = len(rowptr) - 1
        if (np.diff(rowptr) <= 0).any():
            raise ValueError("every row of the configuration has a diagonal")
        self.starts = rowptr[:-1]
        self.values = Values(np.array(nzval0, dtype=np.float64), seed, scale)

    def residuals(self, values: np.ndarray, Xs: list,
                  Bs: list) -> list[np.ndarray]:
        """Relative residual of each column of each X (n, k) in ``Xs``
        against the B of the same place in ``Bs``, all under one matrix of
        values, in long double; a column that is not finite reads inf."""
        ld = np.longdouble
        vals = values.astype(ld)
        Xs = [np.asarray(X, dtype=np.float64).reshape(self.n, -1)
              for X in Xs]
        Bs = [np.asarray(B, dtype=np.float64).reshape(self.n, -1)
              for B in Bs]

        def column(ij) -> float:
            i, j = ij
            x = Xs[i][:, j].astype(ld)
            if not np.isfinite(x).all():
                return np.inf
            b = Bs[i][:, j].astype(ld)
            r = b - np.add.reduceat(vals * x[self.colind], self.starts)
            bn = np.sqrt(np.sum(b * b))
            return float(np.sqrt(np.sum(r * r)) / (bn if bn > 0 else 1))

        cols = [(i, j) for i, X in enumerate(Xs) for j in range(X.shape[1])]
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            flat = iter(list(pool.map(column, cols)))
        return [np.array([next(flat) for _ in range(X.shape[1])])
                for X in Xs]
