"""Solver facade: factor once, solve many right-hand sides.

Backends, as in the JAX package's ``solver/api.py``:

  * "scipy"        - host SuperLU (``ScipyFactorization``, with
                     ``iterative_refinement`` and ``residual_norm`` copied
                     from the reference's host code);
  * "multifrontal" - the port's multifrontal solver on a torch device, at
                     float64 or float32 factors ("auto" picks it).
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from ..io.matrixfile import SparseMatrix
from ..utils import dbg, timed


class Factorization(Protocol):
    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b; b is (n,) or (n, nrhs)."""
        ...


def iterative_refinement(A, solve_fn, b: np.ndarray, x: np.ndarray,
                         tol: float = 1e-13, max_iter: int = 5) -> np.ndarray:
    """Classic residual-driven refinement (the rebuild of SuperLU's
    pdgsrfs*, reference SuperLU_brief_tree.txt:20-24): r = b - A x in
    float64, correct x += A^{-1} r until the relative residual converges."""
    bnorm = np.linalg.norm(b, axis=0)
    bnorm = np.where(bnorm == 0.0, 1.0, bnorm)
    for it in range(max_iter):
        r = b - A @ x
        rel = np.linalg.norm(r, axis=0) / bnorm
        worst = float(np.max(rel))
        dbg(2, f"refinement iter {it}: max rel residual {worst:.3e}")
        if worst <= tol:
            break
        x = x + solve_fn(r)
    return x


class ScipyFactorization:
    """Host SuperLU bridge (scipy splu wraps sequential SuperLU)."""

    def __init__(self, matrix: SparseMatrix, refine_tol: float = 1e-13):
        from scipy.sparse.linalg import splu
        A = matrix.to_scipy().tocsc()
        with timed("scipy splu factor"):
            self.lu = splu(A)
        self.A = A
        self.refine_tol = refine_tol

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        x = self.lu.solve(b)
        return iterative_refinement(self.A, self.lu.solve, b, x,
                                    tol=self.refine_tol)


def residual_norm(matrix: SparseMatrix, x: np.ndarray, b: np.ndarray) -> float:
    """Relative residual ||Ax - b||_2 / ||b||_2 in float64."""
    A = matrix.to_scipy()
    r = A @ x - b
    denom = np.linalg.norm(b)
    return float(np.linalg.norm(r) / (denom if denom else 1.0))


def factor(matrix: SparseMatrix, backend: str = "auto",
           device: str | torch.device = "cuda", precision="f64", **kwargs):
    """Factor ``matrix`` with ``backend``; the multifrontal backend runs on
    ``device`` with ``precision`` factors ("f64", "f32" or "auto") and
    takes MultifrontalFactorization's other keyword arguments."""
    if backend == "auto":
        backend = "multifrontal"
    if backend == "scipy":
        return ScipyFactorization(matrix)
    if backend == "multifrontal":
        from .mf import MultifrontalFactorization
        return MultifrontalFactorization(matrix, device=device,
                                         precision=precision, **kwargs)
    raise ValueError(f"unknown solver backend: {backend}")
