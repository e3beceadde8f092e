"""Multifrontal numeric phase — host (numpy/LAPACK) implementation.

Replays the symbolic plan front by front: assemble A entries + children's
Schur updates, partially factor the eliminated block with *restricted
pivoting* (row pivoting confined to the fully-summed rows — the same
compromise SuperLU_DIST's static-pivoting GESP makes, recovered by
iterative refinement), compute the Schur complement, pass it up. The JAX
implementation (mf_jax.py) executes the identical plan with batched dense
kernels; this version is its bit-level oracle and the CPU fallback.

A copy of the JAX package's host engine: the port's facade runs it with
``impl="numpy"`` (the torch engine, ``mf_torch.py``, is the default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.linalg import lu_factor, solve_triangular

from ..io.matrixfile import SparseMatrix
from .symbolic import SymbolicFactorization


@dataclass
class FrontFactors:
    lu11: np.ndarray      # (p, p) packed L\U of the pivot block
    piv: np.ndarray       # LAPACK pivot sequence for the pivot block
    L21: np.ndarray       # (b, p)
    U12: np.ndarray       # (p, b)
    cells: np.ndarray
    p: int


class NumpyMultifrontal:
    def __init__(self, sym: SymbolicFactorization, matrix: SparseMatrix):
        self.sym = sym
        self.order = [nid for rnd in sym.rounds for nid in rnd]
        self._factorize(matrix)

    def _factorize(self, matrix: SparseMatrix) -> None:
        A = matrix.to_scipy().tocsc()
        Ar = A.tocsr()
        sym = self.sym
        updates: dict[int, np.ndarray] = {}
        self.factors: dict[int, FrontFactors] = {}
        for nid in self.order:
            f = sym.fronts[nid]
            n, p = f.n, f.p
            F = np.zeros((n, n))
            # assemble original entries: columns of the owned block and the
            # owned rows of the border block (border x border belongs to
            # ancestors)
            F[:, :p] = Ar[f.cells][:, f.cells[:p]].toarray()
            if n > p:
                F[:p, p:] = Ar[f.cells[:p]][:, f.cells[p:]].toarray()
            # extend-add children's Schur complements
            for ch in f.children:
                cf = sym.fronts[ch]
                S = updates.pop(ch)
                m = cf.parent_map
                F[np.ix_(m, m)] += S
            F11 = F[:p, :p]
            lu11, piv = lu_factor(F11, check_finite=False)
            # apply the pivot-row permutation to F12
            perm = np.arange(p)
            for k, pk in enumerate(piv):
                perm[[k, pk]] = perm[[pk, k]]
            b = n - p
            if b:
                F12 = F[:p, p:][perm]
                U12 = solve_triangular(lu11, F12, lower=True,
                                       unit_diagonal=True, check_finite=False)
                L21 = solve_triangular(lu11.T, F[p:, :p].T, lower=True,
                                       check_finite=False).T
                S = F[p:, p:] - L21 @ U12
                updates[nid] = S
            else:
                U12 = np.zeros((p, 0))
                L21 = np.zeros((0, p))
            self.factors[nid] = FrontFactors(lu11=lu11, piv=piv, L21=L21,
                                             U12=U12, cells=f.cells, p=p)

    def solve(self, bvec: np.ndarray) -> np.ndarray:
        b = np.asarray(bvec, dtype=np.float64)
        single = b.ndim == 1
        w = (b[:, None] if single else b).copy()
        # forward sweep (children before parents)
        for nid in self.order:
            ff = self.factors[nid]
            p = ff.p
            rhs = w[ff.cells[:p]]
            perm = np.arange(p)
            for k, pk in enumerate(ff.piv):
                perm[[k, pk]] = perm[[pk, k]]
            y = solve_triangular(ff.lu11, rhs[perm], lower=True,
                                 unit_diagonal=True, check_finite=False)
            w[ff.cells[:p]] = y
            if ff.L21.shape[0]:
                w[ff.cells[p:]] -= ff.L21 @ y
        # backward sweep (parents before children)
        for nid in reversed(self.order):
            ff = self.factors[nid]
            p = ff.p
            rhs = w[ff.cells[:p]]
            if ff.U12.shape[1]:
                rhs = rhs - ff.U12 @ w[ff.cells[p:]]
            x = solve_triangular(ff.lu11, rhs, lower=False, check_finite=False)
            w[ff.cells[:p]] = x
        return w[:, 0] if single else w
